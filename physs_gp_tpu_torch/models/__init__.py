"""The port's models; the names the JAX package's `models` exports, as far
as they are ported."""
from .ssgp import GaussianMoments, StateSpaceGP
from .batch_gp import BatchGP
from .svgp import SVGP
from .cvi_gp import CVIGP
from .stgp import SpatioTemporalGP
from .streaming import StreamingGP, StreamingCVI, StreamState, SegmentResult
from .ekf_gp import NonlinearSSGP
from .wrappers import LatentPredictor, MultiObjectiveModel
from .vecchia import VecchiaGP
from .gprn import GPRN
from .lvgp import LatentVariableGP

__all__ = ["GaussianMoments", "StateSpaceGP", "BatchGP", "SVGP", "CVIGP", "SpatioTemporalGP", "StreamingGP",
           "StreamingCVI", "StreamState", "SegmentResult", "NonlinearSSGP", "MultiObjectiveModel",
           "LatentPredictor", "VecchiaGP", "GPRN", "LatentVariableGP"]
