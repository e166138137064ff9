"""The port's kernels; the names the JAX package's `kernels` exports."""
from .base import (
    Bias,
    Kernel,
    LinearKernel,
    OnDims,
    ProductKernel,
    StationaryKernel,
    SumKernel,
    WhiteNoise,
)
from .markov import MarkovKernel, StackedMarkov, StateSpace, to_ss, transition_matrix
from .matern import Matern, Matern12, Matern32, Matern52, Matern72
from .rbf import RBF
from .spatio_temporal import SpatioTemporalKernel
from .derivative import DerivativeKernel, grad_ops, second_order_ops
from .periodic import Periodic
from .wiener import IntegratedWiener, Wiener, WienerVelocity
from .misc import RQ, ArcCosine, DeepKernel, Gibbs, SpectralMixture
from .multi_output import LMC
from .aggregated import AggregatedKernel, uniform_box_nodes
