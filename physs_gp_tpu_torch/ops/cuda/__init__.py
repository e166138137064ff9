"""Hand-written CUDA kernels and their wrappers; the launch counts of all.

Importing this package registers the eight kernels as the custom ops
`torch.ops.physs_gp.{bmm, gj_solve, gj_solve_logdet, lq, chol, chol_gram,
fused_filter, fused_smooth}` (`build.KernelOp`), which exported programs
(`utils/serving`) call.
"""
from . import batched_chol, batched_linalg, batched_qr, fused_combine  # noqa: F401
from .build import launch_counts, reset_launch_counts, route_counts  # noqa: F401
