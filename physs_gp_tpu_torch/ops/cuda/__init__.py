"""Hand-written CUDA kernels and their wrappers; the launch counts of all."""
from . import batched_chol, batched_linalg, batched_qr, fused_combine  # noqa: F401
from .build import launch_counts, reset_launch_counts, route_counts  # noqa: F401
