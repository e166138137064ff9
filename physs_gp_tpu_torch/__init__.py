"""physs_gp_tpu_torch: the PyTorch / CUDA port of physs_gp_tpu.

Mirrors the JAX package's layout and names (`ops/matrix.py` <->
`ops/matrix.py`, `ops/cuda/batched_linalg.py` <-> `ops/pallas/batched_linalg.py`,
...). The hand-written Hopper kernels live in `csrc/` and are built with
`nvcc` at first use. This package imports torch and never jax.
"""
