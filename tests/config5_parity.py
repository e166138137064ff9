"""Shared parts of the PyTorch port's config-5 parity tests
(`tests/test_torch_config5*.py`): the golden files, the JAX model's leaves
by key path, the port model loaded with them, 3 `natgrad_scan` steps at
lr 0.5 on the port, and the checks that hold a port run to a reference.

The slice, `build_config5(256, 64, float64)` on both sides: ELBOs agree to
rtol 1e-9, final sites and the posterior to rtol 1e-7 (measured: ~1e-15
and ~4e-13). The three JAX reference runs (the blocked-schedule golden
check, the square-root golden check, JAX's default associative scan) sit
in three test files, so that the test workers share them.
"""
import os

import jax
import numpy as np
import torch

from physs_gp_tpu_torch.interop import load_numpy_params
from physs_gp_tpu_torch.trainers.scan import natgrad_scan as tscan
from physs_gp_tpu_torch.zoo.bench_configs import build_config5 as tbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "config5_T256_golden.npz")
GOLDEN_SQRT = os.path.join(REPO, "tests", "data", "config5_sqrt_T256_golden.npz")
STEP0_ELBO = -199098.6309421814  # JAX, CPU, float64, both scan schedules
T, CHUNK = 256, 64


def _close(a, b, rtol, atol=0.0):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _jax_leaves(model):
    """The JAX model's parameter and data leaves by key path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(model)[0]:
        key = jax.tree_util.keystr(path)
        if key.endswith(".raw") or key in (".t", ".Y", ".kernel.Z", ".sites.Y", ".sites.V"):
            out[key] = np.asarray(leaf)
    return out


def _port_model(jmodel, sqrt=False):
    model = tbuild(T, CHUNK, dtype=torch.float64, sqrt=sqrt, device="cpu")
    load_numpy_params(model, _jax_leaves(jmodel))
    return model


def _port_run(jmodel, sqrt=False):
    model, elbos = tscan(_port_model(jmodel, sqrt), 0.5, n_steps=3)
    return model, elbos


def _check_against(model, elbos, ref):
    _close(elbos, ref["elbos"], 1e-9)
    _close(model.sites.Y, ref["site_Y"], 1e-7, 1e-12)
    _close(torch.diagonal(model.sites.V, dim1=-2, dim2=-1), ref["site_V_diag"], 1e-7)
    post = model.posterior()
    _close(post.mean, ref["post_mean"], 1e-7, 1e-9)
    _close(post.var, ref["post_var"], 1e-7)
