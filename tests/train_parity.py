"""Shared parts of the PyTorch port's training-parity tests
(`tests/test_torch_train*.py`): the reference runs of
`scripts/port/make_train_golden.py` as a module-scoped fixture per test
file, and the checks that hold the port to them.

Each parity file covers some of the golden file's forms, so that the JAX
reference runs (~40 s of compiles each) spread over the test workers.
The checks, on the CPU in float64, blocked scan schedule with 8 blocks:
after 2 `natgrad_scan` steps at lr 0.5, `get_objective()` and its gradient
with respect to every trainable raw (normwise rtol 1e-9); then 3
iterations of `vb_ng_adam_scan(adam_lr=0.05, ng_lr=0.5)` or of
`VB_NG_Adam`: ELBOs and raws at rtol 1e-9, sites and the posterior at
1e-7; and the JAX runs against `tests/data/train_T256_golden.npz`.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from physs_gp_tpu_torch import trainers
from physs_gp_tpu_torch.interop import load_numpy_params
from physs_gp_tpu_torch.utils.training import trainable_parameters
from physs_gp_tpu_torch.zoo import bench_configs as tzoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "train_T256_golden.npz")
_spec = importlib.util.spec_from_file_location(
    "make_train_golden", os.path.join(REPO, "scripts", "port", "make_train_golden.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)


def rel(a, b):
    """Normwise relative error max|a - b| / max|b| over the finite entries of b."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    ok = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), ok)
    return float(np.max(np.abs(a[ok] - b[ok])) / np.max(np.abs(b[ok])))


def jax_key(name: str) -> str:
    """A port parameter name as the JAX key path: `likelihood.variances.3.raw`
    -> `.likelihood.variances[3].raw`."""
    return "".join(f"[{p}]" if p.isdigit() else f".{p}" for p in name.split("."))


def jax_leaves(model):
    """The JAX model's parameter and data leaves by key path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(model)[0]:
        key = jax.tree_util.keystr(path)
        if key.endswith(".raw") or key in (".t", ".Y", ".kernel.Z", ".sites.Y", ".sites.V"):
            out[key] = np.asarray(leaf)
    return out


@pytest.fixture
def blocked(monkeypatch):
    """The port's blocked scan schedule with the reference's 8 blocks."""
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")


def reference_runs(forms):
    """A module-scoped fixture: {form: the reference run of
    `make_train_golden.py`}, on the blocked schedule, `_factor_psd` on its
    TPU branch."""

    @pytest.fixture(scope="module")
    def jax_runs():
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PHYSS_INNER_SCAN", "blocked")
            mp.setenv("PHYSS_SCAN_BLOCKS", "8")
            ref.use_tpu_factor_branch(mp.setattr)
            yield {form: ref.reference_run(form)[0] for form in forms}

    return jax_runs


def after_natgrad(form):
    """The port's model of `form`, its leaves loaded from the JAX model,
    after the reference's natural-gradient steps."""
    which, sqrt = ref.FORMS[form]
    model = getattr(tzoo, f"build_{which}")(ref.T, ref.CHUNK, dtype=torch.float64, sqrt=sqrt,
                                            device="cpu")
    load_numpy_params(model, jax_leaves(ref.jax_model(form)))
    model, _ = trainers.natgrad_scan(model, ref.NG_LR, n_steps=ref.NG_STEPS)
    return model


def check_fit(model, elbos, run, form):
    assert rel(elbos, run["elbos"]) <= 1e-9
    raws = {jax_key(n): p for n, p in model.named_parameters()}
    assert {k[4:] for k in run if k.startswith("raw:")} == set(raws)
    for name, p in raws.items():
        assert rel(p, run[f"raw:{name}"]) <= 1e-9, name
    assert rel(model.sites.Y, run["site_Y"]) <= 1e-7
    assert rel(torch.diagonal(model.sites.V, dim1=-2, dim2=-1), run["site_V_diag"]) <= 1e-7
    gold, post = np.load(GOLDEN), model.posterior()
    assert rel(post.mean, gold[f"{form}:post_mean"]) <= 1e-7
    assert rel(post.var, gold[f"{form}:post_var"]) <= 1e-7


def check_gradient(run, form):
    model = after_natgrad(form)
    obj = model.get_objective()
    grads = torch.autograd.grad(obj, trainable_parameters(model))
    assert rel(obj, run["objective"]) <= 1e-9
    names = [jax_key(n) for n, p in model.named_parameters() if p.requires_grad]
    assert {k[5:] for k in run if k.startswith("grad:")} == set(names)
    for name, g in zip(names, grads):
        assert torch.isfinite(g).all()
        assert rel(g, run[f"grad:{name}"]) <= 1e-9, name


def check_vb_ng_adam_scan(run, form):
    model, elbos = trainers.vb_ng_adam_scan(after_natgrad(form), ref.ITERS, adam_lr=ref.ADAM_LR,
                                            ng_lr=ref.NG_LR)
    check_fit(model, elbos, run, form)
    assert not any(p.grad_fn for p in (model.sites.Y, model.sites.V))


def check_vb_ng_adam_trainer(run, form):
    """`VB_NG_Adam` runs the same iterations as `vb_ng_adam_scan`; its
    losses are the negated ELBOs."""
    model = after_natgrad(form)
    seen = []
    model, losses = trainers.VB_NG_Adam(model, adam_lr=ref.ADAM_LR, ng_lr=ref.NG_LR).train(
        model, ref.ITERS, callback=lambda i, m, loss: seen.append((i, loss)))
    assert seen == list(enumerate(losses))
    check_fit(model, -torch.tensor(losses, dtype=torch.float64), run, form)


def check_golden(run, form):
    """The JAX run reproduces the golden file (its posterior is made by the
    golden script alone and checked through the port's)."""
    gold = np.load(GOLDEN)
    fields = {k.split(":", 1)[1] for k in gold.files if k.startswith(f"{form}:")}
    assert fields == set(run) | {"post_mean", "post_var"}
    for key, val in run.items():
        tol = 1e-12 if key in ("objective", "elbos") or key[:4] in ("grad", "raw:") else 1e-10
        assert rel(val, gold[f"{form}:{key}"]) <= tol, key
