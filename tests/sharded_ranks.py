"""Rank bodies of the time-sharding tests (`tests/test_torch_sharded.py`).

Imports the port only (no JAX): the spawned ranks import this module. Each
case takes a DeviceMesh and numpy inputs and returns numpy outputs;
`run_cases` runs a list of cases on one rank of a 4-rank gloo CPU process
group (`parallel/ranks.py`).
"""
import numpy as np
import torch

F64 = dict(dtype=torch.float64)


def _t(x):
    return torch.tensor(np.asarray(x), **F64)


def _np(x):
    return x.detach().cpu().numpy()


def case_pass(mesh, arrays, sqrt, chunk):
    """One sharded filter + smoother pass on given LGSSM arrays (square-root
    form: the factors are given)."""
    from physs_gp_tpu_torch.parallel.sharded import (sharded_filter_smoother,
                                                     sharded_sqrt_filter_smoother)

    fn = sharded_sqrt_filter_smoother if sqrt else sharded_filter_smoother
    f, s = fn(*[_t(arrays[k]) for k in ("A", "Q", "H", "R", "y", "m0", "P0")], mesh=mesh,
              axis="t", chunk_size=chunk)
    return {"lml": _np(f.lml), "fms": _np(f.ms), "fPs": _np(f.Ps), "sms": _np(s.ms),
            "sPs": _np(s.Ps)}


def case_grad(mesh, t, y, log_ls, noise, sqrt):
    """d lml / d log-lengthscale of a Matérn-5/2 `StateSpaceGP` with the mesh
    (every rank), beside the model without it."""
    from physs_gp_tpu_torch.kernels.matern import Matern52
    from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian
    from physs_gp_tpu_torch.models import StateSpaceGP
    from physs_gp_tpu_torch.utils.params import positive_param

    out = {}
    for tag, m in (("sharded", mesh), ("single", None)):
        kernel = Matern52(lengthscale=float(np.exp(log_ls)), **F64)
        model = StateSpaceGP(t=_t(t), Y=_t(y)[:, None], kernel=kernel,
                             likelihood=Gaussian(positive_param(noise, **F64)), parallel=True,
                             sqrt=sqrt, mesh=m)
        raw = kernel.lengthscales.raw
        (g_raw,) = torch.autograd.grad(model.log_marginal_likelihood(), [raw])
        ls = kernel.lengthscales.value
        (dls,) = torch.autograd.grad(ls, [raw])
        out[tag] = float(g_raw / dls * ls)
    return out


def case_cvi(mesh, t, y, sqrt):
    """One Poisson `CVIGP.step_with_elbo(0.5)` with the mesh: ELBO and sites."""
    from physs_gp_tpu_torch.kernels.matern import Matern32
    from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson
    from physs_gp_tpu_torch.models import CVIGP

    model = CVIGP.init(_t(t), _t(y), Matern32(lengthscale=1.0, variance=1.0, **F64), Poisson(),
                       sqrt=sqrt, mesh=mesh)
    model, elbo = model.step_with_elbo(0.5)
    return {"elbo": float(elbo), "site_Y": _np(model.sites.Y), "site_V": _np(model.sites.V)}


def case_composite(mesh, arrays, sqrt, t2, y2):
    """The composite dp x t pass on given batched arrays, and the value and
    kernel gradient of a composite objective against the series run one by
    one on one device."""
    from physs_gp_tpu_torch.parallel.dryrun import composite_value_and_grad
    from physs_gp_tpu_torch.parallel.sharded import (sharded_filter_smoother,
                                                     sharded_sqrt_filter_smoother)

    fn = sharded_sqrt_filter_smoother if sqrt else sharded_filter_smoother
    f, s = fn(*[_t(arrays[k]) for k in ("A", "Q", "H", "R", "y", "m0", "P0")], mesh=mesh,
              axis="t", batch_axis="dp")
    value, grad = composite_value_and_grad(mesh, _t(t2), _t(y2), sqrt=sqrt)
    value1, grad1 = composite_value_and_grad(None, _t(t2), _t(y2), sqrt=sqrt)
    return {"lml": _np(f.lml), "sms": _np(s.ms), "value": _np(value), "grad": _np(grad),
            "value_single": _np(value1), "grad_single": _np(grad1)}


def case_matheron(mesh, t, R, y, eps_x, eps_y, sqrt, chunk):
    """Matheron state samples from given draws, with the mesh and without."""
    from physs_gp_tpu_torch.kernels.matern import Matern52
    from physs_gp_tpu_torch.ops.lgssm import build_lgssm
    from physs_gp_tpu_torch.ops.sampling import matheron_state_samples_given

    ssm = build_lgssm(Matern52(lengthscale=0.7, variance=1.3, **F64), _t(t))
    args = (ssm, _t(R), _t(y), _t(eps_x), _t(eps_y))
    with torch.no_grad():
        return {tag: _np(matheron_state_samples_given(*args, sqrt=sqrt, chunk_size=chunk, mesh=m))
                for tag, m in (("sharded", mesh), ("single", None))}


def case_dryrun(mesh, rank, n):
    """The dryrun's checks (`parallel/dryrun.py`) on this rank, float64."""
    from physs_gp_tpu_torch.parallel.dryrun import dryrun_rank

    return dryrun_rank(rank, n, "cpu")


def run_cases(rank, n, cases):
    """{name: output} of each (name, function name, mesh, keyword arguments)
    case on this rank of n = 4: mesh "t4" is the ("t",) mesh of the 4 ranks,
    "dp2 t2" the (2, 2) ("dp", "t") mesh, whose "t" dimension also serves
    the 2-rank cases."""
    from physs_gp_tpu_torch.parallel.ranks import make_mesh

    meshes = {"t4": make_mesh((n,), ("t",), "cpu"),
              "dp2 t2": make_mesh((2, n // 2), ("dp", "t"), "cpu")}
    out = {}
    for name, fn_name, mesh, kw in cases:
        if fn_name == "case_dryrun":
            kw = dict(kw, rank=rank, n=n)
        out[name] = globals()[fn_name](meshes[mesh], **kw)
    return out


def fail_on_rank(rank, n, bad):
    """Raise on rank `bad`; the others return their rank."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def hang_on_rank(rank, n, bad):
    """Rank `bad` never returns; the others return their rank."""
    import time

    while rank == bad:
        time.sleep(1.0)
    return rank
