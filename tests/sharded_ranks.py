"""Rank bodies of the time-sharding tests (`tests/test_torch_sharded.py`).

Imports the port only (no JAX): the spawned ranks import this module. Each
case takes a DeviceMesh and numpy inputs (of the whole series) and returns
numpy outputs: the rank's rows of the series' results, with "lo" and "hi",
the global rows they are; `run_cases` runs a list of cases on one rank of a
4-rank gloo CPU process group (`parallel/ranks.py`).
"""
import numpy as np
import torch

F64 = dict(dtype=torch.float64)


def _t(x):
    return torch.tensor(np.asarray(x), **F64)


def _np(x):
    return x.detach().cpu().numpy()


def _rows(seg):
    return {"lo": seg.lo, "hi": seg.hi}


def case_pass(mesh, arrays, sqrt, chunk):
    """One sharded filter + smoother pass on the rank's segment of given
    LGSSM arrays (square-root form: the factors are given): the series' lml
    (all-reduced) and the rank's rows of the moments, and the rows of every
    result and of the segment's inputs."""
    from physs_gp_tpu_torch.parallel.sharded import (all_reduce_sum, segment,
                                                     sharded_filter_smoother,
                                                     sharded_sqrt_filter_smoother)

    fn = sharded_sqrt_filter_smoother if sqrt else sharded_filter_smoother
    seg = segment(len(arrays["y"]), mesh, "t", chunk)
    args = [_t(arrays[k]) for k in ("A", "Q", "H", "R", "y", "m0", "P0")]
    args = [seg.rows(x) if k in "AQRy" or (k == "H" and x.dim() == 3) else x
            for k, x in zip("AQHRymP", args)]
    f, s = fn(*args, mesh=mesh, axis="t", chunk_size=chunk)
    results = [f.ms, f.Ps, f.lmls, s.ms, s.Ps, s.Gs] + ([s.Ls] if sqrt else [])
    return {"lml": _np(all_reduce_sum(f.lml, mesh)), "fms": _np(f.ms), "fPs": _np(f.Ps),
            "sms": _np(s.ms), "sPs": _np(s.Ps),
            "rows": [args[i].shape[0] for i in (0, 1, 3, 4)] + [x.shape[0] for x in results],
            **_rows(seg)}


def case_grad(mesh, t, y, log_ls, noise, sqrt):
    """d lml / d log-lengthscale of a Matérn-5/2 `StateSpaceGP` with the mesh
    (every rank), beside the model without it."""
    from physs_gp_tpu_torch.kernels.matern import Matern52
    from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian
    from physs_gp_tpu_torch.models import StateSpaceGP
    from physs_gp_tpu_torch.parallel.sharded import exchange_stats, reset_exchange_stats
    from physs_gp_tpu_torch.utils.params import positive_param

    out = {}
    reset_exchange_stats()
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
        if m is not None:
            out["exchange"] = exchange_stats()
    return out


def case_cvi(mesh, t, y, sqrt, steps=1):
    """A Poisson `CVIGP` with the mesh: one `step_with_elbo(0.5)`, or a
    `natgrad_scan` of `steps`: the ELBOs and the rank's sites; the rows of
    the sites, of the segment's LGSSM and of the surrogate pass's results;
    the exchanges over the steps."""
    from physs_gp_tpu_torch.kernels.matern import Matern32
    from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson
    from physs_gp_tpu_torch.models import CVIGP
    from physs_gp_tpu_torch.ops.lgssm import build_lgssm
    from physs_gp_tpu_torch.parallel.sharded import exchange_stats, reset_exchange_stats
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan

    model = CVIGP.init(_t(t), _t(y), Matern32(lengthscale=1.0, variance=1.0, **F64), Poisson(),
                       sqrt=sqrt, mesh=mesh)
    reset_exchange_stats()
    if steps == 1:
        model, elbo = model.step_with_elbo(0.5)
    else:
        model, elbo = natgrad_scan(model, 0.5, n_steps=steps)
    exchange = exchange_stats()
    seg = model._seg()
    ssm = build_lgssm(model.kernel, model.t, seg)
    with torch.no_grad():
        _, m, S = model._surrogate_pass()
    rows = [model.sites.Y.shape[0], model.sites.V.shape[0], ssm.A.shape[0], ssm.Q.shape[0],
            m.shape[0], S.shape[0]]
    return {"elbo": _np(elbo), "site_Y": _np(model.sites.Y), "site_V": _np(model.sites.V),
            "rows": rows, "exchange": exchange, **_rows(seg)}


def case_predict(mesh, t, y, t_new, eps_x, eps_y):
    """A Poisson `CVIGP` after one step, with the mesh and without: its
    `posterior()`, `predict_f(t_new)` and `sample_f_given` at t_new (the
    augmented grid's draws given), each gathered over the series."""
    from physs_gp_tpu_torch.kernels.matern import Matern32
    from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson
    from physs_gp_tpu_torch.models import CVIGP

    out = {}
    for tag, m in (("sharded", mesh), ("single", None)):
        model = CVIGP.init(_t(t), _t(y), Matern32(lengthscale=1.0, variance=1.0, **F64), Poisson(),
                           parallel=True, mesh=m)
        model.step_with_elbo(0.5)
        post, pred = model.posterior(), model.predict_f(_t(t_new))
        draws = model.sample_f_given(_t(eps_x), _t(eps_y), t_new=_t(t_new))
        out[tag] = {"post_mean": _np(post.mean), "post_var": _np(post.var),
                    "mean": _np(pred.mean), "var": _np(pred.var), "draws": _np(draws)}
    return out


def case_load(mesh, t, y, site_Y, site_V):
    """A Poisson `CVIGP.init(mesh=)` given the whole series' sites in the
    JAX package's layout (`interop.load_numpy_params`): its sites."""
    from physs_gp_tpu_torch.interop import load_numpy_params
    from physs_gp_tpu_torch.kernels.matern import Matern32
    from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson
    from physs_gp_tpu_torch.models import CVIGP

    model = CVIGP.init(_t(t), _t(y), Matern32(lengthscale=1.0, variance=1.0, **F64), Poisson(),
                       mesh=mesh)
    load_numpy_params(model, {".sites.Y": site_Y, ".sites.V": site_V})
    return {"site_Y": _np(model.sites.Y), "site_V": _np(model.sites.V),
            "rows": [model.sites.Y.shape[0], model.sites.V.shape[0]], **_rows(model._seg())}


def case_composite(mesh, arrays, sqrt, t2, y2):
    """The composite dp x t pass on the rank's block of the series (along
    "dp") and their segments (along "t") of given batched arrays: the
    series' lmls (all-reduced over "t") and the rank's rows of the smoothed
    means; and the value and kernel gradient of a composite objective
    against the series run one by one on one device."""
    from physs_gp_tpu_torch.parallel.dryrun import composite_value_and_grad
    from physs_gp_tpu_torch.parallel.sharded import (all_reduce_sum, segment,
                                                     sharded_filter_smoother,
                                                     sharded_sqrt_filter_smoother)

    fn = sharded_sqrt_filter_smoother if sqrt else sharded_filter_smoother
    seg = segment(arrays["y"].shape[1], mesh, "t")
    Bl = arrays["y"].shape[0] // 2
    b0 = mesh.get_local_rank("dp") * Bl
    args = [_t(arrays[k])[b0:b0 + Bl] if k != "H" else _t(arrays[k])
            for k in ("A", "Q", "H", "R", "y", "m0", "P0")]
    args = [seg.rows(x, 1) if k in "AQRy" else x for k, x in zip("AQHRymP", args)]
    f, s = fn(*args, mesh=mesh, axis="t", batch_axis="dp")
    value, grad = composite_value_and_grad(mesh, _t(t2), _t(y2), sqrt=sqrt)
    value1, grad1 = composite_value_and_grad(None, _t(t2), _t(y2), sqrt=sqrt)
    return {"lml": _np(all_reduce_sum(f.lml, mesh)), "sms": _np(s.ms), "b0": b0, "Bl": Bl,
            "value": _np(value), "grad": _np(grad), "value_single": _np(value1),
            "grad_single": _np(grad1), **_rows(seg)}


def case_matheron(mesh, t, R, y, eps_x, eps_y, sqrt, chunk):
    """Matheron state samples from given draws of the whole series: the
    rank's rows with the mesh, and all of them without."""
    from physs_gp_tpu_torch.kernels.matern import Matern52
    from physs_gp_tpu_torch.ops.lgssm import build_lgssm
    from physs_gp_tpu_torch.ops.sampling import matheron_state_samples_given
    from physs_gp_tpu_torch.parallel.sharded import segment

    T = len(t)
    ssm = build_lgssm(Matern52(lengthscale=0.7, variance=1.3, **F64), _t(t))
    args = (ssm, _t(R), _t(y), _t(eps_x), _t(eps_y))
    with torch.no_grad():
        return {**{tag: _np(matheron_state_samples_given(*args, sqrt=sqrt, chunk_size=chunk,
                                                         mesh=m, T=T))
                   for tag, m in (("sharded", mesh), ("single", None))},
                **_rows(segment(T, mesh, "t", chunk))}


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
