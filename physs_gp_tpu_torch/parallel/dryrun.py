"""Multi-rank dryrun of the time-sharded path (PyTorch counterpart of
`__graft_entry__.dryrun_multichip`, part 1).

    python3 -m physs_gp_tpu_torch.parallel.dryrun [N] [--device cpu]

`dryrun_multichip(n, device="cuda")` starts n ranks (`parallel/ranks.py`:
spawned processes, one process group, a time limit) on a ("t",) mesh and
runs, at tiny shapes, each check against the same rank's single-device run:

- the value and gradient of `f.lml + s.ms[-1].sum()` of a Matérn-3/2 model
  with respect to the kernel's raw hyperparameters;
- a Poisson `CVIGP.step_with_elbo` through the mesh (ELBO and sites);
- three `natgrad_scan` steps;
- a config-5 step through the mesh;
- at n >= 4 (n even), the composite dp x t mode on a (2, n / 2) mesh: four
  series, value and gradient;
- part 2, data parallelism over independent models (`dp-vmap`): 2 n
  Poisson series of 32 steps over a ("dp",) mesh, each rank stacking its
  two (`models/stacked.py`) for one natural-gradient update and the ELBOs;
  the summed ELBO is all-reduced over "dp". Each rank's per-series ELBOs
  are held to the same series of one single-process stacked run of all
  2 n, and the sum to that run's sum.

Everything runs in float64; values and gradients must agree to rtol `RTOL`
on every rank. Each rank builds and holds its segment of the series: an
objective is the all-reduced sum of the ranks' shares, a gradient the sum
of theirs (`sharded.shared_params`), and the CVI checks hold the rank's
sites to the same rows of the single-device run's.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .ranks import make_mesh, start_ranks

__all__ = ["dryrun_multichip", "lml_value_and_grad", "composite_value_and_grad", "RTOL"]

RTOL = 1e-8
NOISE = 0.1


def _matern(dtype, device):
    from ..kernels.matern import Matern32

    return Matern32(lengthscale=1.0, variance=1.0, dtype=dtype, device=device)


def _objective(f, s, last: bool = True):
    """sum(f.lml) + sum(s.ms[..., -1, :]); the second term counts only on
    the rank that holds the series' last step (`last`), and enters every
    rank's share (times 0 elsewhere) so every rank's backward runs the
    smoother's exchanges."""
    return torch.sum(f.lml) + torch.sum(s.ms[..., -1, :]) * float(last)


def _shared(mesh, axes, kernel, share):
    """share(kernel) without a mesh; with one, the all-reduced sum of the
    ranks' shares, the kernel's gradient summed over the ranks."""
    if mesh is None:
        return share(kernel)
    from .sharded import all_reduce_sum, shared_params

    return all_reduce_sum(shared_params(kernel, share, mesh, axes), mesh, axes)


def _grads(value, kernel):
    return torch.stack([g.reshape(()) for g in torch.autograd.grad(value, list(kernel.parameters()))])


def lml_value_and_grad(mesh, t, y, *, sqrt=False, chunk_size=None):
    """(value, gradient) of `f.lml + s.ms[-1].sum()` of a Matérn-3/2 model
    with noise NOISE over t [T], y [T, 1], with respect to the kernel's raw
    (lengthscale, variance): through the mesh's "t" dimension (each rank on
    its segment), or the single-device parallel pass when `mesh` is None."""
    from ..ops.lgssm import build_lgssm
    from ..ops.runner import run_filter_smoother
    from .sharded import segment

    T = t.shape[0]
    kernel = _matern(t.dtype, t.device)
    seg = None if mesh is None else segment(T, mesh, "t", chunk_size)
    R = (NOISE * torch.eye(1, dtype=t.dtype, device=t.device)).expand(T, 1, 1)

    def share(k):
        f, s = run_filter_smoother(build_lgssm(k, t, seg), R, y, parallel=True, sqrt=sqrt,
                                   chunk_size=chunk_size, mesh=mesh, T=T)
        return _objective(f, s, seg is None or seg.holds_last)

    value = _shared(mesh, "t", kernel, share)
    return value.detach(), _grads(value, kernel)


def composite_value_and_grad(mesh, t, y, *, sqrt=False):
    """(value, gradient) of `sum(f.lml) + sum(s.ms[:, -1])` over B series
    (t [B, T], y [B, T, 1]) sharing one Matérn-3/2 kernel: the composite
    dp x t pass over the mesh's ("dp", "t") dimensions (each rank on its
    block of the series along "dp" and their segments along "t"), or the
    series one after another on one device when `mesh` is None."""
    from ..ops.lgssm import build_lgssm
    from ..ops.matrix import safe_cholesky_rel
    from ..ops.runner import run_filter_smoother
    from .sharded import axis_size, segment, sharded_filter_smoother, sharded_sqrt_filter_smoother

    kernel = _matern(t.dtype, t.device)
    B, T = t.shape
    R = (NOISE * torch.eye(1, dtype=t.dtype, device=t.device)).expand(B, T, 1, 1)
    if mesh is None:
        value = sum(_objective(*run_filter_smoother(build_lgssm(kernel, t[b]), R[b], y[b],
                                                    parallel=True, sqrt=sqrt))
                    for b in range(B))
        return value.detach(), _grads(value, kernel)
    seg = segment(T, mesh, "t")
    Bl = B // axis_size(mesh, "dp")
    mine = slice(mesh.get_local_rank("dp") * Bl, (mesh.get_local_rank("dp") + 1) * Bl)
    R, y = seg.rows(R[mine], 1), seg.rows(y[mine], 1)

    def share(k):
        ssms = [build_lgssm(k, tb, seg) for tb in t[mine]]
        A, Q, m0, P0 = (torch.stack([getattr(s, n) for s in ssms]) for n in ("A", "Q", "m0", "P0"))
        if sqrt:
            f, s = sharded_sqrt_filter_smoother(
                A, safe_cholesky_rel(Q), ssms[0].H, safe_cholesky_rel(R), y, m0,
                safe_cholesky_rel(P0), mesh=mesh, axis="t", batch_axis="dp")
        else:
            f, s = sharded_filter_smoother(A, Q, ssms[0].H, R, y, m0, P0, mesh=mesh, axis="t",
                                           batch_axis="dp")
        return _objective(f, s, seg.holds_last)

    value = _shared(mesh, ("t", "dp"), kernel, share)
    return value.detach(), _grads(value, kernel)


def _data(n, dtype, device):
    """The JAX dryrun's data: T = max(8 n, 32) sorted times on [0, 10] and
    Poisson counts; four series of 8 steps per rank of the "t" dimension
    for the composite mode."""
    rng = np.random.default_rng(0)
    T = max(8 * n, 32)
    t = np.sort(rng.uniform(0, 10, T))
    y = rng.poisson(np.exp(np.sin(t))).astype(np.float64)[:, None]
    n_t = max(n // 2, 1)
    t2 = np.sort(rng.uniform(0, 10, (4, 8 * n_t)), axis=1)
    y2 = rng.normal(size=(4, 8 * n_t, 1))
    kw = dict(dtype=dtype, device=device)
    return [torch.as_tensor(x, **kw) for x in (t, y, t2, y2)]


def _series(n, dtype, device):
    """Part 2's data, as the JAX dryrun's: 2 n series of 32 sorted times on
    [0, 10] and Poisson counts, t [2 n, 32], y [2 n, 32, 1]."""
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(0, 10, (2 * n, 32)), axis=1)
    y = rng.poisson(np.exp(np.sin(t))).astype(np.float64)[..., None]
    return [torch.as_tensor(x, dtype=dtype, device=device) for x in (t, y)]


def _stacked_step(t, y, lr: float = 0.5):
    """The JAX dryrun's part 2 step on the series t [B, T], y [B, T, 1]: B
    Matérn-3/2 Poisson CVI models stacked, one natural-gradient update of
    all, then their ELBOs [B]."""
    from ..likelihoods.nongaussian import Poisson
    from ..models.cvi_gp import CVIGP
    from ..models.stacked import StackedCVIGP

    models = [CVIGP.init(t[b], y[b], _matern(t.dtype, t.device), Poisson(), parallel=True)
              for b in range(t.shape[0])]
    return StackedCVIGP(models).natural_gradient_update(lr).elbo()


def _dp_vmap(rank, n, dtype, device):
    """Part 2 on this rank: {check: (this rank's, the single-process
    stacked run's)} for its series' ELBOs and the all-reduced sum."""
    import torch.distributed as dist

    t, y = _series(n, dtype, device)
    mesh = make_mesh((n,), ("dp",), device)
    mine = slice(2 * rank, 2 * rank + 2)
    elbos = _stacked_step(t[mine], y[mine])
    total = torch.sum(elbos)
    dist.all_reduce(total, group=mesh.get_group("dp"))
    single = _stacked_step(t, y)
    return {"dp-vmap elbos": (elbos, single[mine]), "dp-vmap total": (total, torch.sum(single))}


def dryrun_rank(rank, n, device):
    """The dryrun's checks on one rank, float64; returns {check: (sharded,
    single)} as numpy arrays."""
    from ..likelihoods.nongaussian import Poisson
    from ..models.cvi_gp import CVIGP
    from ..trainers.scan import natgrad_scan
    from ..zoo.bench_configs import build_config5
    from .sharded import segment

    dtype = torch.float64
    t, y, t2, y2 = _data(n, dtype, device)
    mesh = make_mesh((n,), ("t",), device)
    seg = segment(t.shape[0], mesh, "t")
    out = {}

    def pair(name, fn):
        out[name] = tuple(np.asarray(torch.as_tensor(v).detach().cpu()) for v in
                          (fn(mesh), fn(None)))

    pair("lml value", lambda m: lml_value_and_grad(m, t, y)[0])
    pair("lml grad", lambda m: lml_value_and_grad(m, t, y)[1])

    def cvi(m, steps):
        """The ELBOs and the rank's rows of the sites."""
        model = CVIGP.init(t, y, _matern(dtype, device), Poisson(), parallel=True, mesh=m)
        if steps == 1:
            model, elbo = model.step_with_elbo(0.5)
        else:
            model, elbo = natgrad_scan(model, 0.5, n_steps=steps)
        Y, V = (seg.rows(x) for x in (model.sites.Y, model.sites.V))
        return torch.cat([elbo.reshape(-1), Y.reshape(-1), V.reshape(-1)])

    pair("cvi step", lambda m: cvi(m, 1))
    pair("natgrad_scan 3", lambda m: cvi(m, 3))

    def config5(m):
        model = build_config5(t.shape[0], None, dtype=dtype, device=device, mesh=m)
        model, elbos = natgrad_scan(model, 0.5, n_steps=1)
        return elbos

    pair("config5 step", config5)
    if n >= 4 and n % 2 == 0:
        mesh2 = make_mesh((2, n // 2), ("dp", "t"), device)
        for i, name in enumerate(("composite value", "composite grad")):
            out[name] = tuple(np.asarray(composite_value_and_grad(m, t2, y2)[i].cpu())
                              for m in (mesh2, None))
    for name, pair_ in _dp_vmap(rank, n, dtype, device).items():
        out[name] = tuple(np.asarray(v.detach().cpu()) for v in pair_)
    return out


def dryrun_multichip(n: int, device: str = "cuda", timeout: float = 600.0) -> dict:
    """Run the dryrun on n ranks; raise if a check is non-finite or a rank's
    sharded result differs from its single-device one beyond RTOL. Returns
    rank 0's {check: (sharded, single)}."""
    results = start_ranks(dryrun_rank, n, args=(device,), device=device, timeout=timeout).wait()
    for rank, res in enumerate(results):
        for name, (got, ref) in res.items():
            if not (np.all(np.isfinite(got)) and np.allclose(got, ref, rtol=RTOL, atol=0)):
                raise AssertionError(f"dryrun rank {rank} of {n}: {name} {got} != single-device {ref}")
    print(f"DRYRUN-OK: {n} ranks on {device} ({', '.join(results[0])}), every rank equal to its "
          f"single-device run (rtol {RTOL:g}); part 2 (dp-vmap: {2 * n} stacked series over a "
          f"('dp',) mesh) passed")
    return results[0]


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = args[args.index("--device") + 1] if "--device" in args else "cuda"
    count = int(args[0]) if args and args[0].isdigit() else 2
    dryrun_multichip(count, device=dev)
