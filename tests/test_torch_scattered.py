"""PyTorch port: the scattered-sensor and sparse-site paths against the JAX
package.

`data/spatiotemporal` (the port's own numpy copy: `pad_with_nan_to_make_grid`,
`SpatioTemporalData`, `TemporallyGroupedData`, `spatial_minibatch_indices`),
`ScatteredSpatialHead` (a time-varying block H [T, Ng, d] and its [T, Ng]
correction), `StateObservation` mixing static and time-varying heads,
`sparse_st_gp` (lml and its gradient, the trainable Z among the raws) and
`scattered_st_gp` / `scattered_st_predict` in all four scans at a T that
is not a multiple of the chunk (the runner pads the time-varying H). The
same numpy inputs go through the JAX function (sequential, float64) and the
port (float64, CPU); lml, gradients and means agree to rtol 1e-9 and
variances to 1e-7, relative to each output's largest magnitude.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.data import spatiotemporal as jdata  # noqa: E402
from physs_gp_tpu.kernels.spatio_temporal import SpatioTemporalKernel as JSTKernel  # noqa: E402
from physs_gp_tpu.transforms import operators as jops  # noqa: E402
from physs_gp_tpu.zoo.spatio_temporal import scattered_st_predict as jscattered_predict  # noqa: E402
from physs_gp_tpu_torch.data import spatiotemporal as pdata  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.spatio_temporal import SpatioTemporalKernel  # noqa: E402
from physs_gp_tpu_torch.transforms import operators as pops  # noqa: E402
from physs_gp_tpu_torch.zoo.spatio_temporal import scattered_st_gp, scattered_st_predict  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import make_vector_field_golden as mg  # noqa: E402
import vector_field_outcome as vf  # noqa: E402

from experiments_torch import scattered_st as sc  # noqa: E402

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")
TOL, TOL_VAR = 1e-9, 1e-7


def rel(a, b):
    """max |a - b| / max |b| over the entries of b."""
    a, b = (x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _rows(seed=3, n_times=9, ds=2):
    """Moving sensors: 1-3 rows at random sites per time, shuffled, with one
    time observed twice at the same site (a duplicate grid cell)."""
    rng = np.random.default_rng(seed)
    rows = []
    for tk in np.sort(rng.uniform(0, 2, n_times)):
        for _ in range(rng.integers(1, 4)):
            rows.append([tk, *rng.uniform(-1, 1, ds), rng.normal()])
    A = np.array(rows)
    A = A[rng.permutation(A.shape[0])]
    return A[:, :1 + ds], A[:, 1 + ds]


# ---------------------------------------------------------------------------
# data/spatiotemporal
# ---------------------------------------------------------------------------


def test_grouped_data_matches_jax():
    """`TemporallyGroupedData` field for field, its `unsort` on numpy and on
    a tensor, `SpatioTemporalData` and `pad_with_nan_to_make_grid` on the
    same scattered rows, and the minibatch indices from one generator."""
    X, y = _rows()
    g, jg = pdata.TemporallyGroupedData.from_scattered(X, y), jdata.TemporallyGroupedData.from_scattered(X, y)
    for name in ("t", "X_st", "Y_st", "Y_flat", "_row_t", "_row_j", "X_raw", "Y_raw"):
        np.testing.assert_array_equal(getattr(g, name), getattr(jg, name), err_msg=name)
    assert (g.Nt, g.Ng, g.P) == (jg.Nt, jg.Ng, jg.P) and g.Ng == 3
    np.testing.assert_array_equal(g.unsort(g.Y_st)[:, 0], y)
    np.testing.assert_array_equal(g.unsort(torch.from_numpy(g.Y_flat)).numpy(), jg.unsort(jg.Y_flat))
    Xg = np.vstack([X, X[:2]])  # grid cells observed twice: later rows win
    yg = np.concatenate([y, [5.0, 6.0]])
    s, js = pdata.SpatioTemporalData.from_scattered(Xg, yg), jdata.SpatioTemporalData.from_scattered(Xg, yg)
    for name in ("t", "X_space", "Y", "Y_flat", "X"):
        np.testing.assert_array_equal(getattr(s, name), getattr(js, name), err_msg=name)
    np.testing.assert_array_equal(s.unsort(s.Y_flat), js.unsort(js.Y_flat))
    for a, b in zip(pdata.pad_with_nan_to_make_grid(X, y), jdata.pad_with_nan_to_make_grid(X, y)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        pdata.spatial_minibatch_indices(np.random.default_rng(7), 50, 8),
        jdata.spatial_minibatch_indices(np.random.default_rng(7), 50, 8))


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------


def _kernels(Z):
    from physs_gp_tpu.kernels import Matern32 as JM32
    from physs_gp_tpu.kernels.rbf import RBF as JRBF
    from physs_gp_tpu.utils.params import positive_param as jpp
    from physs_gp_tpu_torch.kernels.matern import Matern32
    from physs_gp_tpu_torch.kernels.rbf import RBF
    from physs_gp_tpu_torch.utils.params import positive_param

    jk = JSTKernel(k_time=JM32(lengthscale=0.9, variance=1.3),
                   k_space=JRBF(lengthscales=jpp(jnp.array([0.6, 0.8])), variance=jpp(1.1)),
                   Z=jnp.asarray(Z))
    pk = SpatioTemporalKernel(
        Matern32(lengthscale=0.9, variance=1.3, **F64),
        RBF(lengthscales=positive_param([0.6, 0.8], **F64), variance=positive_param(1.1, **F64)),
        torch.as_tensor(Z, **F64))
    return jk, pk


@pytest.mark.parametrize("t_order", [0, 1])
def test_scattered_head_matches_jax(t_order):
    """Rows [T, Ng, Ns·d] and the [T, Ng] correction at per-step points,
    one weight call on the flattened points; no correction gives zeros."""
    rng = np.random.default_rng(1)
    Z = rng.uniform(-1, 1, (5, 2))
    pts = rng.uniform(-1, 1, (6, 3, 2))
    jk, pk = _kernels(Z)
    jh = jops.ScatteredSpatialHead(points=jnp.asarray(pts), t_order=t_order)
    ph = pops.ScatteredSpatialHead(torch.as_tensor(pts), t_order=t_order)
    rows = ph.rows(pk)
    want_rows, want_corr = jax.jit(lambda h, k: (h.rows(k), h.var_correction(k)))(jh, jk)
    assert rows.shape == (6, 3, 10)
    assert rel(rows, want_rows) <= TOL
    assert rel(ph.var_correction(pk), want_corr) <= TOL
    ph.correction = False
    assert torch.equal(ph.var_correction(pk), torch.zeros(6, 3, **F64))


def test_state_observation_mixes_static_and_time_varying_heads():
    """A static off-site `SpatialHead` (corrected), a `ScatteredSpatialHead`
    without correction and a static on-site head: H [T, p, d] with the
    static blocks broadcast over T, and the [T, p] correction with zeros for
    the exact heads."""
    rng = np.random.default_rng(2)
    Z = rng.uniform(-1, 1, (4, 2))
    static = rng.uniform(-1, 1, (2, 2))
    pts = rng.uniform(-1, 1, (5, 3, 2))
    jk, pk = _kernels(Z)
    jobs = jops.StateObservation(heads=[
        jops.SpatialHead(points=jnp.asarray(static), correction=True),
        jops.ScatteredSpatialHead(points=jnp.asarray(pts), correction=False),
        jops.SpatialHead(points=jnp.asarray(Z)),
    ])
    pobs = pops.StateObservation([
        pops.SpatialHead(torch.as_tensor(static), correction=True),
        pops.ScatteredSpatialHead(torch.as_tensor(pts), correction=False),
        pops.SpatialHead(torch.as_tensor(Z)),
    ])
    H, corr = pobs.H(pk), pobs.var_correction(pk)
    assert H.shape == (5, 9, 8) and corr.shape == (5, 9)
    want_H, want_corr = jax.jit(lambda o, k: (o.H(k), o.var_correction(k)))(jobs, jk)
    assert rel(H, want_H) <= TOL and rel(corr, want_corr) <= TOL
    assert torch.all(corr[:, 2:] == 0)
    # every head exact: no correction at all
    pobs.heads[0].correction = False
    assert pobs.var_correction(pk) is None


# ---------------------------------------------------------------------------
# recipes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sparse_case():
    """The golden file's sparse configuration, raws moved by +0.05: the JAX
    lml and its gradient by raw, and the flat leaves."""
    t, Y, X_space, Z = vf.sparse_inputs()
    jm = mg.shift_raws(mg.jax_sparse(t, Y, X_space, Z))
    lml, grads = mg.lml_and_raw_grads(jm)
    return (t, Y, X_space, Z), mg.leaves(jm), float(lml), grads


@pytest.mark.parametrize("parallel", [False, True])
def test_sparse_st_gp_lml_and_z_gradient_match_jax(sparse_case, parallel):
    """`sparse_st_gp(train_z=True)`: Z is a Param whose `.kernel.Z.raw`
    loads from the JAX leaves; the lml and its gradient by every raw (Z, the
    kernels' hyperparameters, the tied noise) match `jax.grad`."""
    (t, Y, X_space, Z), leaves, lml, grads = sparse_case
    pm = vf.sparse_model(t, Y, X_space, Z, torch.float64, "cpu", parallel=parallel)
    assert ".kernel.Z.raw" in leaves and pm.kernel.Z.raw.requires_grad
    load_numpy_params(pm, leaves)
    val = pm.log_marginal_likelihood()
    val.backward()
    assert rel(val, lml) <= TOL
    named = dict(pm.named_parameters())
    assert len(named) == len(grads)
    for key, g in grads.items():
        assert rel(named[vf._jax_name(key)].grad, g) <= TOL, key


@pytest.fixture(scope="module")
def scattered_case():
    """Scattered rows at 38 times (not a multiple of the chunk 8), Z of 6
    sites off the data, held-out query rows at new and at observed times:
    the JAX model's lml, posterior at the training rows and prediction."""
    rng = np.random.default_rng(11)
    rows = []
    for tk in np.sort(rng.uniform(0, 4, 38)):
        for _ in range(rng.integers(1, 4)):
            s = rng.uniform(-1, 1, 2)
            rows.append([tk, s[0], s[1], sc.field(tk, s[None])[0] + 0.05 * rng.normal()])
    train = np.array(rows)
    Z = rng.uniform(-1, 1, (6, 2))
    test = np.vstack([
        np.column_stack([rng.uniform(0, 4, 4), rng.uniform(-1, 1, (4, 2))]),
        np.column_stack([train[rng.integers(0, train.shape[0], 3), 0], rng.uniform(-1, 1, (3, 2))]),
    ])
    jm, data = mg.jax_scattered(train, Z)
    lml, post = jax.jit(lambda m: (m.log_marginal_likelihood(), m.posterior()))(jm)
    pred = jscattered_predict(jm, data, test)
    want = {"lml": float(lml),
            "post_mean": data.unsort(np.asarray(post.mean))[:, 0],
            "post_var": data.unsort(np.asarray(post.var))[:, 0],
            "pred_mean": np.asarray(pred.mean)[:, 0], "pred_var": np.asarray(pred.var)[:, 0]}
    return train, test, Z, want


@pytest.mark.parametrize("parallel,sqrt", [(False, False), (True, False), (True, True), (False, True)],
                         ids=["seq-cov", "par-cov", "par-sqrt", "seq-sqrt"])
def test_scattered_st_gp_and_predict_match_jax(scattered_case, parallel, sqrt):
    """`scattered_st_gp` (lml, the posterior mapped back with `unsort`) and
    `scattered_st_predict` in every scan; the parallel ones at chunk 8 over
    38 times (padded to 40). The prediction shares the model's kernel and
    tied noise parameter."""
    train, test, Z, want = scattered_case
    pm, data = sc.build(train, Z, torch.float64, "cpu", parallel, sqrt, chunk_size=8)
    assert data.Nt == 38 and pm.observation.H(pm.kernel).shape == (38, data.Ng, 12)
    got = sc.outputs(pm, data, test)
    for key, w in want.items():
        assert rel(got[key], w) <= (TOL_VAR if key.endswith("var") else TOL), key
    assert got["pred_mean"].shape == (7,)


def test_scattered_st_predict_shares_the_trained_parameters():
    """The prediction model reads the model's own kernel and noise Param: a
    change to either moves the prediction; `scattered_st_gp` picks Z by
    k-means when asked for fewer sites than rows, and rejects P > 1."""
    X, y = _rows(seed=5, n_times=12)
    pm, data = scattered_st_gp(X, y, n_inducing=4, noise=0.05, device="cpu")
    assert pm.kernel.sites.shape == (4, 2)
    q = X[:2]
    with torch.no_grad():
        before = scattered_st_predict(pm, data, q).var
        pm.likelihood.variances[0].p.raw += 1.0
        after = scattered_st_predict(pm, data, q).var
    assert torch.all(after > before)
    with pytest.raises(ValueError, match="single-output"):
        scattered_st_gp(X, np.stack([y, y], 1), device="cpu")


# ---------------------------------------------------------------------------
# public names of the JAX package's kernels, heads and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["temporal_state_dim", "n_heads", "rbf", "with_value", "release"])
def test_public_names_match_jax(name):
    """`SpatioTemporalKernel.temporal_state_dim`, `StateObservation.n_heads`,
    `kernels.rbf.rbf`, `Param.with_value` / `release` (in place: the port's
    `Param` is a module, as `fix` is) give the JAX package's values."""
    from physs_gp_tpu.kernels.rbf import rbf as jrbf
    from physs_gp_tpu.utils.params import positive_param as jpp
    from physs_gp_tpu_torch.kernels.rbf import rbf
    from physs_gp_tpu_torch.utils.params import positive_param

    rng = np.random.default_rng(4)
    Z = rng.uniform(-1, 1, (3, 2))
    if name == "temporal_state_dim":
        jk, pk = _kernels(Z)
        assert pk.temporal_state_dim == jk.temporal_state_dim == 2
        assert pk.state_dim == jk.state_dim == 6
    elif name == "n_heads":
        pts = rng.uniform(-1, 1, (4, 2, 2))
        jobs = jops.StateObservation(heads=[jops.SpatialHead(points=jnp.asarray(Z)),
                                            jops.ScatteredSpatialHead(points=jnp.asarray(pts))])
        pobs = pops.StateObservation([pops.SpatialHead(torch.as_tensor(Z)),
                                      pops.ScatteredSpatialHead(torch.as_tensor(pts))])
        assert pobs.n_heads == jobs.n_heads == 2
    elif name == "rbf":
        X = rng.uniform(-1, 1, (5, 2))
        jK = jrbf(jnp.array([0.7, 1.3]), 0.9).K(jnp.asarray(X), jnp.asarray(Z))
        pK = rbf([0.7, 1.3], 0.9, **F64).K(torch.as_tensor(X), torch.as_tensor(Z))
        assert rel(pK, jK) <= TOL
    elif name == "with_value":
        jp = jpp(jnp.array([0.5, 1.5])).with_value(jnp.array([2.0, 0.25]))
        pp = positive_param([0.5, 1.5], **F64)
        assert pp.with_value([2.0, 0.25]) is pp
        assert rel(pp.raw, jp.raw) <= TOL and rel(pp.value, jp.value) <= TOL
    else:
        jp = jpp(0.7).fix().release()
        pp = positive_param(0.7, **F64).fix()
        assert pp.fixed and pp.release() is pp
        assert pp.fixed is jp.fixed is False and pp.raw.requires_grad
        assert rel(pp.value, jp.value) <= TOL
