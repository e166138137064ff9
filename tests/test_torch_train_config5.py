"""PyTorch port: config-5 hyperparameter training in covariance form against
the JAX package (T = 256, float64; the checks are `train_parity`'s), and
light training checks against it: `trainable_mask` selects the JAX mask's
leaves (20 on config-5, 2 on the temporal model), `lr_schedule`, the
metrics, and a checkpoint refusing another model."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu import metrics as jmetrics  # noqa: E402
from physs_gp_tpu import trainers as jtrainers  # noqa: E402
from physs_gp_tpu.likelihoods import Poisson as JPoisson  # noqa: E402
from physs_gp_tpu.utils.training import trainable_mask as jmask  # noqa: E402
from physs_gp_tpu.zoo import bench_configs as jzoo  # noqa: E402
from physs_gp_tpu_torch import trainers  # noqa: E402
from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson  # noqa: E402
from physs_gp_tpu_torch.metrics import metrics  # noqa: E402
from physs_gp_tpu_torch.utils import checkpoint  # noqa: E402
from physs_gp_tpu_torch.utils.training import trainable_mask, trainable_parameters  # noqa: E402
from physs_gp_tpu_torch.zoo import bench_configs as tzoo  # noqa: E402

import train_parity as tp  # noqa: E402

torch.set_num_threads(1)

FORMS = ["c5_cov"]
jax_runs = tp.reference_runs(FORMS)
blocked = tp.blocked
_rel, _key = tp.rel, tp.jax_key


@pytest.mark.parametrize("which,n", [("config5", 20), ("temporal", 2)])
def test_trainable_mask_matches_jax(which, n):
    jm = getattr(jzoo, f"build_{which}")(8, None, dtype=jnp.float64)
    jflat = {jax.tree_util.keystr(p): bool(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jmask(jm))[0]}
    tm = getattr(tzoo, f"build_{which}")(8, None, dtype=torch.float64, device="cpu")
    mask = trainable_mask(tm)
    assert sum(mask.values()) == n == sum(jflat.values())
    assert {_key(k) for k, v in mask.items() if v} == {k for k, v in jflat.items() if v}
    assert {_key(k) for k in mask} == {k for k in jflat if k.endswith(".raw")}
    assert len(trainable_parameters(tm)) == n


@pytest.mark.parametrize("kind", ["constant", "linear", "log"])
def test_lr_schedule_matches_jax(kind):
    assert trainers.lr_schedule(kind, 0.7, 9) == jtrainers.lr_schedule(kind, 0.7, 9)
    with pytest.raises(ValueError):
        trainers.lr_schedule("cosine", 0.7, 9)


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    y = rng.poisson(2.0, size=(30, 1)).astype(np.float64)
    y[[2, 11]] = np.nan
    mean, var = rng.normal(size=(30, 1)), rng.uniform(0.05, 1.5, size=(30, 1))
    tt = [torch.from_numpy(x) for x in (y, mean, var)]
    jj = [jnp.asarray(x) for x in (y, mean, var)]
    assert _rel(metrics.rmse(tt[0], tt[1]), jmetrics.rmse(jj[0], jj[1])) <= 1e-13
    assert _rel(metrics.gaussian_nlpd(*tt), jmetrics.gaussian_nlpd(*jj)) <= 1e-13
    assert _rel(metrics.nlpd_quadrature(Poisson(), *tt),
                jmetrics.nlpd_quadrature(JPoisson(), *jj)) <= 1e-12
    for level in (0.5, 0.95):
        for a, b in zip(metrics.confidence_interval(tt[1], tt[2], level),
                        jmetrics.confidence_interval(jj[1], jj[2], level)):
            assert _rel(a, b) <= 1e-13


def test_checkpoint_rejects_another_model(tmp_path):
    checkpoint.save_model(tmp_path / "c5", tzoo.build_config5(16, None, dtype=torch.float64, device="cpu"))
    with pytest.raises(ValueError):
        checkpoint.load_model(tmp_path / "c5", tzoo.build_temporal(16, None, dtype=torch.float64,
                                                                  device="cpu"))
    checkpoint.save_model(tmp_path / "t16", tzoo.build_temporal(16, None, dtype=torch.float64, device="cpu"))
    with pytest.raises(ValueError):
        checkpoint.load_model(tmp_path / "t16", tzoo.build_temporal(32, None, dtype=torch.float64,
                                                                   device="cpu"))


@pytest.mark.parametrize("form", FORMS)
def test_objective_gradient_matches_jax(jax_runs, blocked, form):
    tp.check_gradient(jax_runs[form], form)


@pytest.mark.parametrize("form", FORMS)
def test_vb_ng_adam_scan_matches_jax(jax_runs, blocked, form):
    tp.check_vb_ng_adam_scan(jax_runs[form], form)


@pytest.mark.parametrize("form", FORMS)
def test_vb_ng_adam_trainer_matches_jax(jax_runs, blocked, form):
    tp.check_vb_ng_adam_trainer(jax_runs[form], form)


@pytest.mark.parametrize("form", FORMS)
def test_jax_reproduces_train_golden(jax_runs, form):
    tp.check_golden(jax_runs[form], form)
