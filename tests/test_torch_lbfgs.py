"""PyTorch port: `trainers/extra` (`LBFGSTrainer`, `SwitchTrainer`,
`VB_NG_LBFGS`) against the JAX package.

The golden cases hold the port to `tests/data/dynamics_golden.npz`
(`scripts/port/make_dynamics_golden.py`, which keeps the JAX L-BFGS
compiles), float64, iterates at rtol 1e-8: 10 `LBFGSTrainer` iterations on
`tests/test_trainers_metrics.py`'s `_model()` (losses and raws),
`VB_NG_LBFGS` for 3 epochs on its Poisson CVIGP and 2 on config-5 at
T = 256. One live case runs a single JAX `LBFGSTrainer` step on a tiny
model beside the port's.

On the Poisson CVIGP the reference's L-BFGS memory records the
natural-gradient step's change of the CVI sites (an untrainable leaf) as a
parameter difference, and from its second step its direction moves the
sites too; the port's does not (`trainers/extra.py`). So the port is held
to the reference's losses up to that step, and over all 3 epochs to the
golden run of the same optax algorithm over the trainable leaves only. On
config-5 the reference's `VB_NG_LBFGS` cannot start (its optax state maps
every leaf, and config-5 has Python float leaves): the port is held to the
trainable-leaf run there.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import dynamics_outcome as do  # noqa: E402

from physs_gp_tpu_torch.trainers import (  # noqa: E402
    AdamTrainer,
    LBFGSTrainer,
    SwitchTrainer,
    VB_NG_LBFGS,
)

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def gold():
    return np.load(do.GOLDEN)


def _check(res):
    for key, (got, want, tol) in res.items():
        r = do.relerr(got, want)
        assert r <= tol, (key, r, tol)


@pytest.mark.parametrize("cfg", ["lbfgs", "vbp", "vbc5"])
def test_port_matches_lbfgs_golden(gold, cfg):
    _check(do.anchors(gold, "cpu", (cfg,))[cfg])


def test_reference_vb_ng_lbfgs_cannot_start_on_config5(gold):
    assert "has no attribute 'shape'" in str(gold["vbc5::reference_error"])


def test_reference_lbfgs_moves_the_sites_and_the_port_does_not(gold):
    """The golden run records the reference moving the sites in its second
    and third L-BFGS steps (none in the first, whose memory is empty); the
    port's L-BFGS steps leave the sites as the natural-gradient step set
    them."""
    moved = gold["vbp::sites_moved"]
    assert moved[0] == 0.0 and np.all(moved[1:] > 1e-3), moved
    model = do.poisson_model(device="cpu")
    tr = VB_NG_LBFGS(model, ng_lr=do.VB_NG_LR)
    for _ in range(do.VBP_EPOCHS):
        tr.ng.train(model, [tr.ng_lr])
        before = model.sites.Y.clone()
        tr.lbfgs.train(model, 1)
        assert torch.equal(model.sites.Y, before)


def test_single_lbfgs_step_matches_jax_live():
    """One `LBFGSTrainer` step of each package on a tiny `StateSpaceGP`
    (T = 12): the loss, the line search's step and the raws after it."""
    import jax.numpy as jnp

    from physs_gp_tpu.kernels import Matern32 as JMatern32
    from physs_gp_tpu.likelihoods import Gaussian as JGaussian
    from physs_gp_tpu.models import StateSpaceGP as JSS
    from physs_gp_tpu.trainers import LBFGSTrainer as JLBFGS
    from physs_gp_tpu.utils.params import positive_param as jpp
    from physs_gp_tpu_torch.kernels.matern import Matern32
    from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian
    from physs_gp_tpu_torch.models import StateSpaceGP
    from physs_gp_tpu_torch.utils.params import positive_param

    t, y = do.lbfgs_inputs(seed=4, T=12)
    jm = JSS(t=jnp.asarray(t), Y=jnp.asarray(y)[:, None], kernel=JMatern32(lengthscale=1.5, variance=0.7),
             likelihood=JGaussian(jpp(0.3)))
    jtr = JLBFGS(jm)
    jm, jl = jtr.train(jm, 1)
    m = StateSpaceGP(t=torch.as_tensor(t, **F64), Y=torch.as_tensor(y, **F64)[:, None],
                     kernel=Matern32(lengthscale=1.5, variance=0.7, **F64),
                     likelihood=Gaussian(positive_param(0.3, **F64)))
    tr = LBFGSTrainer(m)
    m, tl = tr.train(m, 1)
    assert abs(tl[0] - jl[0]) <= 1e-12 * abs(jl[0])
    assert abs(tr.learning_rate - float(jtr.opt_state[-1].learning_rate)) <= 1e-8
    pairs = [(m.kernel.lengthscales.raw, jm.kernel.lengthscales.raw),
             (m.kernel.variance.raw, jm.kernel.variance.raw),
             (m.likelihood.variance.raw, jm.likelihood.variance.raw)]
    for got, want in pairs:
        assert do.relerr(do.numpy(got), np.asarray(want)) <= 1e-8


def test_switch_trainer_alternates_its_trainers():
    """Two rounds of (2 Adam epochs, 1 L-BFGS iteration) equal the same
    trainers called in that order by hand."""
    def run(switch):
        model = do.lbfgs_model(device="cpu", T=30)
        adam, lbfgs = AdamTrainer(model, lr=0.05), LBFGSTrainer(model)
        if switch:
            return SwitchTrainer([adam, lbfgs], [2, 1]).train(model, 2)[1], model
        losses = []
        for _ in range(2):
            losses += adam.train(model, 2)[1] + lbfgs.train(model, 1)[1]
        return losses, model

    (la, ma), (lb, mb) = run(True), run(False)
    assert la == lb and len(la) == 6
    for (_, a), (_, b) in zip(ma.named_parameters(), mb.named_parameters()):
        assert torch.equal(a, b)


def test_lbfgs_takes_the_model_it_was_built_for():
    model = do.lbfgs_model(device="cpu")
    tr = LBFGSTrainer(model)
    with pytest.raises(ValueError):
        tr.train(do.lbfgs_model(device="cpu"), 1)
