"""Carry a JAX model's leaves into the PyTorch port.

`load_numpy_params(model, flat)` takes a dict from key-path string to numpy
array, with the key paths the JAX package's pytrees flatten to (for example
`.kernel.k_time.lengthscales.raw`, `.likelihood.variances[3].raw`,
`.kernel.Z`, `.t`, `.Y`, `.sites.Y`, `.sites.V`). The port's modules use the
same attribute names, so each path is walked attribute by attribute:
`.raw` leaves are copied into the `nn.Parameter`, other leaves replace the
buffer they name, in the model's device and dtype. A path that names a
Python number (a setting the JAX package keeps static, such as
`.likelihood.binsize`) takes the scalar's value, in the number's type.
Tied and derived leaves walk the same way: `.likelihood.variances[0].p.raw`
of a `SharedVariance` group, `...terms[1].coeff.base.raw` of a `NegParam`;
the physics path's leaves too: `.likelihood.heads[3].variance.raw` and
`.likelihood.residual.noise_var.raw` of a `CompositeLikelihood`, its
`.likelihood.residual_mask`, a `LinearOperatorHead`'s
`.observation.heads[1].coeffs[1].raw` (a Param) or `...coeffs[0]` (a
number), and static numbers such as `.likelihood.heads[1].nu` (`Probit`) or
`.likelihood.residual.n_mc`; the stacked and vector-field models' leaves
too: `.kernel.parts[1].k_time.lengthscales.raw` of a `StackedMarkov`, a
`StackedHead`'s `(coeff, head)` part as `...parts[1][0]` (a number) or
`...parts[1][0].raw` (a Param), a trainable `.kernel.Z.raw`, and a
`MixedValueHead`'s `.observation.heads[0].W.raw` or `...W.z.raw`
(`UnitLowerMixing`); the batch models' leaves too: `BatchGP` and `SVGP`
data (`.X`, `.Y`, `.Z`), q (`.q_mu.raw`, the packed `.q_sqrt.raw`), a
`DerivativeKernel`'s `.kernel.base.lengthscales.raw` and fixed `.kernel.W`,
a kernel sum's `.kernel.parts[1].base.variance.raw`, an `LMC`'s
`.kernel.W.raw` and `.kernel.latents[0].lengthscales.raw`, a
`PerOutputLikelihood`'s `.likelihood.liks[0].variance.raw` and static
`.likelihood.liks[1].nu`, and a mean's `.mean.c.raw`; the volatility
path's too: a `DynamicCovarianceGaussian`'s `.likelihood.variances[1].raw`
and `.likelihood.y`, and a `CorrelationMixing`'s `.kernel.W.z.raw` and
`.kernel.W.scales.raw` (`LMC.init_drd`); the Markov zoo's too: the parts of
nested sums and products (`.kernel.parts[1].parts[0].period.raw`,
`...lengthscales.raw`, `...variance.raw`; `+` and `*` flatten as the JAX
package's do, so the indices agree), the Wiener family's `.variance.raw`
and `.P0.raw`, a prior mean's `.mean.c.raw` (`ConstantMean`) or
`.mean.w.raw` / `.mean.b.raw` (`LinearMean`), an uncertain-input
likelihood's `.likelihood.input_var.raw`, and the misc kernels'
(`.kernel.alpha.raw`, `.kernel.means.raw` of a `SpectralMixture`,
`.kernel.layers[0][0].raw` of a `DeepKernel`); the last batch models'
too: `VecchiaGP`'s `.kernel.*`, `.likelihood.*` and `.mean.c.raw`,
`GPRN`'s `.q_mu.raw`, the packed `.q_sqrt.raw`, `.noise.raw`,
`.drd_scales.raw`, `.kernel_w.*` and `.kernel_g.*`, `LatentVariableGP`'s
`.base.kernel.*`, `.base.likelihood.*` and `.W.raw`. Static numbers
(`n_harmonics`, `q`, `hessian`) are constructor arguments.

`load_stacked_params(stacked, flat)` carries the leaves of a vmapped JAX
model (`jax.vmap` over `CVIGP.init`: every leaf with a leading B) into a
`models.stacked.StackedCVIGP`'s stacked state, by the same key paths.

`load_stream_state(arrays, dtype, device)` carries a JAX `StreamState`
(m, P, t_last, lml as numpy) into the port's.
"""
from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["load_numpy_params", "load_stacked_params", "load_stream_state"]

_STEP = re.compile(r"\.([A-Za-z_]\w*)|\[(\d+)\]")


def _parse(key: str):
    steps, pos = [], 0
    for m in _STEP.finditer(key):
        if m.start() != pos:
            break
        steps.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not steps:
        raise KeyError(f"unparsable key path {key!r}")
    return steps


def load_numpy_params(model, flat: dict) -> None:
    """Copy every leaf of `flat` into `model` (in place); unknown paths raise."""
    for key, value in flat.items():
        *parents, leaf = _parse(key)
        obj = model
        for step in parents:
            obj = obj[step] if isinstance(step, int) else getattr(obj, step)
        if isinstance(leaf, int):  # an entry of a list of numbers
            current = obj[leaf]
        elif hasattr(obj, leaf):
            current = getattr(obj, leaf)
        else:
            raise KeyError(f"{key!r} does not name a leaf of the model")
        if isinstance(current, (int, float)) and not isinstance(current, bool):
            if np.size(value) != 1:
                raise ValueError(f"{key!r}: a number takes a scalar, got shape {np.shape(value)}")
            number = type(current)(np.asarray(value).item())
            if isinstance(leaf, int):
                obj[leaf] = number
            else:
                setattr(obj, leaf, number)
            continue
        if not isinstance(current, torch.Tensor):
            raise KeyError(f"{key!r} names {type(current).__name__}, not a tensor or number")
        new = torch.as_tensor(np.array(value), dtype=current.dtype, device=current.device)
        if new.shape != current.shape:
            raise ValueError(f"{key!r}: shape {tuple(new.shape)} != {tuple(current.shape)}")
        if isinstance(current, torch.nn.Parameter):
            with torch.no_grad():
                current.copy_(new)
        else:
            setattr(obj, leaf, new)


def load_stacked_params(stacked, flat: dict) -> None:
    """Copy every leaf of `flat`, each [B, ...], into the stacked state of
    `stacked` (in place); a path that names no stacked tensor raises."""
    for key, value in flat.items():
        name = ".".join(str(step) for step in _parse(key))
        current = stacked.state.get(name)
        if current is None:
            raise KeyError(f"{key!r} does not name a stacked parameter or buffer")
        new = torch.as_tensor(np.array(value), dtype=current.dtype, device=current.device)
        if new.shape != current.shape:
            raise ValueError(f"{key!r}: shape {tuple(new.shape)} != {tuple(current.shape)}")
        stacked.state[name] = new


def load_stream_state(arrays, dtype=torch.float64, device="cuda"):
    """A `models.streaming.StreamState` from a mapping (or object) holding
    the numpy leaves m [d], P [d, d], t_last [] and lml [] of a JAX one."""
    from .models.streaming import StreamState

    def get(name):
        return arrays[name] if isinstance(arrays, dict) else getattr(arrays, name)

    return StreamState(*[
        torch.as_tensor(np.array(get(name)), dtype=dtype, device=device)
        for name in StreamState._fields
    ])
