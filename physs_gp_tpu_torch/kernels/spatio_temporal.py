"""Separable spatio-temporal Markov kernel k_t(t, t') k_s(s, s') (PyTorch).

Counterpart of `physs_gp_tpu/kernels/spatio_temporal.py`. Over fixed
spatial sites Z [Ns, ds] the state is site-major, x = [site_0 temporal
block, site_1 block, ...], and

    A(dt) = I_Ns ⊗ A_t(dt),  Q(dt) = Kzz ⊗ Q_t(dt),
    P_inf = Kzz ⊗ P_inf_t,   H = I_Ns ⊗ H_t.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from .base import Kernel, _as_2d
from .markov import noise_matrix, to_ss, transition_matrix
from ..ops.lgssm import LGSSM
from ..ops.matrix import default_jitter, kron, kron_lift, safe_cholesky, symmetrize

__all__ = ["SpatioTemporalKernel"]


class SpatioTemporalKernel(Kernel):
    """k_t (Markov) x k_s over the spatial sites Z: a fixed buffer, or a
    `Param` (trainable inducing sites, which optimisers move jointly with
    the hyperparameters)."""

    def __init__(self, k_time, k_space, Z):
        super().__init__()
        self.k_time = k_time
        self.k_space = k_space
        if isinstance(Z, nn.Module):
            self.Z = Z
        else:
            self.register_buffer("Z", torch.as_tensor(Z))

    @property
    def sites(self):
        return self.Z.value if isinstance(self.Z, nn.Module) else self.Z

    @property
    def n_sites(self) -> int:
        return self.sites.shape[0]

    @property
    def temporal_state_dim(self) -> int:
        return to_ss(self.k_time).state_dim

    @property
    def state_dim(self) -> int:
        return self.n_sites * self.temporal_state_dim

    def Kzz(self):
        """Spatial Gram with relative jitter eps * mean(diag K). The
        PHYSS_KZZ_JITTER environment variable overrides eps (default
        100 * default_jitter: 1e-4 in float32, 1e-10 in float64). This
        regularisation changes the prior, not just the rounding."""
        K = self.k_space.K(self.sites, self.sites)
        scale = torch.mean(torch.diagonal(K))
        ov = os.environ.get("PHYSS_KZZ_JITTER")
        eps = float(ov) if ov is not None else 100.0 * default_jitter(K.dtype)
        return K + eps * scale * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)

    def to_lgssm(self, t) -> LGSSM:
        """Kron-lifted discretised system over time points t [T]."""
        t = t.reshape(-1)
        ss_t = to_ss(self.k_time)
        dt = torch.cat([torch.zeros(1, dtype=t.dtype, device=t.device), torch.diff(t)])
        A_t = transition_matrix(self.k_time, dt)  # [T, d, d]
        Q_t = noise_matrix(self.k_time, dt)  # [T, d, d]
        Ns = self.n_sites
        eye_s = torch.eye(Ns, dtype=A_t.dtype, device=A_t.device)
        Ks = self.Kzz()
        A = kron_lift(eye_s, A_t)  # [T, Ns*d, Ns*d]
        Q = kron_lift(Ks, Q_t)
        Pinf = symmetrize(kron(Ks, ss_t.Pinf))
        H = kron(eye_s, ss_t.H)  # [Ns, Ns*d]
        D = Ns * ss_t.state_dim
        return LGSSM(A=A, Q=Q, H=H, m0=torch.zeros(D, dtype=A.dtype, device=A.device), P0=Pinf)

    def spatial_weights(self, s_new, s_op=None):
        """Conditional weights w [N*, Ns] with (L_s f)(s*) ≈ w @ f(Z):
        w = (L_s k_s)(s*, Z) Kzz^-1."""
        Ksz = self._op_cross(_as_2d(s_new), s_op)
        L = safe_cholesky(self.Kzz())
        return torch.cholesky_solve(Ksz.T, L).T

    def _op_cross(self, s_new, s_op=None):
        """(L_s k_s)(s*, Z) [N*, Ns], operator applied in the first argument."""
        if s_op is None:
            return self.k_space.K(s_new, self.sites)
        if hasattr(s_op, "kind") and hasattr(self.k_space, "K_op"):
            return self.k_space.K_op(s_new, self.sites, s_op.kind)
        # no closed form: the operator by nested autodiff, one (s*, z) pair
        # at a time
        k = self.k_space.k_scalar
        return torch.func.vmap(
            lambda s: torch.func.vmap(lambda z: s_op(k, s, z))(self.sites)
        )(s_new)

    def conditional_var_correction(self, s_new, s_op=None, t_order: int = 0):
        """Var(∂_t^o f) ((L L' k)(s, s) - (L k_sz) Kzz^-1 (L k_zs)): residual
        prior variance of the operator read at off-grid points s_new."""
        s_new = _as_2d(s_new)
        w = self.spatial_weights(s_new, s_op)
        Ksz = self._op_cross(s_new, s_op)
        if s_op is None:
            kss = self.k_space.K_diag(s_new)
        else:
            # apply the operator in both arguments of k at (s, s)
            k = self.k_space.k_scalar

            def op_both(s):
                def g(a, b):
                    return s_op(k, b, a)

                return s_op(g, s, s)

            kss = torch.func.vmap(op_both)(s_new)
        resid = torch.clamp(kss - torch.sum(w * Ksz, -1), min=0.0)
        if t_order == 0:
            kt0 = self.k_time.K_diag(torch.zeros(1, 1, dtype=s_new.dtype, device=s_new.device))[0]
        else:
            from ..transforms.operators import derivative_row

            r = derivative_row(self.k_time, t_order)
            kt0 = r @ to_ss(self.k_time).Pinf @ r
        return kt0 * resid
