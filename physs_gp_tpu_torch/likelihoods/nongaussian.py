"""Expected log-likelihood dispatch (PyTorch counterpart of
`physs_gp_tpu/likelihoods/nongaussian.expected_log_lik`). The non-Gaussian
likelihoods themselves are not ported yet."""
from __future__ import annotations

__all__ = ["expected_log_lik"]


def expected_log_lik(lik, y, m, v):
    """Elementwise E_{f ~ N(m, v)}[log p(y | f)]; NaN y contribute 0."""
    return lik.expected_log_lik(y, m, v)
