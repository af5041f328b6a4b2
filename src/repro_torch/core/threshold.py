"""Threshold determination for dynamic pruning (paper §4.2, Eqs. 7/8).

Counterpart of ``repro/core/threshold.py``.  Given a target pruning rate
``p`` and the empirical (mu, sigma) of a feature matrix, find ``T > 0`` such
that a fraction ``p`` of latent factors fall in ``(-T, T)`` under the fitted
normal:

    phi(x) - phi(-x - 2*mu/sigma) = p        (Eq. 8)
    T = sigma * x + mu                       (Eq. 7)

Eq. 8 is solved by a fixed 64-step float32 bisection on the host; the
statistics are reduced on the matrix's own device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class MatrixStats(NamedTuple):
    """Empirical normal fit of one feature matrix (0-dim float32 tensors)."""

    mu: torch.Tensor
    sigma: torch.Tensor


def measure_stats(matrix: torch.Tensor) -> MatrixStats:
    """Fit N(mu, sigma^2) to all latent factors of ``matrix`` (population std)."""
    m = matrix.float()
    return MatrixStats(mu=m.mean(), sigma=torch.std(m, correction=0))


def _pruned_fraction(x, mu, sigma):
    """LHS of Eq. 8: mass of N(0,1) in (-x - 2*mu/sigma, x)."""
    return torch.special.ndtr(x) - torch.special.ndtr(-x - 2.0 * mu / sigma)


def solve_x(mu, sigma, rate, num_iters: int = 64) -> torch.Tensor:
    """Solve Eq. 8 for ``x`` by bisection (float32, on the CPU).

    The bracket is ``[-mu/sigma, max(-2*mu/sigma, 0) + 16]``.  The reference
    (``repro/core/threshold.py``) stops at ``max(-mu/sigma, 0) + 16``, which
    does not bracket the root when mu is strongly negative against sigma
    (mu = -0.5, sigma = 0.02, rate = 0.5 returns x = 41 with zero mass): the
    interval ``(-x - 2*mu/sigma, x)`` is empty until ``x > -mu/sigma`` and
    needs up to ``-2*mu/sigma`` more before it holds the mass.  Where the
    reference does bracket (mu/sigma >= -10) both return the same root.
    """
    mu = torch.as_tensor(mu, dtype=torch.float32).detach().cpu()
    sigma = torch.as_tensor(sigma, dtype=torch.float32).detach().cpu()
    rate = torch.clamp(
        torch.as_tensor(rate, dtype=torch.float32).detach().cpu(), 0.0, 1.0 - 1e-6
    )
    lo = -mu / sigma  # T = 0: nothing pruned
    hi = torch.clamp(-2.0 * mu / sigma, min=0.0) + 16.0
    for _ in range(num_iters):
        mid = 0.5 * (lo + hi)
        too_low = _pruned_fraction(mid, mu, sigma) < rate
        lo = torch.where(too_low, mid, lo)
        hi = torch.where(too_low, hi, mid)
    return 0.5 * (lo + hi)


def threshold_for_rate(stats: MatrixStats, rate) -> torch.Tensor:
    """Eq. 7: ``T = sigma * x + mu``; exactly 0.0 when ``rate <= 0``.

    Serving treats ``T == 0`` as "pruning disabled", so the rate-0 case must
    be the exact value, not the bisection's float residue.  The result lies
    on the device of ``stats``.
    """
    device = stats.mu.device
    x = solve_x(stats.mu, stats.sigma, rate)
    t = stats.sigma.cpu() * x + stats.mu.cpu()
    rate_t = torch.as_tensor(rate, dtype=torch.float32).detach().cpu()
    t = torch.where(rate_t <= 0.0, torch.zeros_like(t), t)
    return torch.clamp(t, min=0.0).to(device)


def thresholds_from_matrices(
    p_matrix: torch.Tensor, q_matrix: torch.Tensor, rate
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-matrix thresholds (T_p, T_q) for one pruning rate."""
    t_p = threshold_for_rate(measure_stats(p_matrix), rate)
    t_q = threshold_for_rate(measure_stats(q_matrix), rate)
    return t_p, t_q


def empirical_pruned_fraction(matrix: torch.Tensor, threshold, *,
                              chunk_rows: int = 1 << 18) -> torch.Tensor:
    """Measured fraction of insignificant factors, which validates Eq. 8's fit.

    Counted exactly in int64 over blocks of ``chunk_rows`` rows (no
    full-size temporary: at 10M x 128 one would be 5 GB), then divided once:
    the float32 quotient of the exact count, as the reference's float32 mean
    gives it wherever its float32 sum is exact."""
    t = torch.as_tensor(threshold, dtype=torch.float32, device=matrix.device)
    if matrix.numel() == 0:
        return torch.tensor(float("nan"), dtype=torch.float32, device=matrix.device)
    rows = matrix.reshape(matrix.shape[0], -1) if matrix.dim() else matrix.reshape(1, 1)
    count = torch.zeros((), dtype=torch.int64, device=matrix.device)
    for lo in range(0, rows.shape[0], chunk_rows):
        count += (rows[lo:lo + chunk_rows].float().abs() < t).sum()
    return (count.double() / matrix.numel()).float()
