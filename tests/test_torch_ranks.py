"""The port's ranks and thresholds (``repro_torch.core``) held against the
JAX reference (``repro.core``) on the same numpy inputs: exact integer ranks,
thresholds within 1e-6 relative where the reference's bisection brackets."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ranks as jranks
from repro.core import threshold as jthr
from repro.kernels import ref as jref
from repro_torch.core import ranks, threshold
from repro_torch.kernels import ref

THRESHOLDS = [0.0, 0.01, 0.05, 0.2, 10.0]


def _matrix(m, k, seed=0, mu=0.0, sigma=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(mu, sigma, (m, k)).astype(np.float32)
    x[0] = 0.0          # every factor insignificant: rank 0 unless T == 0
    x[1] = 5.0          # every factor significant: rank k
    x[2, -1] = 0.0      # only the last factor insignificant
    return x


@pytest.mark.parametrize("t", THRESHOLDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_effective_ranks_match_reference(t, dtype):
    x = _matrix(64, 24, seed=1)
    want = np.asarray(jranks.effective_ranks(jnp.asarray(x, dtype), t))
    got = ranks.effective_ranks(torch.tensor(x).to(getattr(torch, dtype)), t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_threshold_zero_gives_full_rank():
    x = _matrix(16, 12)
    assert torch.all(ranks.effective_ranks(torch.tensor(x), 0.0) == 12)


def test_effective_ranks_chunked_rows(monkeypatch):
    """Rows reduced in several chunks give the same ranks as one pass."""
    x = torch.tensor(_matrix(50, 10, seed=2))
    whole = ranks.effective_ranks(x, 0.05)
    monkeypatch.setattr(ranks, "_RANK_CHUNK_ROWS", 7)
    np.testing.assert_array_equal(ranks.effective_ranks(x, 0.05).numpy(), whole.numpy())


@pytest.mark.parametrize("t", [0.0, 0.05, 0.2])
def test_masks_and_pair_dot_match_reference(t):
    p, q = _matrix(40, 16, seed=3), _matrix(40, 16, seed=4)
    r = ranks.effective_ranks(torch.tensor(p), t)
    np.testing.assert_array_equal(
        ranks.rank_mask(r, 16).numpy(),
        np.asarray(jranks.rank_mask(jnp.asarray(r.numpy()), 16)),
    )
    np.testing.assert_array_equal(
        ranks.mask_rows(torch.tensor(p), t).numpy(),
        np.asarray(jranks.mask_rows(jnp.asarray(p), t)),
    )
    np.testing.assert_allclose(
        ranks.pruned_pair_dot(torch.tensor(p), torch.tensor(q), t, t).numpy(),
        np.asarray(jranks.pruned_pair_dot(jnp.asarray(p), jnp.asarray(q), t, t)),
        rtol=1e-6, atol=1e-7,
    )
    r_i = ranks.effective_ranks(torch.tensor(q), t)
    assert float(ranks.work_fraction(r, r_i, 16)) == pytest.approx(
        float(jranks.work_fraction(jnp.asarray(r.numpy()), jnp.asarray(r_i.numpy()), 16)),
        rel=1e-6,
    )
    np.testing.assert_allclose(
        ranks.sparsity_per_dim(torch.tensor(p), t).numpy(),
        np.asarray(jranks.sparsity_per_dim(jnp.asarray(p), t)),
        rtol=1e-6,
    )


@pytest.mark.parametrize("t", [0.0, 0.04, 0.1])
def test_pair_dot_is_algorithm_2(t):
    """The masked formulation equals the paper's scalar early-exit loop."""
    p, q = _matrix(20, 12, seed=5), _matrix(20, 12, seed=6)
    got = ranks.pruned_pair_dot(torch.tensor(p), torch.tensor(q), t, t).numpy()
    want = [ref.early_stop_dot_loop(p[b], q[b], t, t) for b in range(20)]
    assert want == [jref.early_stop_dot_loop(p[b], q[b], t, t) for b in range(20)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


FAMILIES = [  # (mu, sigma): centred, positive-mean (LibMF-like), mildly negative
    (0.0, 0.1), (0.05, 0.02), (-0.01, 0.05), (0.3, 0.1),
]


@pytest.mark.parametrize("mu,sigma", FAMILIES)
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.3, 0.5, 0.8])
def test_thresholds_match_reference(mu, sigma, rate):
    p = _matrix(300, 32, seed=7, mu=mu, sigma=sigma)[3:]
    q = _matrix(200, 32, seed=8, mu=mu, sigma=sigma)[3:]
    s = threshold.measure_stats(torch.tensor(p))
    js = jthr.measure_stats(jnp.asarray(p))
    assert float(s.mu) == pytest.approx(float(js.mu), rel=1e-5, abs=1e-7)
    assert float(s.sigma) == pytest.approx(float(js.sigma), rel=1e-6)
    t_p, t_q = threshold.thresholds_from_matrices(torch.tensor(p), torch.tensor(q), rate)
    w_p, w_q = jthr.thresholds_from_matrices(jnp.asarray(p), jnp.asarray(q), rate)
    assert float(t_p) == pytest.approx(float(w_p), rel=1e-6, abs=1e-7)
    assert float(t_q) == pytest.approx(float(w_q), rel=1e-6, abs=1e-7)
    if rate == 0.0:
        assert float(t_p) == 0.0 and float(t_q) == 0.0
    frac = threshold.empirical_pruned_fraction(torch.tensor(p), t_p)
    assert float(frac) == pytest.approx(
        float(jthr.empirical_pruned_fraction(jnp.asarray(p), float(t_p))), abs=1e-7
    )


def test_rate_zero_is_exactly_zero():
    stats = threshold.MatrixStats(torch.tensor(0.02), torch.tensor(0.1))
    assert float(threshold.threshold_for_rate(stats, 0.0)) == 0.0
    assert float(threshold.threshold_for_rate(stats, -0.5)) == 0.0


@pytest.mark.parametrize("mu,sigma,rate", [(-0.5, 0.02, 0.5), (-0.3, 0.01, 0.2), (0.1, 0.05, 0.4)])
def test_solve_x_brackets_strongly_negative_means(mu, sigma, rate):
    """The widened bracket solves Eq. 8 where the reference's cannot
    (mu/sigma = -25 and -30; the third case is inside both brackets)."""
    x = threshold.solve_x(mu, sigma, rate)
    mass = threshold._pruned_fraction(x, torch.tensor(mu), torch.tensor(sigma))
    assert float(mass) == pytest.approx(rate, abs=1e-5)
