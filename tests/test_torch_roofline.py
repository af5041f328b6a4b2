"""The port's roofline (``repro_torch.roofline``) against the reference's
arithmetic, and the kernels' formulas against the numbers they replace.

* ``hw``: the H100 SXM's published dense peaks at 700 W, no TPU figure.
* ``roofline_terms``: equal to the reference's on the same seeded inputs,
  with the reference's ``hw`` constants set to the port's in this process
  only; ``extrapolate_depth`` and ``lm_model_flops`` equal the reference's
  exactly, on ``tests/test_roofline.py``'s cases too.
* Each kernel's ``cost``: given ranks (or indices), the operations and
  bytes of the formulas the chip smoke used before they moved beside the
  wrappers (copied below as they were), on seeded ranks; given none (meta),
  the dense count, with every rank at ``k``; ``analysis.bound`` as the
  smoke's ``bound``.
"""
import numpy as np
import pytest
import torch

from repro.roofline import analysis as janalysis
from repro.roofline import hw as jhw
from repro_torch.kernels import fused_mf_sgd, pruned_matmul, pruned_topk, scatter
from repro_torch.roofline import analysis, hw

# ---------------------------------------------------------------------------
# the chip smoke's formulas before this change, verbatim
# ---------------------------------------------------------------------------
OLD_PEAK_FP32_FLOPS, OLD_PEAK_TF32_FLOPS, OLD_PEAK_BYTES = 67e12, 495e12, 3.35e12
OLD_PEAK_BF16_FLOPS, OLD_TF32_PASSES = 989e12, 3


def old_above(r, k):
    counts = torch.bincount(r.long(), minlength=k + 1).double()
    return counts.flip(0).cumsum(0).flip(0)[1:]


def old_pair_flops(r_u, r_i, k):
    return 2.0 * float((old_above(r_u, k) * old_above(r_i, k)).sum())


def old_factor_bytes(r_u, r_i, itemsize):
    need_u = torch.clamp(r_u, max=int(r_i.max())).double().sum()
    need_i = torch.clamp(r_i, max=int(r_u.max())).double().sum()
    return itemsize * float(need_u + need_i) + 4.0 * (r_u.numel() + r_i.numel())


def old_bound(flops, nbytes, peak=OLD_PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / OLD_PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# hw and the reference's arithmetic
# ---------------------------------------------------------------------------


def test_hw_holds_the_h100_published_peaks():
    assert hw.PEAK_BF16_FLOPS == 989e12 == OLD_PEAK_BF16_FLOPS
    assert hw.PEAK_TF32_FLOPS == 495e12 == OLD_PEAK_TF32_FLOPS
    assert hw.PEAK_FP32_FLOPS == 67e12 == OLD_PEAK_FP32_FLOPS
    assert hw.HBM_BANDWIDTH == 3.35e12 == OLD_PEAK_BYTES
    assert hw.LINK_BANDWIDTH == 450e9
    assert "H100" in hw.__doc__ and "700 W" in hw.__doc__
    names = {n for n in vars(hw) if n.isupper()}
    assert names == {"PEAK_BF16_FLOPS", "PEAK_TF32_FLOPS", "PEAK_FP32_FLOPS", "HBM_BANDWIDTH",
                     "LINK_BANDWIDTH"}


@pytest.fixture
def reference_on_h100(monkeypatch):
    """The reference's hw constants set to the port's, in this process."""
    monkeypatch.setattr(jhw, "PEAK_BF16_FLOPS", hw.PEAK_BF16_FLOPS)
    monkeypatch.setattr(jhw, "HBM_BANDWIDTH", hw.HBM_BANDWIDTH)
    monkeypatch.setattr(jhw, "ICI_LINK_BANDWIDTH", hw.LINK_BANDWIDTH)


@pytest.mark.parametrize("seed", range(4))
def test_roofline_terms_are_the_reference(reference_on_h100, seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        flops, nbytes, coll = (float(10.0 ** rng.uniform(6, 18)) for _ in range(3))
        chips = int(rng.choice([1, 4, 256, 512]))
        model = None if rng.random() < 0.3 else float(flops * rng.uniform(0.1, 1.2))
        assert analysis.roofline_terms(flops, nbytes, coll, chips, model_flops=model) == \
            janalysis.roofline_terms(flops, nbytes, coll, chips, model_flops=model)


def test_roofline_terms_classify_as_the_reference_test(reference_on_h100):
    """``tests/test_roofline.py``'s cases, on the port's peaks."""
    chips = 256
    t = analysis.roofline_terms(1e12, 1e15, 1e10, chips, model_flops=5e11)
    assert t == janalysis.roofline_terms(1e12, 1e15, 1e10, chips, model_flops=5e11)
    assert t["dominant"] == "memory" and 0 < t["roofline_fraction"] <= 1.0
    assert abs(t["compute_s"] - 1e12 / (chips * hw.PEAK_BF16_FLOPS)) < 1e-12
    t2 = analysis.roofline_terms(1e12, 1e12, 1e15, chips)
    assert t2["dominant"] == "collective"
    assert t2 == janalysis.roofline_terms(1e12, 1e12, 1e15, chips)


def test_extrapolate_depth_is_the_reference():
    c1 = {"cost": {"flops": 8.0, "bytes_accessed": 80.0}, "collectives": {"total_bytes": 800.0}}
    c2 = {"cost": {"flops": 11.0, "bytes_accessed": 110.0},
          "collectives": {"total_bytes": 1100.0}}
    out = analysis.extrapolate_depth(c1, c2, 10)
    assert out == janalysis.extrapolate_depth(c1, c2, 10)
    assert out == {"flops": 35.0, "bytes_accessed": 350.0, "collective_bytes": 3500.0}
    rng = np.random.default_rng(7)
    for _ in range(50):
        a, b = ({"cost": {"flops": float(v[0]), "bytes_accessed": float(v[1])},
                 "collectives": {"total_bytes": float(v[2])}}
                for v in rng.uniform(0, 1e15, (2, 3)))
        layers = int(rng.integers(1, 64))
        assert analysis.extrapolate_depth(a, b, layers) == janalysis.extrapolate_depth(
            a, b, layers)
    # missing fields count 0, and a negative total is clipped, as the reference
    assert analysis.extrapolate_depth({}, {"cost": {"flops": -1.0}}, 3) == \
        janalysis.extrapolate_depth({}, {"cost": {"flops": -1.0}}, 3)


def test_lm_model_flops_is_the_reference():
    rng = np.random.default_rng(3)
    for kind in ("train", "prefill", "decode"):
        for _ in range(10):
            n, active, tokens = (int(v) for v in rng.integers(1, 10 ** 10, 3))
            assert analysis.lm_model_flops(n, active, tokens, kind) == \
                janalysis.lm_model_flops(n, active, tokens, kind)


# ---------------------------------------------------------------------------
# the kernels' formulas
# ---------------------------------------------------------------------------


def _ranks(rng, n, k):
    """Seeded ranks with every value in 0..k present, skewed low."""
    r = np.minimum(rng.geometric(0.2, n) - 1, k)
    r[: k + 1] = np.arange(k + 1)
    return torch.as_tensor(rng.permutation(r).astype(np.int32))


@pytest.mark.parametrize("seed", range(3))
def test_kernel_formulas_equal_the_smokes_on_seeded_ranks(seed):
    rng = np.random.default_rng(seed)
    k, m, n, topk = 128, 256, 5000, 100
    r_u, r_i = _ranks(rng, m, k), _ranks(rng, n, k)
    assert analysis.pair_flops(r_u, r_i, k) == old_pair_flops(r_u, r_i, k)
    assert analysis.factor_bytes(r_u, r_i, 4) == old_factor_bytes(r_u, r_i, 4)

    c = pruned_topk.cost(m, n, k, topk, r_u, r_i)
    assert (c.flops, c.bytes, c.products, c.dense) == (
        old_pair_flops(r_u, r_i, k), old_factor_bytes(r_u, r_i, 4) + 4.0 * n + 8.0 * m * topk,
        True, False)
    assert analysis.bound(c.flops, c.bytes) == old_bound(c.flops, c.bytes)

    c = pruned_matmul.cost(m, n, k, r_u, r_i)
    nbytes = old_factor_bytes(r_u, r_i, 4) + 4.0 * m * n
    assert (c.flops, c.bytes, c.dense) == (old_pair_flops(r_u, r_i, k), nbytes, False)
    assert analysis.bound(pruned_matmul.TF32_PASSES * c.flops, c.bytes, hw.PEAK_TF32_FLOPS) == \
        old_bound(OLD_TF32_PASSES * c.flops, nbytes, OLD_PEAK_TF32_FLOPS)

    b = 1 << 12
    c = fused_mf_sgd.cost(b, k)
    assert (c.flops, c.bytes) == (16.0 * b * k, 4.0 * b * k * 4 + 8.0 * b)
    assert analysis.bound(c.flops, c.bytes) == old_bound(16.0 * b * k, 4.0 * b * k * 4 + 8.0 * b)

    table = torch.zeros((n, k))
    idx = torch.as_tensor(rng.zipf(1.3, b) % n)
    rows = torch.as_tensor(rng.standard_normal((b, k), dtype=np.float32))
    unique = int(torch.unique(idx).numel())
    c = scatter.cost(table, idx, rows)
    old_bytes = 4.0 * b * k + 8.0 * b + 2 * 4.0 * unique * k
    assert (c.flops, c.bytes, c.dense) == (float(b * k), old_bytes, False)
    assert analysis.bound(c.flops, c.bytes) == old_bound(float(b * k), old_bytes)


def test_kernel_formulas_without_ranks_count_every_rank_at_k():
    k, m, n, topk, b = 64, 300, 7000, 10, 999
    full_u = torch.full((m,), k, dtype=torch.int32)
    full_i = torch.full((n,), k, dtype=torch.int32)
    for cost_fn, args in ((pruned_topk.cost, (m, n, k, topk)), (pruned_matmul.cost, (m, n, k))):
        dense = cost_fn(*args, full_u.to("meta"), full_i.to("meta"))
        assert dense == cost_fn(*args)
        ranked = cost_fn(*args, full_u, full_i)
        assert dense.dense and not ranked.dense
        assert (dense.flops, dense.bytes) == (ranked.flops, ranked.bytes) and \
            dense.flops == 2.0 * m * n * k
    table = torch.empty((n, k), device="meta")
    idx = torch.empty((b,), dtype=torch.int64, device="meta")
    rows = torch.empty((b, k), device="meta")
    c = scatter.cost(table, idx, rows)
    distinct = scatter.cost(torch.zeros((n, k)), torch.arange(b), torch.zeros((b, k)))
    assert c.dense and (c.flops, c.bytes) == (distinct.flops, distinct.bytes)
