"""The port's kernel modules held against the JAX reference on the same numpy
inputs: the plain versions (what a CPU tensor runs) against the Pallas
kernels in interpret mode, the reference's streaming path and its dense
oracles.  The CUDA kernels themselves are held against these plain versions
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.ranks import effective_ranks as j_effective_ranks
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.ranks import effective_ranks
from repro_torch.device import check_on
from repro_torch.kernels import build, fused_mf_sgd, ops, pruned_matmul, pruned_topk, ref

CSRC = Path(pruned_topk.__file__).parent / "csrc"


def _factors(m, n, k, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, (m, k)).astype(np.float32),
            rng.normal(0, scale, (n, k)).astype(np.float32))


def _grid(rng, shape):
    """f32 values on the 1/8 grid in [-2, 2]: every pruned dot is exact."""
    return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)


# ---------------------------------------------------------------------------
# pruned_matmul
# ---------------------------------------------------------------------------

MATMUL_SHAPES = [  # (m, n, k, bm, bn, bk) of the reference's own sweep
    (100, 77, 40, 32, 32, 16),
    (1, 300, 50, 8, 128, 64),
    (16, 16, 8, 16, 16, 8),
]


@pytest.mark.parametrize("m,n,k,bm,bn,bk", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [0.0, 0.06])
def test_pruned_matmul_matches_reference(m, n, k, bm, bn, bk, dtype, t):
    p, q = _factors(m, n, k)
    jp, jq = jnp.asarray(p, dtype), jnp.asarray(q, dtype)
    want_kernel = np.asarray(jops.pruned_matmul(
        jp, jq, t, t, block_m=bm, block_n=bn, block_k=bk, interpret=True))
    want_ref = np.asarray(jref.pruned_matmul_ref(
        jp, jq, j_effective_ranks(jp, t), j_effective_ranks(jq, t)))
    tp = torch.tensor(p).to(getattr(torch, dtype))
    tq = torch.tensor(q).to(getattr(torch, dtype))
    before = pruned_matmul.launches
    got = ops.pruned_matmul(tp, tq, t, t, device="cpu").numpy()
    assert pruned_matmul.launches == before  # CPU tensors never launch
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_pruned_matmul_out_dtype(out_dtype):
    p, q = _factors(9, 31, 12, seed=2)
    tp, tq = torch.tensor(p), torch.tensor(q)
    got = ops.pruned_matmul(tp, tq, 0.05, 0.05, out_dtype=out_dtype, device="cpu")
    assert got.dtype == out_dtype
    want = jref.pruned_matmul_ref(
        jnp.asarray(p), jnp.asarray(q),
        j_effective_ranks(jnp.asarray(p), 0.05), j_effective_ranks(jnp.asarray(q), 0.05),
        out_dtype=jnp.bfloat16 if out_dtype == torch.bfloat16 else jnp.float32,
    )
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2 if out_dtype == torch.bfloat16 else 1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# pruned_topk
# ---------------------------------------------------------------------------


def _reference_topk(p, q, t_p, t_q, topk, bias):
    """(kernel, streaming, oracle) answers of the JAX package."""
    jp, jq = jnp.asarray(p), jnp.asarray(q)
    jb = None if bias is None else jnp.asarray(bias)
    kernel = jops.pruned_topk(jp, jq, t_p, t_q, topk, item_bias=jb,
                              use_kernel=True, interpret=True)
    stream = jops.pruned_topk(jp, jq, t_p, t_q, topk, item_bias=jb,
                              use_kernel=False, block_n=128)
    oracle = jref.pruned_topk_ref(jp, jq, j_effective_ranks(jp, t_p),
                                  j_effective_ranks(jq, t_q), topk, item_bias=jb)
    return [(np.asarray(s), np.asarray(i)) for s, i in (kernel, stream, oracle)]


def _port_topk(p, q, t_p, t_q, topk, bias, block_n=128):
    tb = None if bias is None else torch.tensor(bias)
    before = pruned_topk.launches
    s, i = ops.pruned_topk(torch.tensor(p), torch.tensor(q), t_p, t_q, topk,
                           item_bias=tb, block_n=block_n, device="cpu")
    assert pruned_topk.launches == before
    assert i.dtype == torch.int32
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("t", [0.0, 0.05])
@pytest.mark.parametrize("with_bias", [False, True])
def test_pruned_topk_matches_reference(t, with_bias):
    p, q = _factors(40, 700, 24, seed=1)
    bias = (np.random.default_rng(3).normal(0, 0.3, (700,)).astype(np.float32)
            if with_bias else None)
    got_s, got_i = _port_topk(p, q, t, t, 9, bias)
    for want_s, want_i in _reference_topk(p, q, t, t, 9, bias):
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)


def test_pruned_topk_topk_equals_n():
    p, q = _factors(6, 50, 8, seed=4)
    bias = np.random.default_rng(5).normal(0, 0.3, (50,)).astype(np.float32)
    got_s, got_i = _port_topk(p, q, 0.05, 0.05, 50, bias, block_n=16)
    for want_s, want_i in _reference_topk(p, q, 0.05, 0.05, 50, bias):
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
    assert sorted(got_i[0].tolist()) == list(range(50))


@pytest.mark.parametrize("seed,t_p,t_q", [(0, 0.0, 0.0), (1, 1 / 8, 1 / 16), (2, 3 / 8, 1 / 8)])
def test_pruned_topk_grid_ties_bitwise(seed, t_p, t_q):
    """1/8-grid factors with duplicated item rows: exact score ties, so the
    indices pin the tie order (lower item index first), and scores match
    bitwise.  The harsher thresholds give ragged ranks, many of them 0."""
    rng = np.random.default_rng(seed)
    p, q = _grid(rng, (12, 24)), _grid(rng, (90, 24))
    q[rng.integers(0, 90, 45)] = q[rng.integers(0, 90, 45)]
    bias = _grid(rng, (90,))
    got_s, got_i = _port_topk(p, q, t_p, t_q, 20, bias, block_n=32)
    for want_s, want_i in _reference_topk(p, q, t_p, t_q, 20, bias):
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_s, want_s)
    # and the port's own oracle agrees
    r_u = effective_ranks(torch.tensor(p), t_p)
    r_i = effective_ranks(torch.tensor(q), t_q)
    os_, oi = ref.pruned_topk_ref(torch.tensor(p), torch.tensor(q), r_u, r_i, 20,
                                  item_bias=torch.tensor(bias))
    np.testing.assert_array_equal(oi.numpy(), got_i)
    np.testing.assert_array_equal(os_.numpy(), got_s)


@pytest.mark.parametrize("block_n", [1, 7, 64, 1024])
def test_stream_tile_width_does_not_change_answer(block_n):
    rng = np.random.default_rng(9)
    p, q = _grid(rng, (5, 10)), _grid(rng, (200, 10))
    q[rng.integers(0, 200, 100)] = q[rng.integers(0, 200, 100)]
    want = _port_topk(p, q, 1 / 8, 1 / 8, 13, None, block_n=200)
    got = _port_topk(p, q, 1 / 8, 1 / 8, 13, None, block_n=block_n)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_topk_validates_k():
    p, q = (torch.tensor(a) for a in _factors(4, 16, 8))
    for bad in (0, 17):
        with pytest.raises(ValueError):
            ops.pruned_topk(p, q, 0.0, 0.0, bad, device="cpu")


def test_public_wrappers_need_a_device():
    p, q = (torch.tensor(a) for a in _factors(4, 16, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.pruned_matmul(p, q, 0.0, 0.0, device="meta")
    with pytest.raises(ValueError, match="lies on cpu"):
        check_on(torch.device("cuda"), p=p)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ops.pruned_topk(p, q, 0.0, 0.0, 3)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ops.pruned_matmul(p, q, 0.0, 0.0)


# ---------------------------------------------------------------------------
# fused_mf_sgd
# ---------------------------------------------------------------------------


def _sgd_inputs(b, k, *, seed=1, grid=False, bias=False, weight=False):
    rng = np.random.default_rng(seed)
    draw = (lambda *s: _grid(rng, s)) if grid else (
        lambda *s: rng.normal(0, 0.1, s).astype(np.float32))
    out = {"p": draw(b, k), "q": draw(b, k),
           "r": (rng.integers(1, 6, (b,)) if grid else rng.uniform(1, 5, (b,))).astype(np.float32)}
    if bias:
        out.update(bu=draw(b), bi=draw(b), mu=np.float32(3.0 if grid else 3.1))
    if weight:  # some rows inert, some half-weighted
        out["w"] = (rng.integers(0, 3, (b,)) / 2.0).astype(np.float32)
    return out


def _reference_sgd(x, t, lr, lam, dtype, block_b):
    """(interpret-mode kernel, dense oracle) answers of the JAX package."""
    args = (jnp.asarray(x["p"], dtype), jnp.asarray(x["q"], dtype), jnp.asarray(x["r"]))
    extra = {}
    if "bu" in x:
        extra.update(bias_u=jnp.asarray(x["bu"]), bias_i=jnp.asarray(x["bi"]),
                     global_mean=jnp.float32(x["mu"]))
    if "w" in x:
        extra["weight"] = jnp.asarray(x["w"])
    kernel = jops.fused_mf_sgd(*args, t, t, lr=lr, lam=lam, block_b=block_b,
                               interpret=True, **extra)
    oracle = jref.fused_mf_sgd_ref(*args, jnp.float32(t), jnp.float32(t), lr=lr, lam=lam,
                                   **extra)
    return kernel, oracle


def _port_sgd(x, t, lr, lam, dtype):
    tdt = getattr(torch, dtype)
    extra = {}
    if "bu" in x:
        extra.update(bias_u=torch.tensor(x["bu"]), bias_i=torch.tensor(x["bi"]),
                     global_mean=float(x["mu"]))
    if "w" in x:
        extra["weight"] = torch.tensor(x["w"])
    before = fused_mf_sgd.launches
    out = ops.fused_mf_sgd(torch.tensor(x["p"]).to(tdt), torch.tensor(x["q"]).to(tdt),
                           torch.tensor(x["r"]), t, t, lr=lr, lam=lam, device="cpu", **extra)
    assert fused_mf_sgd.launches == before  # CPU tensors never launch
    return out


def _assert_sgd_close(got, want, tol, exact=False):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,k,bb", [(64, 32, 16), (33, 50, 8), (7, 16, 16), (256, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [0.0, 0.06])
def test_fused_mf_sgd_matches_reference(b, k, bb, dtype, t):
    """The reference's own sweep (tests/test_kernels.py), unbiased and
    unweighted: the port's plain version against the interpret-mode kernel
    and the dense oracle."""
    x = _sgd_inputs(b, k)
    got = _port_sgd(x, t, 0.05, 0.02, dtype)
    assert got[2] is None and got[3] is None
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in _reference_sgd(x, t, 0.05, 0.02, getattr(jnp, dtype), bb):
        _assert_sgd_close(got, want, tol)


@pytest.mark.parametrize("bias,weight", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("t", [0.0, 0.06])
def test_fused_mf_sgd_bias_and_weight(bias, weight, t):
    x = _sgd_inputs(45, 24, seed=3, bias=bias, weight=weight)
    got = _port_sgd(x, t, 0.05, 0.02, "float32")
    for want in _reference_sgd(x, t, 0.05, 0.02, jnp.float32, 16):
        _assert_sgd_close(got, want, 1e-5)
    if weight:  # weight-0 rows leave their factors and biases untouched
        inert = x["w"] == 0
        np.testing.assert_array_equal(got[0].numpy()[inert], x["p"][inert])
        if bias:
            np.testing.assert_array_equal(got[2].numpy()[inert], x["bu"][inert])


@pytest.mark.parametrize("t", [0.0, 1 / 8, 3 / 8])
def test_fused_mf_sgd_grid_bitwise(t):
    """1/8-grid rows, integer ratings, lr and lam powers of two: every
    product is exact, so all three formulations agree bitwise."""
    x = _sgd_inputs(40, 24, seed=4, grid=True, bias=True, weight=True)
    got = _port_sgd(x, t, 1 / 16, 1 / 32, "float32")
    for want in _reference_sgd(x, t, 1 / 16, 1 / 32, jnp.float32, 8):
        _assert_sgd_close(got, want, 0.0, exact=True)


def test_fused_mf_sgd_matches_scalar_algorithm_3():
    """The plain version against the paper's Algorithm 3 transcribed loop."""
    x = _sgd_inputs(9, 12, seed=5)
    new_p, new_q, _, _, err = _port_sgd(x, 0.07, 0.05, 0.02, "float32")
    for row in range(9):
        want_p, want_q, want_e = ref.early_stop_update_loop(
            x["p"][row], x["q"][row], float(x["r"][row]), 0.07, 0.07, 0.05, 0.02)
        np.testing.assert_allclose(new_p[row].numpy(), want_p, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(new_q[row].numpy(), want_q, rtol=1e-5, atol=1e-6)
        assert abs(float(err[row]) - want_e) < 1e-5


# ---------------------------------------------------------------------------
# the launch geometry around the CUDA kernel (checked here, run on the card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 127, 128, 256, 1024])
@pytest.mark.parametrize("n", [1, 128, 129, 700, 10_000_000])
@pytest.mark.parametrize("num_sms", [1, 132])
@pytest.mark.parametrize("topk", [1, 100, 1024, 5000])
def test_split_geometry_covers_catalog(m, n, num_sms, topk):
    topk = min(topk, n)
    splits, per = pruned_topk.split_geometry(m, n, num_sms, topk)
    assert per % pruned_topk.BLOCK_N == 0 and per > 0
    assert (splits - 1) * per < n <= splits * per  # every split non-empty
    user_tiles = -(-m // pruned_topk.BLOCK_M)
    per_sm = pruned_topk.BLOCKS_PER_SM
    assert splits * user_tiles <= max(user_tiles, per_sm * num_sms + user_tiles)
    # the per-split lists stay within the scratch budget (one split always)
    assert splits == 1 or splits * m * topk * 8 <= pruned_topk.SCRATCH_BYTES


def test_kernel_constants_match_sources():
    """The Python wrappers' geometry is the CUDA sources' own."""
    src = (CSRC / "pruned_topk.cu").read_text()
    consts = dict(re.findall(r"\b(k\w+) = (\d+)", src))
    assert int(consts["kBM"]) == pruned_topk.BLOCK_M
    assert int(consts["kBN"]) == pruned_topk.BLOCK_N
    assert int(consts["kBuf"]) == pruned_topk.BUFFER
    assert "kTopkMax" not in src  # no topk ceiling


def test_fused_kernel_constants_match_source():
    src = (CSRC / "fused_mf_sgd.cu").read_text()
    consts = dict(re.findall(r"\b(k\w+) = (\d+)", src))
    assert 32 * int(consts["kMaxLane"]) == fused_mf_sgd.REGISTER_K
    assert "kPiece = 32 * kMaxLane" in src  # wider rows run in pieces, no cap
    assert "fused_mf_sgd" in build.SOURCES


@pytest.mark.parametrize("name", build.SOURCES)
def test_kernel_sources_include_only_present_headers(name):
    """Every local header a kernel includes is in ``csrc/``, and so in the
    build digest."""
    src = (CSRC / f"{name}.cu").read_text()
    for header in re.findall(r'#include "([^"]+)"', src):
        assert (CSRC / header).is_file(), header


def test_pruned_matmul_width_limit_matches_source():
    src = (CSRC / "pruned_matmul.cu").read_text()
    assert f"kMaxK = {pruned_matmul.MAX_K};" in src


@pytest.mark.parametrize("k", [520, 1024, 1100])
@pytest.mark.parametrize("ranks", ["full", "random"])
def test_pruned_matmul_column_slices_sum_to_whole(k, ranks):
    """On CUDA, rows wider than ``MAX_K`` run as column slices with their
    ranks clamped to each slice; on 1/8-grid factors the slices' products
    sum to the whole product bit for bit."""
    rng = np.random.default_rng(k)
    p = torch.tensor((rng.integers(-16, 17, (9, k)) / 8.0).astype(np.float32))
    q = torch.tensor((rng.integers(-16, 17, (31, k)) / 8.0).astype(np.float32))
    if ranks == "full":
        r_u, r_i = effective_ranks(p, 0.0), effective_ranks(q, 0.0)
    else:
        r_u = torch.tensor(rng.integers(0, k + 1, 9).astype(np.int32))
        r_i = torch.tensor(rng.integers(0, k + 1, 31).astype(np.int32))
    slices = pruned_matmul.column_slices(k)
    assert [c0 for c0, _ in slices] == list(range(0, k, pruned_matmul.MAX_K))
    assert sum(w for _, w in slices) == k and max(w for _, w in slices) <= pruned_matmul.MAX_K
    total = torch.zeros((9, 31))
    for c0, w in slices:
        total += pruned_matmul.pruned_matmul_plain(
            p[:, c0:c0 + w], q[:, c0:c0 + w],
            pruned_matmul.slice_ranks(r_u, c0, w), pruned_matmul.slice_ranks(r_i, c0, w))
    assert torch.equal(total, pruned_matmul.pruned_matmul_plain(p, q, r_u, r_i))


# ---------------------------------------------------------------------------
# the TPU kernel's tile layout: padding and work fractions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,k,t", [(300, 1000, 16, 0.05), (128, 256, 128, 0.0),
                                     (77, 513, 40, 0.08)])
@pytest.mark.parametrize("blocks", [{}, {"block_m": 32, "block_n": 64, "block_k": 16}])
def test_tile_block_stats_match_reference(m, n, k, t, blocks):
    p, q = _factors(m, n, k, seed=m + n)
    r_u = j_effective_ranks(jnp.asarray(p), t)
    r_i = j_effective_ranks(jnp.asarray(q), t)
    want = jops.tile_block_stats(r_u, r_i, k, **blocks)
    got = ops.tile_block_stats(torch.as_tensor(np.asarray(r_u).copy()),
                               torch.as_tensor(np.asarray(r_i).copy()),
                               k, **blocks)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert abs(float(g) - float(w)) <= 1e-6


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("n,k", [(1000, 16), (256, 128), (5, 130)])
def test_pad_for_topk_kernel_bitwise(n, k, with_bias):
    p, q = _factors(n + 3, n, k, seed=n)
    rng = np.random.default_rng(k)
    r_u = rng.integers(0, k + 1, n + 3).astype(np.int32)
    r_i = rng.integers(0, k + 1, n).astype(np.int32)
    bias = rng.normal(size=n).astype(np.float32) if with_bias else None
    want = jops.pad_catalog_for_topk_kernel(jnp.asarray(q), jnp.asarray(r_i),
                                            None if bias is None else jnp.asarray(bias))
    got = ops.pad_catalog_for_topk_kernel(torch.as_tensor(q), torch.as_tensor(r_i),
                                          None if bias is None else torch.as_tensor(bias))
    want += jops.pad_users_for_topk_kernel(jnp.asarray(p), jnp.asarray(r_u))
    got += ops.pad_users_for_topk_kernel(torch.as_tensor(p), torch.as_tensor(r_u))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
