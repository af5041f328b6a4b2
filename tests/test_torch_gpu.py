"""The CUDA kernels held against their plain PyTorch versions on the card.

Every test here carries the ``gpu`` marker and skips without a card; on the
card run ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
The file imports no JAX, so it runs where only the port is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import mf, trainer
from repro_torch.core.ranks import effective_ranks
from repro_torch.data.ratings import synthetic_ratings, train_test_split
from repro_torch.kernels import fused_mf_sgd, ops, pruned_matmul, pruned_topk, ref, scatter
from repro_torch.optim.optimizers import RowOptimizer
from repro_torch.serving import ServingEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: pytest -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, shape, dev, scale=0.1):
    return torch.tensor(rng.normal(0, scale, shape).astype(np.float32), device=dev)


def _grid(rng, shape, dev):
    return torch.tensor((rng.integers(-16, 17, shape) / 8.0).astype(np.float32), device=dev)


# (200, 3001, 130): several user tiles, n % 4 != 0, k % 4 != 0 (f32) and
# k % 8 != 0 (bf16); (64, 300000, 128): every block walks many item tiles;
# (130, 1003, 20): f32 rows 16-byte aligned, bf16 rows not.
@pytest.mark.parametrize("m,n,k", [(100, 77, 40), (257, 300, 129), (1, 1000, 128), (64, 5000, 128),
                                   (200, 3001, 130), (64, 300000, 128), (130, 1003, 20)])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("t", [0.0, 0.06])
def test_pruned_matmul_kernel_matches_plain(cuda, m, n, k, dtype, out_dtype, t):
    rng = np.random.default_rng(0)
    p, q = _normal(rng, (m, k), cuda).to(dtype), _normal(rng, (n, k), cuda).to(dtype)
    r_u, r_i = effective_ranks(p, t), effective_ranks(q, t)
    before = pruned_matmul.launches
    got = pruned_matmul.pruned_matmul_ranked(p, q, r_u, r_i, out_dtype=out_dtype)
    want = pruned_matmul.pruned_matmul_plain(p, q, r_u, r_i, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert pruned_matmul.launches == before + 1
    assert got.dtype == out_dtype
    tol = 1e-5 if (dtype, out_dtype) == (torch.float32, torch.float32) else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["mid-chunk", "zero"])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_pruned_matmul_kernel_ranks_set(cuda, case, dtype, out_dtype):
    """Ranks given directly: ending inside a 16-byte copy and a 32-deep chunk
    for most rows, or all 0 (exact zeros)."""
    rng = np.random.default_rng(5)
    m, n, k = 150, 2000, 128
    p, q = _normal(rng, (m, k), cuda).to(dtype), _normal(rng, (n, k), cuda).to(dtype)
    if case == "zero":
        r_u = torch.zeros(m, dtype=torch.int32, device=cuda)
        r_i = torch.zeros(n, dtype=torch.int32, device=cuda)
    else:
        odd = np.array([1, 3, 5, 13, 19, 33, 45, 63, 77, 101, 127, 128])
        r_u = torch.tensor(rng.choice(odd, m).astype(np.int32), device=cuda)
        r_i = torch.tensor(rng.choice(odd, n).astype(np.int32), device=cuda)
    got = pruned_matmul.pruned_matmul_ranked(p, q, r_u, r_i, out_dtype=out_dtype)
    want = pruned_matmul.pruned_matmul_plain(p, q, r_u, r_i, out_dtype=out_dtype)
    if case == "zero":
        assert torch.equal(got, torch.zeros_like(got))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_pruned_matmul_raises_on_misuse(cuda):
    p = torch.zeros((4, 8), device=cuda)
    r = torch.full((4,), 8, dtype=torch.int32, device=cuda)
    ranked = pruned_matmul.pruned_matmul_ranked
    with pytest.raises(ValueError, match="must lie on"):
        ranked(p, p.cpu(), r, r)
    with pytest.raises(ValueError, match="int32"):
        ranked(p, p, r.long(), r)


@pytest.mark.parametrize("k", [pruned_matmul.MAX_K + 8, 1024, 1100])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("t", [0.0, 0.02])
def test_pruned_matmul_wide_rows_match_plain(cuda, k, dtype, out_dtype, t):
    """Rows wider than one launch's MAX_K run as column slices, one launch
    each, summed in float32."""
    rng = np.random.default_rng(k)
    p, q = _normal(rng, (70, k), cuda).to(dtype), _normal(rng, (1003, k), cuda).to(dtype)
    r_u, r_i = effective_ranks(p, t), effective_ranks(q, t)
    before = pruned_matmul.launches
    got = pruned_matmul.pruned_matmul_ranked(p, q, r_u, r_i, out_dtype=out_dtype)
    want = pruned_matmul.pruned_matmul_plain(p, q, r_u, r_i, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert pruned_matmul.launches == before + len(pruned_matmul.column_slices(k))
    assert got.dtype == out_dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("k", [520, 1024])
@pytest.mark.parametrize("ranks", ["full", "random"])
def test_pruned_matmul_wide_rows_grid_exact(cuda, k, ranks):
    rng = np.random.default_rng(k + 1)
    p, q = _grid(rng, (130, k), cuda), _grid(rng, (2003, k), cuda)
    if ranks == "full":
        r_u, r_i = effective_ranks(p, 0.0), effective_ranks(q, 0.0)
    else:
        r_u = torch.tensor(rng.integers(0, k + 1, 130).astype(np.int32), device=cuda)
        r_i = torch.tensor(rng.integers(0, k + 1, 2003).astype(np.int32), device=cuda)
    got = pruned_matmul.pruned_matmul_ranked(p, q, r_u, r_i)
    assert torch.equal(got, pruned_matmul.pruned_matmul_plain(p, q, r_u, r_i))


@pytest.mark.parametrize("t", [0.0, 1 / 8])
def test_pruned_matmul_kernel_grid_exact(cuda, t):
    """1/8-grid factors: every product and partial sum is exact, so the
    kernel's 3xTF32 sums equal the plain fp32 product bit for bit."""
    rng = np.random.default_rng(6)
    p, q = _grid(rng, (130, 128), cuda), _grid(rng, (5003, 128), cuda)
    r_u, r_i = effective_ranks(p, t), effective_ranks(q, t)
    got = pruned_matmul.pruned_matmul_ranked(p, q, r_u, r_i)
    want = pruned_matmul.pruned_matmul_plain(p, q, r_u, r_i)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,n,k,t,topk", [
    (40, 700, 24, 0.0, 9), (40, 700, 24, 0.05, 700), (3, 50, 8, 0.0, 50),
    (300, 20000, 128, 0.05, 100), (1, 3000, 64, 0.02, 1024),
    (129, 129, 40, 0.0, 1), (1, 50000, 128, 0.0, 2000), (256, 100000, 128, 0.05, 4096),
    (70, 3000, 30, 0.02, 50), (50, 5000, 200, 0.05, 300), (20, 2000, 130, 0.0, 64)])
def test_pruned_topk_kernel_matches_oracle(cuda, m, n, k, t, topk):
    rng = np.random.default_rng(1)
    p, q = _normal(rng, (m, k), cuda), _normal(rng, (n, k), cuda)
    bias = _normal(rng, (n,), cuda, scale=0.3)
    r_u, r_i = effective_ranks(p, t), effective_ranks(q, t)
    before = pruned_topk.launches
    got_s, got_i = pruned_topk.pruned_topk_ranked(p, q, r_u, r_i, bias, topk)
    want_s, want_i = ref.pruned_topk_ref(p, q, r_u, r_i, topk, item_bias=bias)
    torch.cuda.synchronize()
    assert pruned_topk.launches == before + 1
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-5)
    # indices agree except where two scores lie within the tolerance
    differ = got_i != want_i
    near = (got_s - want_s).abs() <= 1e-5 + 1e-5 * want_s.abs()
    assert not torch.any(differ & ~near)


@pytest.mark.parametrize("m,n,k,t_p,t_q,topk", [
    (20, 80, 24, 1 / 8, 1 / 8, 17), (200, 3000, 24, 0.0, 0.0, 1024),
    (200, 30000, 64, 1 / 16, 1 / 8, 100), (256, 200000, 128, 0.0, 0.0, 100),
    (129, 50000, 32, 0.0, 0.0, 3000), (1, 129, 8, 0.0, 0.0, 1), (64, 20000, 200, 1 / 8, 1 / 8, 100)])
def test_pruned_topk_kernel_grid_ties_bitwise(cuda, m, n, k, t_p, t_q, topk):
    """1/8-grid factors with duplicated items: exact ties, exact scores."""
    rng = np.random.default_rng(2)
    p, q = _grid(rng, (m, k), cuda), _grid(rng, (n, k), cuda)
    dst = torch.tensor(rng.integers(0, n, n // 2), device=cuda)
    q[dst] = q[torch.tensor(rng.integers(0, n, n // 2), device=cuda)]
    bias = _grid(rng, (n,), cuda)
    got_s, got_i = ops.pruned_topk(p, q, t_p, t_q, topk, item_bias=bias)
    want_s, want_i = ops.pruned_topk(p.cpu(), q.cpu(), t_p, t_q, topk,
                                     item_bias=bias.cpu(), device="cpu", block_n=4096)
    assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_s.cpu(), want_s)


@pytest.mark.parametrize("topk", [1025, 3000, 6000])
def test_pruned_topk_wide_lists_match_oracle(cuda, topk):
    """No topk ceiling on CUDA: up to topk = n, through the kernel."""
    rng = np.random.default_rng(3)
    m, n, k = 40, 6000, 32
    p, q = _normal(rng, (m, k), cuda), _normal(rng, (n, k), cuda)
    bias = _normal(rng, (n,), cuda, scale=0.3)
    before = pruned_topk.launches
    got_s, got_i = ops.pruned_topk(p, q, 0.05, 0.05, topk, item_bias=bias)
    r_u, r_i = effective_ranks(p, 0.05), effective_ranks(q, 0.05)
    want_s, want_i = ref.pruned_topk_ref(p, q, r_u, r_i, topk, item_bias=bias)
    torch.cuda.synchronize()
    assert pruned_topk.launches == before + 1
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-5)
    near = (got_s - want_s).abs() <= 1e-5 + 1e-5 * want_s.abs()
    assert not torch.any((got_i != want_i) & ~near)
    if topk == n:
        assert torch.equal(got_i.sort(dim=1).values.cpu(),
                           torch.arange(n, dtype=torch.int32).expand(m, n))


@pytest.mark.parametrize("case,m,n,k,topk,one_split", [
    ("ascending", 300, 20000, 8, 100, False),   # every item a candidate
    ("ascending", 129, 5000, 8, 1500, False),
    ("ascending", 64, 20000, 8, 100, True),
    ("equal", 129, 3000, 8, 1030, False),       # only the index decides
    ("equal", 1, 129, 8, 1, False),
    ("equal", 2, 20000, 8, 300, True),
    ("normal", 129, 129, 24, 1, False),
    ("normal", 1, 129, 24, 129, False),
    ("normal", 64, 20000, 32, 100, True)])
def test_pruned_topk_kernel_buffer_stress(cuda, monkeypatch, case, m, n, k, topk, one_split):
    """Inputs that fill the candidate buffers, exact ties, ragged user tiles
    and a single catalog split, held exactly against the stable sort."""
    rng = np.random.default_rng(4)
    if case == "normal":
        p, q = _grid(rng, (m, k), cuda), _grid(rng, (n, k), cuda)
        bias = _grid(rng, (n,), cuda)
    else:
        p, q = torch.zeros((m, k), device=cuda), torch.zeros((n, k), device=cuda)
        bias = (torch.arange(n, device=cuda, dtype=torch.float32) if case == "ascending"
                else torch.zeros(n, device=cuda))
    if one_split:
        monkeypatch.setattr(pruned_topk, "split_geometry",
                            lambda m, n, sms, topk: (1, -(-n // pruned_topk.BLOCK_N) * pruned_topk.BLOCK_N))
    r_u = torch.full((m,), k, dtype=torch.int32, device=cuda)
    r_i = torch.full((n,), k, dtype=torch.int32, device=cuda)
    got_s, got_i = pruned_topk.pruned_topk_ranked(p, q, r_u, r_i, bias, topk)
    want_s, want_i = ref.pruned_topk_ref(p, q, r_u, r_i, topk, item_bias=bias)
    assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)


def test_engine_on_cuda_matches_cpu_engine(cuda, monkeypatch):
    """The CUDA engine goes through the kernel only, never the plain path,
    and answers as the CPU engine does."""
    g = torch.Generator(device="cpu").manual_seed(0)
    params = mf.init_params(g, 300, 5000, 32, variant="bias", global_mean=3.0, device="cpu")
    params = params._replace(item_bias=torch.randn((5000, 1), generator=g) * 0.2)
    cpu = ServingEngine(params, 0.05, 0.05, device="cpu", max_batch=64)
    users = np.arange(0, 300, 2)
    want_s, want_i = cpu.topk(users, 20)

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(pruned_topk, "pruned_topk_plain", no_plain)
    monkeypatch.setattr("repro_torch.serving.engine.stream_topk_tiles", no_plain)
    gpu = ServingEngine(params, 0.05, 0.05, device=cuda, max_batch=64)
    before = pruned_topk.launches
    got_s, got_i = gpu.topk(users, 20)
    assert pruned_topk.launches == before + 3  # 150 users in 64-user chunks
    near = np.abs(got_s - want_s) <= 1e-5 + 1e-5 * np.abs(want_s)
    assert near.all() and ((got_i == want_i) | near).all()
    futures = [gpu.submit(int(u), 20) for u in users[:16]]
    for row, fut in enumerate(futures):
        s, i = fut.result(timeout=60)
        assert s.tobytes() == got_s[row].tobytes() and i.tobytes() == got_i[row].tobytes()
    gpu.stop()


def test_predict_all_items_on_cuda(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    params = mf.init_params(g, 50, 3000, 64, variant="bias", global_mean=3.0, device=cuda)
    users = torch.arange(0, 50, 5, device=cuda)
    before = pruned_matmul.launches
    got = mf.predict_all_items(params, users, 0.05, 0.05)
    assert pruned_matmul.launches == before + 1
    cpu_params = mf.MFParams(*(None if v is None else v.cpu() for v in params))
    want = mf.predict_all_items(cpu_params, users.cpu(), 0.05, 0.05, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def _sgd_args(rng, b, k, dev, *, dtype=torch.float32, grid=False, bias_weight=False):
    draw = (lambda *s: _grid(rng, s, dev)) if grid else (lambda *s: _normal(rng, s, dev))
    args = [draw(b, k).to(dtype), draw(b, k).to(dtype),
            torch.tensor(rng.integers(1, 6, b).astype(np.float32), device=dev)]
    extra = {}
    if bias_weight:
        extra = dict(bias_u=draw(b), bias_i=draw(b), global_mean=torch.tensor([3.0], device=dev),
                     weight=torch.tensor((rng.integers(0, 3, b) / 2).astype(np.float32), device=dev))
    return args, extra


@pytest.mark.parametrize("b,k", [(1001, 16), (33, 50), (4099, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [0.0, 0.06])
@pytest.mark.parametrize("bias_weight", [False, True])
def test_fused_mf_sgd_kernel_matches_plain(cuda, b, k, dtype, t, bias_weight):
    rng = np.random.default_rng(b + k)
    args, extra = _sgd_args(rng, b, k, cuda, dtype=dtype, bias_weight=bias_weight)
    tt = torch.tensor([t], device=cuda)
    before = fused_mf_sgd.launches
    got = fused_mf_sgd.fused_mf_sgd_rows(*args, tt, tt, lr=0.05, lam=0.02, **extra)
    want = fused_mf_sgd.fused_mf_sgd_plain(*args, tt, tt, lr=0.05, lam=0.02, **extra)
    torch.cuda.synchronize()
    assert fused_mf_sgd.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype
            torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,k", [(3000, 128), (77, 50)])
def test_fused_mf_sgd_kernel_grid_bitwise(cuda, b, k):
    rng = np.random.default_rng(7)
    args, extra = _sgd_args(rng, b, k, cuda, grid=True, bias_weight=True)
    t_p, t_q = torch.tensor([1 / 8], device=cuda), torch.tensor([1 / 4], device=cuda)
    got = fused_mf_sgd.fused_mf_sgd_rows(*args, t_p, t_q, lr=1 / 16, lam=1 / 32, **extra)
    want = fused_mf_sgd.fused_mf_sgd_plain(*args, t_p, t_q, lr=1 / 16, lam=1 / 32, **extra)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fused_mf_sgd_raises_on_misuse(cuda):
    rng = np.random.default_rng(0)
    (p, q, r), extra = _sgd_args(rng, 64, 32, cuda, bias_weight=True)
    t = torch.tensor([0.0], device=cuda)
    rows = fused_mf_sgd.fused_mf_sgd_rows
    with pytest.raises(ValueError, match="must lie on"):
        rows(p, q, r, torch.tensor([0.0]), t, lr=0.1, lam=0.0)
    with pytest.raises(ValueError, match="contiguous"):
        rows(p.t().contiguous().t(), q, r, t, t, lr=0.1, lam=0.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rows(p.double(), q.double(), r, t, t, lr=0.1, lam=0.0)
    with pytest.raises(ValueError, match="both bias columns"):
        rows(p, q, r, t, t, lr=0.1, lam=0.0, bias_u=extra["bias_u"])
    with pytest.raises(ValueError, match="lies on cpu"):
        ops.fused_mf_sgd(p.cpu(), q.cpu(), r.cpu(), 0.0, 0.0, lr=0.1, lam=0.0)


@pytest.mark.parametrize("k", [fused_mf_sgd.REGISTER_K + 6, 2048, 3000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [0.0, 0.02])
def test_fused_mf_sgd_wide_rows_match_plain(cuda, k, dtype, t):
    """Rows wider than the register path: read in 1024-wide pieces."""
    rng = np.random.default_rng(k)
    args, extra = _sgd_args(rng, 517, k, cuda, dtype=dtype, bias_weight=True)
    tt = torch.tensor([t], device=cuda)
    before = fused_mf_sgd.launches
    got = fused_mf_sgd.fused_mf_sgd_rows(*args, tt, tt, lr=0.05, lam=0.02, **extra)
    want = fused_mf_sgd.fused_mf_sgd_plain(*args, tt, tt, lr=0.05, lam=0.02, **extra)
    torch.cuda.synchronize()
    assert fused_mf_sgd.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,k", [(3000, 1030), (77, 2048)])
def test_fused_mf_sgd_wide_rows_grid_bitwise(cuda, b, k):
    rng = np.random.default_rng(k + 7)
    args, extra = _sgd_args(rng, b, k, cuda, grid=True, bias_weight=True)
    t_p, t_q = torch.tensor([1 / 8], device=cuda), torch.tensor([1 / 4], device=cuda)
    args[0][:, :1500] = torch.where(args[0][:, :1500] == 0, 0.5, args[0][:, :1500])  # late ranks
    args[1][:, :1500] = torch.where(args[1][:, :1500].abs() < 1 / 4, 0.5, args[1][:, :1500])
    got = fused_mf_sgd.fused_mf_sgd_rows(*args, t_p, t_q, lr=1 / 16, lam=1 / 32, **extra)
    want = fused_mf_sgd.fused_mf_sgd_plain(*args, t_p, t_q, lr=1 / 16, lam=1 / 32, **extra)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("variant,opt_name,fused,weighted", [
    ("funk", "sgd", True, False), ("bias", "sgd", True, True),
    ("funk", "adagrad", False, True), ("svdpp", "momentum", False, False)])
def test_train_step_on_cuda_matches_cpu(cuda, monkeypatch, variant, opt_name, fused, weighted):
    """Two steps on the card against the same on the CPU, at 1e-5.  (Adam is
    left out: its first step divides g by |g| + 1e-8, which turns a rounding
    difference in a near-zero gradient into a step of size lr.)"""
    m, n, k, b = 300, 200, 64, 2048
    g = torch.Generator().manual_seed(3)
    cpu = mf.init_params(g, m, n, k, variant=variant, global_mean=3.0, device="cpu")
    gpu = mf.MFParams(*(None if v is None else v.to(cuda) for v in cpu))
    opt = RowOptimizer(opt_name)
    cpu_state, gpu_state = mf.init_opt_state(cpu, opt), mf.init_opt_state(gpu, opt)
    rng = np.random.default_rng(4)
    batch = {"user": torch.tensor(rng.integers(0, m, b)), "item": torch.tensor(rng.integers(0, n, b)),
             "rating": torch.tensor(rng.integers(1, 6, b).astype(np.float32))}
    if weighted:
        batch["weight"] = torch.tensor((rng.integers(0, 3, b) / 2).astype(np.float32))
    if variant == "svdpp":
        batch["hist"] = torch.tensor(rng.integers(0, n + 1, (b, 6)))
    gpu_batch = {key: v.to(cuda) for key, v in batch.items()}

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(fused_mf_sgd, "fused_mf_sgd_plain", no_plain)
    before = fused_mf_sgd.launches
    for t in (0.0, 0.05):
        mf.train_step(gpu, gpu_state, gpu_batch, torch.tensor(t, device=cuda),
                      torch.tensor(t, device=cuda), 0.05, torch.ones(k, device=cuda), opt=opt,
                      lam=0.02, use_fused_kernel=fused)
        monkeypatch.undo()
        mf.train_step(cpu, cpu_state, batch, torch.tensor(t), torch.tensor(t), 0.05, torch.ones(k),
                      opt=opt, lam=0.02, use_fused_kernel=fused)
        monkeypatch.setattr(fused_mf_sgd, "fused_mf_sgd_plain", no_plain)
    assert fused_mf_sgd.launches == before + (2 if fused else 0)
    for name, gv, cv in zip(cpu._fields, gpu, cpu):
        if cv is not None:
            torch.testing.assert_close(gv.cpu(), cv, rtol=1e-5, atol=1e-5,
                                       msg=lambda m, name=name: f"{name}: {m}")


def test_trainer_on_cuda_matches_cpu(cuda):
    train, test = train_test_split(synthetic_ratings(300, 200, 12000, seed=0), 0.2, seed=0)
    cfg = trainer.TrainConfig(k=32, epochs=3, batch_size=512, pruning_rate=0.3, optimizer="sgd",
                              use_fused_kernel=True, lr=0.01)
    rng = np.random.default_rng(0)
    init = {"p": rng.normal(0, 0.1, (300, 32)).astype(np.float32),
            "q": rng.normal(0, 0.1, (200, 32)).astype(np.float32)}
    runs = {}
    for device in ("cpu", cuda):
        t = trainer.DPMFTrainer(cfg, train, test, device=device)
        t.params = mf.params_from_numpy(init, device=device)
        t.opt_state = mf.init_opt_state(t.params, t.opt)
        before = fused_mf_sgd.launches
        runs[str(device)] = t.run()
        launched = fused_mf_sgd.launches - before
    assert launched == 3 * (len(train) // 512)
    for g, c in zip(runs["cuda"], runs["cpu"]):
        for field in ("train_abs_err", "test_mae", "work_fraction", "t_p", "t_q"):
            assert abs(getattr(g, field) - getattr(c, field)) <= 1e-4 * max(abs(getattr(c, field)), 1e-12)


def test_pruned_topk_takes_users_past_the_grid_limit(cuda):
    """8,388,481 users: one user tile past 65535 x 128, so the user tiles
    run over a second grid layer; held exactly against the stable sort in
    chunks of users, on 1/8-grid factors."""
    rng = np.random.default_rng(8)
    m, n, k, topk = 65535 * pruned_topk.BLOCK_M + 1, 300, 8, 5
    p = torch.randint(-8, 9, (m, k), device=cuda, dtype=torch.int32).float() / 8
    q, bias = _grid(rng, (n, k), cuda), _grid(rng, (n,), cuda)
    r_u, r_i = effective_ranks(p, 1 / 8), effective_ranks(q, 1 / 8)
    before = pruned_topk.launches
    got_s, got_i = pruned_topk.pruned_topk_ranked(p, q, r_u, r_i, bias, topk)
    assert pruned_topk.launches == before + 1
    for lo in range(0, m, 1 << 21):
        hi = min(lo + (1 << 21), m)
        want_s, want_i = ref.pruned_topk_ref(p[lo:hi], q, r_u[lo:hi], r_i, topk, item_bias=bias)
        assert torch.equal(got_s[lo:hi], want_s) and torch.equal(got_i[lo:hi], want_i)


def test_eval_ranking_scan_kernel_path_matches_plain(cuda, monkeypatch):
    """On the card the ranking scan goes through the pruned_topk kernel, one
    launch a packed batch, never the plain path; on 1/8-grid factors its ids
    equal the CPU's, so its float32 sums match within 1e-6 relative (the two
    devices reduce in another order)."""
    from repro_torch.eval import ranking

    rng = np.random.default_rng(9)
    m, n, k = 600, 5000, 32
    g = lambda *s: (rng.integers(-8, 9, s) / 8.0).astype(np.float32)  # noqa: E731
    fields = {"p": g(m, k), "q": g(n, k), "user_bias": g(m, 1), "item_bias": g(n, 1),
              "global_mean": np.float32(3.0)}
    ds = synthetic_ratings(m, n, 20000, seed=1)
    sums = {}
    for device in ("cpu", cuda):
        params = mf.params_from_numpy(fields, device=device)
        batches = ranking.pack_ranking_batches(ds, 256, device=device)
        if device == cuda:
            monkeypatch.setattr(pruned_topk, "pruned_topk_plain", None)
            before = pruned_topk.launches
        out = mf.eval_ranking_epoch_scan(params, batches, 1 / 8, 1 / 8, topk=10)
        sums[str(device)] = {key: float(v) for key, v in out.items()}
    assert pruned_topk.launches == before + batches["user"].shape[0]
    for key, want in sums["cpu"].items():
        assert abs(sums["cuda"][key] - want) <= 1e-6 * abs(want), key
    assert sums["cuda"]["weight_sum"] > 0 and sums["cuda"]["hr_sum"] > 0
    cpu = mf.params_from_numpy(fields, device="cpu")
    r_i = effective_ranks(params.q, 1 / 8)
    for step in range(batches["user"].shape[0]):
        u = batches["user"][step]
        pu = params.p[u]
        _, got = pruned_topk.pruned_topk_ranked(pu, params.q, effective_ranks(pu, 1 / 8), r_i,
                                                params.item_bias[:, 0].contiguous(), 10)
        _, want = ref.pruned_topk_ref(cpu.p[u.cpu()], cpu.q, effective_ranks(cpu.p[u.cpu()], 1 / 8),
                                      r_i.cpu(), 10, item_bias=cpu.item_bias[:, 0])
        assert torch.equal(got.cpu(), want)


def test_trainer_ranking_metrics_on_cuda_match_cpu(cuda):
    train, test = train_test_split(synthetic_ratings(300, 200, 12000, seed=0), 0.2, seed=0)
    cfg = trainer.TrainConfig(k=32, epochs=2, batch_size=512, pruning_rate=0.3, optimizer="sgd",
                              use_fused_kernel=True, lr=0.01, ranking_topk=10)
    rng = np.random.default_rng(0)
    init = {"p": rng.normal(0, 0.1, (300, 32)).astype(np.float32),
            "q": rng.normal(0, 0.1, (200, 32)).astype(np.float32)}
    runs = {}
    for device in ("cpu", cuda):
        t = trainer.DPMFTrainer(cfg, train, test, device=device)
        t.params = mf.params_from_numpy(init, device=device)
        t.opt_state = mf.init_opt_state(t.params, t.opt)
        runs[str(device)] = t.run()
    for g, c in zip(runs["cuda"], runs["cpu"]):
        for field in ("hr", "ndcg", "recall"):
            assert np.isfinite(getattr(g, field))
            assert abs(getattr(g, field) - getattr(c, field)) <= 1e-6


@pytest.mark.parametrize("variant", ["funk", "bias"])
def test_swap_on_cuda_matches_fresh_engine(cuda, variant):
    """A touched-items swap on the card serves what a fresh engine on the
    new params serves, bit for bit, and the previous snapshot's ranks and
    biases keep their values."""
    g = torch.Generator(device="cpu").manual_seed(2)
    params = mf.init_params(g, 300, 5000, 32, variant=variant, global_mean=3.0, device="cpu")
    if variant == "bias":
        params = params._replace(item_bias=torch.randn((5000, 1), generator=g) * 0.2)
    engine = ServingEngine(params, 0.05, 0.05, device=cuda, max_batch=64)
    users = np.arange(0, 300, 3)
    engine.topk(users, 20)
    prev = engine._snap
    r_before, b_before = prev.r_i.clone(), prev.item_bias_vec.clone()
    touched = np.unique(np.random.default_rng(3).integers(0, 5000, 50))
    q = params.q.clone()
    q[touched] += torch.randn((touched.size, 32), generator=g) * 0.2
    new = params._replace(q=q)
    if variant == "bias":
        new = new._replace(item_bias=params.item_bias.clone())
        new.item_bias[touched] += 1.0
    engine.swap(new, touched_users=[], touched_items=touched)
    got_s, got_i = engine.topk(users, 20)
    want_s, want_i = ServingEngine(new, 0.05, 0.05, device=cuda, max_batch=64).topk(users, 20)
    assert np.array_equal(got_i, want_i) and np.array_equal(got_s, want_s)
    assert torch.equal(prev.r_i, r_before) and torch.equal(prev.item_bias_vec, b_before)
    remap = np.arange(300, dtype=np.int32)
    remap[::7] = -1
    engine.swap(new, user_remap=remap, remap_epoch=1)
    fs, fi = engine._snap.fallback_topk(20)
    got_s, got_i = engine.topk(users, 20)
    evicted = remap[users] < 0
    assert (got_i[evicted] == fi).all() and (got_s[evicted] == fs).all()
    assert np.array_equal(got_i[~evicted], want_i[~evicted])


# ---------------------------------------------------------------------------
# the workloads and the online freshness loop on the card
# ---------------------------------------------------------------------------


def test_implicit_trainer_on_cuda_matches_cpu(cuda):
    """The implicit objective through fused_mf_sgd with its weight column on
    the card, against the same run on the CPU (identical expansion, order
    and initial factors)."""
    train, test = train_test_split(synthetic_ratings(300, 200, 6000, seed=0), 0.2, seed=0)
    cfg = trainer.TrainConfig(k=32, epochs=3, batch_size=512, pruning_rate=0.3, optimizer="sgd",
                              use_fused_kernel=True, lr=0.002, objective="implicit",
                              implicit_alpha=4.0, implicit_negatives=2, ranking_topk=10)
    rng = np.random.default_rng(0)
    init = {"p": rng.normal(0, 0.1, (300, 32)).astype(np.float32),
            "q": rng.normal(0, 0.1, (200, 32)).astype(np.float32)}
    runs = {}
    for device in ("cpu", cuda):
        t = trainer.DPMFTrainer(cfg, train, test, device=device)
        t.params = mf.params_from_numpy(init, device=device)
        t.opt_state = mf.init_opt_state(t.params, t.opt)
        before = fused_mf_sgd.launches
        runs[str(device)] = (t.run(), t.perm.cpu())
        launched = fused_mf_sgd.launches - before
    assert launched == 3 * (len(train) * 3 // 512)
    (got, perm_gpu), (want, perm_cpu) = runs["cuda"], runs["cpu"]
    assert torch.equal(perm_gpu, perm_cpu)
    for g, c in zip(got, want):
        for field in ("train_abs_err", "test_mae", "work_fraction"):
            assert abs(getattr(g, field) - getattr(c, field)) <= 1e-4 * abs(getattr(c, field))
        assert abs(g.hr - c.hr) <= 1e-6


@pytest.mark.parametrize("grid", [False, True])
def test_bpr_step_on_cuda_matches_plain(cuda, grid):
    """bpr_train_step on the card against bpr_step_ref on the CPU: random
    factors within 1e-5; 1/8-grid rows whose negatives copy their
    positives' rows (every difference 0, the sigmoid exactly 0.5) exactly,
    duplicates accumulated by atomics in any order."""
    from repro_torch.optim.optimizers import RowOptimizer
    from repro_torch.workloads import bpr

    rng = np.random.default_rng(4)
    m, n, k, b = 500, 400, 40, 3000
    u = rng.integers(0, m, b)
    if grid:
        p, q = _grid(rng, (m, k), "cpu"), _grid(rng, (n, k), "cpu")
        i = rng.integers(0, n // 2, b)
        j = i + n // 2
        q[n // 2:] = q[: n // 2]
        t, lr, lam = 1 / 8, 1 / 16, 1 / 32
    else:
        p, q = _normal(rng, (m, k), "cpu", 0.3), _normal(rng, (n, k), "cpu", 0.3)
        i, j = rng.integers(0, n, b), rng.integers(0, n, b)
        t, lr, lam = 0.1, 0.05, 0.02
    idx = [torch.as_tensor(x, dtype=torch.int64) for x in (u, i, j)]
    want_p, want_q, _, want_loss = ref.bpr_step_ref(p, q, *idx, t, t, lr=lr, lam=lam)
    opt = RowOptimizer(name="sgd")
    params = mf.MFParams(p.to(cuda), q.to(cuda), None, None, None, None)
    batch = {"user": idx[0].to(cuda), "pos": idx[1].to(cuda), "neg": idx[2].to(cuda)}
    got, _, metrics = bpr.bpr_train_step(params, mf.init_opt_state(params, opt), batch,
                                         torch.tensor(t, device=cuda), torch.tensor(t, device=cuda),
                                         lr, torch.ones(k, device=cuda), opt=opt, lam=lam)
    if grid:
        assert torch.equal(got.p.cpu(), want_p) and torch.equal(got.q.cpu(), want_q)
    else:
        torch.testing.assert_close(got.p.cpu(), want_p, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got.q.cpu(), want_q, rtol=1e-5, atol=1e-5)
    assert abs(float(metrics["abs_err"]) - want_loss) <= 1e-5


def test_online_loop_on_cuda_matches_cpu(cuda):
    """The same stream through an updater on the card and one on the CPU:
    tables within 1e-5; the engine on the card (pruned_topk) keeps every published version bit for
    bit through later applies, serves what a fresh engine on a copy serves,
    and the ranking evaluator's hits equal the CPU engine's."""
    from repro_torch.eval import PrequentialRankingEvaluator
    from repro_torch.online import OnlineUpdater, PoissonSource, SnapshotPublisher
    from repro_torch.online import iter_microbatches

    rng = np.random.default_rng(5)
    m, n, k = 400, 3000, 32
    init = {"p": _normal(rng, (m, k), "cpu"), "q": _normal(rng, (n, k), "cpu")}
    sides = {}
    for device in ("cpu", cuda):
        params = mf.params_from_numpy({name: v.numpy() for name, v in init.items()}, device=device)
        engine = ServingEngine(params, 0.05, 0.05, device=device, max_batch=64)
        upd = OnlineUpdater(params, None, 0.05, 0.05, optimizer="sgd", lr=0.01, lam=0.02,
                            batch_size=64, seed=3, device=device)
        sides[str(device)] = (engine, upd, SnapshotPublisher(engine, upd),
                              PrequentialRankingEvaluator(upd, engine=engine, topk=10))
    before = pruned_topk.launches
    for j, batch in enumerate(iter_microbatches(
            PoissonSource(m, n, seed=6, new_user_prob=0.01, new_item_prob=0.01), 100,
            max_events=1200)):
        held = {}
        for name, (engine, upd, pub, rank_eval) in sides.items():
            rank_eval.score(batch)
            held[name] = [v.clone() for v in engine.params if v is not None]
            upd.apply(batch)
            assert all(torch.equal(a, b) for a, b in zip(
                [v for v in engine.params if v is not None], held[name]))
            if j % 3 == 2:
                pub.publish()
        if j == 0:  # the same version on both sides: the same hits
            assert sides["cuda"][3].stats.hit_rate == sides["cpu"][3].stats.hit_rate
    # later versions differ by float32 rounding (scatter order): near-ties may flip
    assert abs(sides["cuda"][3].stats.hit_rate - sides["cpu"][3].stats.hit_rate) <= 0.01
    assert pruned_topk.launches > before
    (engine, upd, _, _), (_, cpu_upd, _, _) = sides["cuda"], sides["cpu"]
    torch.testing.assert_close(upd.params.p.cpu(), cpu_upd.params.p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(upd.params.q.cpu(), cpu_upd.params.q, rtol=1e-5, atol=1e-5)
    assert upd.params.q.shape[0] > n and upd.params.p.shape[0] > m
    assert bool(torch.isfinite(upd.params.p).all() and torch.isfinite(upd.params.q).all())
    copy = mf.MFParams(*(None if v is None else v.clone() for v in engine.params))
    fresh = ServingEngine(copy, engine.t_p, engine.t_q, device=cuda, max_batch=64)
    users = np.arange(engine.num_users)
    got, want = engine.topk(users, 10), fresh.topk(users, 10)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _store(tmp_path, users=300, items=200, ratings=12000):
    from repro_torch.store import build_store

    train, test = train_test_split(synthetic_ratings(users, items, ratings, seed=0), 0.2, seed=0)
    return build_store(train, str(tmp_path / "store"), shard_rows=2000), test


@pytest.mark.parametrize("batch,slab_steps,prefetch", [(512, 3, 2), (1000, 1, 1)])
def test_store_loader_slabs_on_cuda_equal_the_cpu_loaders(cuda, tmp_path, batch, slab_steps,
                                                          prefetch):
    """The prefetch worker's pinned copy on a side stream, waited for by the
    consumer's stream: every slab on the card equals the CPU loader's, bit
    for bit, while the consumer keeps the card busy between slabs."""
    from repro_torch.store import RatingsStore, ShardedRatingsLoader

    store_dir, _ = _store(tmp_path)
    loaders = {str(d): ShardedRatingsLoader(RatingsStore(store_dir), batch, slab_steps=slab_steps,
                                            prefetch=prefetch, device=d) for d in ("cpu", cuda)}
    busy = torch.randn(2048, 2048, device=cuda)
    for epoch in (0, 1):
        got = list(loaders["cuda"].epoch_slabs(3, epoch))
        want = list(loaders["cpu"].epoch_slabs(3, epoch))
        assert [s.slab_idx for s in got] == [s.slab_idx for s in want]
        for g, w in zip(got, want):
            busy = busy @ busy.T / 2048.0  # work queued on the consumer's stream
            assert g.batches["user"].is_cuda and g.timings["copy"] >= 0.0
            for key in w.batches:
                assert g.batches[key].dtype == w.batches[key].dtype
                assert torch.equal(g.batches[key].cpu(), w.batches[key]), key
    torch.cuda.synchronize()


def test_store_trainer_on_cuda_matches_cpu(cuda, tmp_path):
    """The streamed epoch on the card (fused_mf_sgd every step) against the
    same store on the CPU from the same initial factors: records within 1e-4
    relative, and a killed run resumed mid-epoch on the card within 1e-4 of
    the uninterrupted one (the scatter's atomics add in another order)."""
    store_dir, test = _store(tmp_path)
    cfg = dict(k=32, epochs=3, batch_size=512, pruning_rate=0.3, optimizer="sgd",
               use_fused_kernel=True, lr=0.01, store_dir=store_dir, slab_steps=3)
    rng = np.random.default_rng(0)
    init = {"p": rng.normal(0, 0.1, (300, 32)).astype(np.float32),
            "q": rng.normal(0, 0.1, (200, 32)).astype(np.float32)}

    def make(device, **kw):
        t = trainer.DPMFTrainer(trainer.TrainConfig(**cfg, **kw), None, test, device=device)
        t.params = mf.params_from_numpy(init, device=device)
        t.opt_state = mf.init_opt_state(t.params, t.opt)
        return t

    runs = {}
    for device in ("cpu", cuda):
        t = make(device)
        before = fused_mf_sgd.launches
        runs[str(device)] = t.run()
        launched = fused_mf_sgd.launches - before
    assert launched == 3 * runs_loader_steps(store_dir, 512)
    for g, c in zip(runs["cuda"], runs["cpu"]):
        for field in ("train_abs_err", "test_mae", "work_fraction", "t_p", "t_q"):
            assert abs(getattr(g, field) - getattr(c, field)) <= 1e-4 * max(abs(getattr(c, field)), 1e-12)

    ckpt = str(tmp_path / "ckpt")
    killed = make(cuda, checkpoint_dir=ckpt, checkpoint_every_slabs=2)
    num_slabs = killed._loader.num_slabs
    original, calls = trainer.mf.train_epoch_scan, {"n": 0}

    def dying(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] > num_slabs + 3:
            raise KeyboardInterrupt
        return original(*args, **kwargs)

    trainer.mf.train_epoch_scan = dying
    try:
        with pytest.raises(KeyboardInterrupt):
            killed.run()
    finally:
        trainer.mf.train_epoch_scan = original
        killed._ckpt.wait()
    resumed = make(cuda, checkpoint_dir=ckpt, checkpoint_every_slabs=2)
    assert resumed.maybe_restore() and resumed.epoch == 1 and resumed._resume_slab == 2
    history = resumed.run()
    for field in ("train_abs_err", "test_mae", "work_fraction"):
        want = getattr(runs["cuda"][-1], field)
        assert abs(getattr(history[-1], field) - want) <= 1e-4 * max(abs(want), 1e-12)


def runs_loader_steps(store_dir, batch):
    """Steps of one streamed epoch over the store."""
    from repro_torch.store import RatingsStore

    return len(RatingsStore(store_dir)) // batch


def test_evictor_on_cuda_matches_cpu(cuda, tmp_path):
    """Growth, spill, compaction and revival on the card against the same
    calls on the CPU, bitwise (no step runs); a version published before
    the compaction keeps its tensors."""
    from repro_torch.online import OnlineUpdater
    from repro_torch.store import EvictionConfig, UserEvictor

    rng = np.random.default_rng(4)
    init = {"p": rng.normal(0, 0.1, (500, 32)).astype(np.float32),
            "q": rng.normal(0, 0.1, (300, 32)).astype(np.float32),
            "user_bias": rng.normal(0, 0.1, (500, 1)).astype(np.float32),
            "item_bias": rng.normal(0, 0.1, (300, 1)).astype(np.float32),
            "global_mean": np.float32(3.0)}
    sides = {}
    for device in ("cpu", cuda):
        upd = OnlineUpdater(mf.params_from_numpy(init, device=device), None, 0.05, 0.05,
                            optimizer="adagrad", seed=2, device=device)
        upd.attach_evictor(UserEvictor(EvictionConfig(
            max_users=520, target_users=400, spill_dir=str(tmp_path / f"spill_{device}"))))
        sides[str(device)] = upd
    for step in range(5):
        ext = rng.integers(0, 500 + 10 * step, 64).astype(np.int32)
        assert np.array_equal(*(upd.resolve_users(ext) for upd in sides.values()))
    held = sides["cuda"].snapshot().params.p.clone()
    snap_p = sides["cuda"].params.p
    reports = [upd.evictor.maybe_evict() for upd in sides.values()]
    assert reports[0]["evicted"] == reports[1]["evicted"] > 0
    assert torch.equal(snap_p, held)
    spilled = sides["cpu"].evictor.spilled_external_ids()[::3].astype(np.int32)
    assert np.array_equal(*(upd.resolve_users(spilled) for upd in sides.values()))
    (c, g) = sides["cpu"], sides["cuda"]
    assert np.array_equal(c.evictor.remap.ext_to_phys, g.evictor.remap.ext_to_phys)
    for name in ("p", "user_bias"):
        assert torch.equal(getattr(g.params, name).cpu(), getattr(c.params, name))
    assert torch.equal(g.opt_state.p["acc"].cpu(), c.opt_state.p["acc"])


# ---------------------------------------------------------------------------
# the serving fleet and the SLO controller on the card
# ---------------------------------------------------------------------------


def _fleet_params(dev, m, n, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return mf.MFParams(p=torch.randn((m, k), generator=g, device=dev).mul_(0.1),
                       q=torch.randn((n, k), generator=g, device=dev).mul_(0.1),
                       user_bias=None, item_bias=None, global_mean=None, implicit=None)


def _event_batch(rng, m, n, size=512):
    from repro_torch.online import EventBatch

    return EventBatch(user=rng.integers(0, m, size).astype(np.int32),
                      item=rng.integers(0, n, size).astype(np.int32),
                      rating=rng.uniform(1, 5, size).astype(np.float32))


def test_process_replica_serves_on_cuda_and_counts_its_launches(cuda):
    """A spawned replica opens its own CUDA context, loads the built kernel
    and answers bitwise as an engine in this process; a replicated delta
    lands bitwise too."""
    from repro_torch.online import OnlineUpdater
    from repro_torch.serving.fleet import ProcessReplica, make_message, state_message

    m, n, k = 4096, 50000, 128
    params = _fleet_params(cuda, m, n, k, 1)
    t_p = t_q = 0.05
    rep = ProcessReplica("gpu", init_msg=state_message(params, t_p, t_q),
                         engine_kwargs={"device": "cuda"}, start_timeout=120.0)
    try:
        assert rep.boot["cuda_context_ms"] > 0 and rep.boot["kernel_load_ms"] >= 0
        upd = OnlineUpdater(params, None, t_p, t_q, optimizer="sgd", lr=0.01, device=cuda)
        upd.apply(_event_batch(np.random.default_rng(1), m, n))
        assert rep.apply_update(make_message(upd.snapshot(), 1, 0, full=False)) == 1
        want = ServingEngine(upd.params, upd.t_p, upd.t_q).topk(np.arange(64), 10)
        rows = [rep.submit(u, 10, timeout=60.0).result(60) for u in range(64)]
        np.testing.assert_array_equal(np.stack([r[0] for r in rows]), want[0])
        np.testing.assert_array_equal(np.stack([r[1] for r in rows]), want[1])
        stats = rep.stats()
        assert stats["version"] == 1 and stats["pruned_topk_launches"] >= 1
    finally:
        rep.close()


def test_local_fleet_under_load_on_cuda_converges_bitwise(cuda):
    import threading

    from repro_torch.online import OnlineUpdater, SnapshotPublisher
    from repro_torch.serving.fleet import ServingFleet

    m, n, k = 20000, 100000, 128
    params = _fleet_params(cuda, m, n, k, 2)
    upd = OnlineUpdater(params, None, 0.05, 0.05, optimizer="sgd", lr=0.01, device=cuda)
    fleet = ServingFleet(params, 0.05, 0.05, replicas=3, queue_kwargs={"linger_ms": 0.5})
    pub = SnapshotPublisher(None, upd)
    pub.subscribe(fleet.router)
    failures, done, stop = [], [0], threading.Event()

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                fleet.submit(int(rng.integers(0, m)), 10, timeout=30.0).result(60)
                done[0] += 1
            except Exception as exc:  # noqa: BLE001
                failures.append(repr(exc))

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    rng = np.random.default_rng(2)
    try:
        for _ in range(4):
            upd.apply(_event_batch(rng, m, n))
            assert pub.publish().kind == "delta"
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    try:
        assert not failures and done[0] > 0
        want = ServingEngine(upd.params, upd.t_p, upd.t_q).topk(np.arange(256), 10)
        for rep in fleet.replicas:
            assert rep.version == 4
            got = rep.engine.topk(np.arange(256), 10)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    finally:
        fleet.close()


def test_slo_apply_on_cuda_serves_as_a_fresh_engine(cuda):
    """An SLO degrade at 200k x 100k x 128: thresholds within 1e-4 relative
    of a float64 solve's statistics, the engine bitwise a fresh engine at
    the applied thresholds."""
    from repro_torch.core.threshold import threshold_for_rate
    from repro_torch.core.threshold import MatrixStats
    from repro_torch.serving import LatencyWindow, SLOConfig, SLOController

    params = _fleet_params(cuda, 200000, 100000, 128, 3)
    engine = ServingEngine(params, 0.0, 0.0)
    window = LatencyWindow(64)
    for _ in range(32):
        window.record(0.5)
    ctl = SLOController(engine, config=SLOConfig(p99_budget_ms=50.0, min_window=8,
                                                 tick_interval_s=0.0),
                        window=window, depth_fn=lambda: 0, expired_fn=lambda: 0)
    d = ctl.tick()
    assert d.action == "degrade" and d.swapped
    for name, table, t in (("p", params.p, d.t_p), ("q", params.q, d.t_q)):
        x = table.double()
        stats = MatrixStats(mu=x.mean().float(), sigma=x.std(correction=0).float())
        want = float(threshold_for_rate(stats, d.applied_rate))
        assert t == pytest.approx(want, rel=1e-4), name
    fresh = ServingEngine(params, np.float32(d.t_p), np.float32(d.t_q))
    users = np.arange(512)
    for got, want in zip(engine.topk(users, 100), fresh.topk(users, 100)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# two ranks on the one card (gloo over CUDA tensors)
# ---------------------------------------------------------------------------


def _rank_pool():
    from repro_torch.testing.ranks import RankPool

    return RankPool(2, backend="gloo", device="cuda")


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
def test_sharded_step_on_cuda_matches_single_device_step(cuda, opt_name):
    """Two gloo ranks on cuda:0, a (1, 2) data x model mesh: the sharded
    step against the single-device ``train_step`` on the card within 2e-8
    plus 1e-6 relative: the single-device step's scatter-add atomics add
    repeated rows in any order, the sharded step in batch order."""
    import test_torch_multirank_cases as cases

    rng = np.random.default_rng(1)
    m, n, k, b = 64, 48, 32, 128
    full = {"p": rng.normal(0, 0.1, (m, k)).astype(np.float32),
            "q": rng.normal(0, 0.1, (n, k)).astype(np.float32)}
    batch = {"user": rng.integers(0, m, b).astype(np.int32),
             "item": rng.integers(0, n, b).astype(np.int32),
             "rating": rng.uniform(1, 5, b).astype(np.float32),
             "weight": rng.uniform(0.3, 1.0, b).astype(np.float32)}
    with _rank_pool() as pool:
        got = pool.run(cases.step_case, (1, 2), ("data", "model"), full, batch, 0.05,
                       opt_name, "none")
    opt = RowOptimizer(name=opt_name)
    params = mf.params_from_numpy(full, device=cuda)
    state = mf.init_opt_state(params, opt)
    tb = {key: torch.as_tensor(value).to(cuda) for key, value in batch.items()}
    tb["user"], tb["item"] = tb["user"].long(), tb["item"].long()
    t = torch.tensor(0.05, device=cuda)
    mf.train_step(params, state, tb, t, t, 0.05, torch.ones(k, device=cuda), opt=opt, lam=0.02)
    for out in got:
        # both steps scatter through add_rows: repeats in batch order, bitwise
        np.testing.assert_array_equal(out["p"], params.p.cpu().numpy())
        np.testing.assert_array_equal(out["q"], params.q.cpu().numpy())
    # the replicas of the p block (over "model") hold the same bits
    np.testing.assert_array_equal(got[0]["p"], got[1]["p"])


def test_topk_sharded_on_cuda_launches_the_kernel(cuda):
    """Two gloo ranks on cuda:0, a 1-D model mesh: each rank's slab goes
    through the ``pruned_topk`` kernel (one launch per rank for one chunk),
    and the merged answer equals the plain version of the whole catalog:
    ids identical outside near-ties, scores within 1e-5."""
    import test_torch_multirank_cases as cases

    rng = np.random.default_rng(2)
    full = {"p": rng.normal(0, 0.1, (300, 64)).astype(np.float32),
            "q": rng.normal(0, 0.1, (5001, 64)).astype(np.float32),
            "user_bias": rng.normal(0, 0.1, (300, 1)).astype(np.float32),
            "item_bias": rng.normal(0, 0.1, (5001, 1)).astype(np.float32),
            "global_mean": np.float32(3.0)}
    users = rng.integers(0, 300, 77).astype(np.int32)
    with _rank_pool() as pool:
        got = pool.run(cases.kernel_topk_case, (2,), ("model",), full, 0.05, users, 20)
    for scores, ids, launches, want_s, want_i in got:
        assert launches == 1
        const = full["user_bias"][users] + full["global_mean"]
        near = np.abs(scores - (want_s + const)) <= 1e-5 + 1e-5 * np.abs(want_s + const)
        assert near.all()
        assert ((ids == want_i) | near).all() and (ids == want_i).mean() > 0.99


# -- the batch-order row scatter ------------------------------------------------

@pytest.mark.parametrize("rows,span,k", [(1, 5, 4), (5000, 3, 33), (1 << 16, 1000, 128),
                                         (20000, 40, 1), (4099, 100000, 130), (3000, 64, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rows_kernel_equals_cpu_index_add(cuda, rows, span, k, dtype):
    """The kernel adds repeats in batch order: bitwise the CPU's
    ``index_add_`` on the same inputs (a power law on the indices, updates
    over seven decades), one launch, for tables, a bias column (a strided
    vector) and the ``keep`` filter."""
    rng = np.random.default_rng(rows + k)
    table = torch.tensor(rng.normal(size=(span, k)).astype(np.float32)).to(dtype)
    idx = torch.tensor((span * rng.random(rows) ** 3).astype(np.int64))
    upd = torch.tensor((rng.normal(size=(rows, k)) * 10.0 ** rng.integers(-3, 4, (rows, 1)))
                       .astype(np.float32)).to(dtype)
    want = table.clone().index_add_(0, idx, upd)
    before = scatter.launches
    got = scatter.add_rows(table.to(cuda), idx.to(cuda), upd.to(cuda))
    assert scatter.launches == before + 1
    assert torch.equal(got.cpu(), want)
    col = table.clone()
    col_want = table.clone()
    col_want[:, 0].index_add_(0, idx, upd[:, 0])
    col_gpu = col.to(cuda)
    scatter.add_rows(col_gpu[:, 0], idx.to(cuda), upd[:, 0].to(cuda))
    assert torch.equal(col_gpu.cpu(), col_want)
    col_gpu = col.to(cuda)
    scatter.add_rows_in_passes(col_gpu[:, 0], idx.to(cuda), upd[:, 0].to(cuda))
    assert torch.equal(col_gpu.cpu(), col_want)
    keep = torch.tensor(rng.random(rows) < 0.5)
    kept = table.clone().index_add_(0, idx[keep], upd[keep])
    got = scatter.add_rows(table.to(cuda), idx.to(cuda), upd.to(cuda), keep=keep.to(cuda))
    assert torch.equal(got.cpu(), kept)
    passes = scatter.add_rows_in_passes(table.to(cuda), idx.to(cuda), upd.to(cuda))
    assert torch.equal(passes.cpu(), want)


def test_add_rows_raises_on_misuse(cuda):
    table = torch.zeros(4, 3, device=cuda)
    idx = torch.zeros(2, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError):
        scatter.add_rows(table, idx, torch.zeros(2, 3, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        scatter.add_rows(table, idx.cpu(), torch.zeros(2, 3, device=cuda))


@pytest.mark.parametrize("opt_name,fused", [("sgd", True), ("adagrad", False)])
def test_train_step_on_cuda_is_reproducible(cuda, opt_name, fused):
    """Two steps from one state, with many repeated items, give the same
    bits: every scatter adds in batch order."""
    m, n, k, b = 3000, 50, 128, 1 << 15
    g = torch.Generator().manual_seed(5)
    base = mf.init_params(g, m, n, k, variant="bias", global_mean=3.0, device="cpu")
    rng = np.random.default_rng(6)
    batch = {"user": torch.tensor(rng.integers(0, m, b), device=cuda),
             "item": torch.tensor((n * rng.random(b) ** 2).astype(np.int64), device=cuda),
             "rating": torch.tensor(rng.integers(1, 6, b).astype(np.float32), device=cuda)}
    opt = RowOptimizer(opt_name)
    out = []
    for _ in range(2):
        params = mf.MFParams(*(None if v is None else v.to(cuda) for v in base))
        state = mf.init_opt_state(params, opt)
        t = torch.tensor(0.05, device=cuda)
        mf.train_step(params, state, batch, t, t, 0.05, torch.ones(k, device=cuda), opt=opt,
                      lam=0.02, use_fused_kernel=fused)
        out.append(params)
    for a, c in zip(*out):
        if a is not None:
            assert torch.equal(a, c)


@pytest.mark.parametrize("t_v", [0.0, 0.01])
def test_recsys_retrievals_launch_pruned_matmul_at_k10_and_k50(cuda, t_v):
    """``fm_retrieval`` (k = 10) and ``sasrec_retrieval`` (k = 50), widths
    off a multiple of 4 (the kernel's 4-byte copies), through the kernel
    against the dense route of rank-masked rows at 1e-5."""
    from repro_torch.models import recsys

    fm_cfg = recsys.FMConfig(n_fields=6, embed_dim=10, vocab_per_field=3000)
    params = recsys.init_fm_params(torch.Generator(device=cuda).manual_seed(0), fm_cfg, cuda)
    params["w"].normal_(0, 0.05)
    rng = np.random.default_rng(7)
    users = torch.tensor(rng.integers(0, 3000, (33, 5)), device=cuda)
    cands = torch.tensor(rng.integers(0, 3000, 5001), device=cuda)
    before = pruned_matmul.launches
    got = recsys.fm_retrieval(params, users, cands, fm_cfg, t_v, use_kernel=True)
    assert pruned_matmul.launches == before + 1
    want = recsys.fm_retrieval(params, users, cands, fm_cfg, t_v, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    sr_cfg = recsys.SASRecConfig(n_items=4000, embed_dim=50, n_blocks=2, n_heads=1, seq_len=20)
    params = recsys.init_sasrec_params(torch.Generator(device=cuda).manual_seed(1), sr_cfg, cuda)
    seq = torch.tensor(rng.integers(0, 4001, (65, 20)), device=cuda)
    for cand_ids in (None, torch.tensor(rng.integers(0, 4001, 777), device=cuda)):
        before = pruned_matmul.launches
        got = recsys.sasrec_retrieval(params, seq, sr_cfg, t_v, use_kernel=True, cand_ids=cand_ids)
        assert pruned_matmul.launches == before + 1
        want = recsys.sasrec_retrieval(params, seq, sr_cfg, t_v, use_kernel=False,
                                       cand_ids=cand_ids)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
