"""The port's hot swap, eviction remap, spilled-user fallback and
``compact_latent`` (``repro_torch.serving.ServingEngine``) held against a
fresh engine on the new params and against the JAX reference engine, on the
CPU, from the same numpy inputs.  A swap's results must equal a fresh
engine's bit for bit, in both packages; the port's ids equal the
reference's, its scores within 1e-5 (bitwise on 1/8-grid factors).  The
remap tables are built by hand."""
import sys
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import mf as jmf
from repro.serving import ServingEngine as JServingEngine
from repro_torch.core import mf
from repro_torch.serving import ServingEngine


def _fields(m=40, n=600, k=16, variant="bias", seed=0):
    """Random factors as numpy, the way the reference's init draws them
    (normal, scale 0.1), with non-zero biases."""
    rng = np.random.default_rng(seed)
    out = {"p": rng.normal(0, 0.1, (m, k)).astype(np.float32),
           "q": rng.normal(0, 0.1, (n, k)).astype(np.float32),
           "user_bias": None, "item_bias": None, "global_mean": None, "implicit": None}
    if variant in ("bias", "svdpp"):
        out.update(user_bias=rng.normal(0, 0.2, (m, 1)).astype(np.float32),
                   item_bias=rng.normal(0, 0.2, (n, 1)).astype(np.float32),
                   global_mean=np.float32(3.0))
    if variant == "svdpp":
        y = rng.normal(0, 0.1, (n + 1, k)).astype(np.float32)
        y[n] = 0.0
        out["implicit"] = y
    return out


def _perturb(fields, items, users, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    out = dict(fields)
    out["q"] = fields["q"].copy()
    out["q"][items] += rng.normal(0, scale, (len(items), fields["q"].shape[1])).astype(np.float32)
    out["p"] = fields["p"].copy()
    out["p"][users] += rng.normal(0, scale, (len(users), fields["p"].shape[1])).astype(np.float32)
    return out


def _port(fields):
    return mf.params_from_numpy(fields, device="cpu")


def _ref(fields):
    return jmf.MFParams(*(None if fields[f] is None else jnp.asarray(fields[f])
                          for f in jmf.MFParams._fields))


class _Pair:
    """The same engine in both packages."""

    def __init__(self, fields, t_p=0.0, t_q=0.0, **kw):
        self.kw = kw
        self.port = ServingEngine(_port(fields), t_p, t_q, device="cpu", **kw)
        self.ref = JServingEngine(_ref(fields), t_p, t_q, use_kernel=False, **kw)

    def topk(self, users, topk):
        return self.port.topk(users, topk), self.ref.topk(users, topk)

    def swap(self, fields, *args, **kw):
        v = self.port.swap(_port(fields), *args, **kw)
        assert self.ref.swap(_ref(fields), *args, **kw) == v
        return v


def _assert_equal(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs, ws)


def _assert_matches_fresh(pair, fields, users, topk, t_p=0.0, t_q=0.0, **kw):
    """Both swapped engines serve exactly what a fresh one of their own
    package serves, and the two packages agree."""
    got_port, got_ref = pair.topk(users, topk)
    fresh = _Pair(fields, t_p, t_q, **{**pair.kw, **kw})
    want_port, want_ref = fresh.topk(users, topk)
    _assert_equal(got_port, want_port)
    _assert_equal(got_ref, want_ref)
    np.testing.assert_array_equal(got_port[1], got_ref[1])
    np.testing.assert_allclose(got_port[0], got_ref[0], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# swap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["funk", "bias"])
def test_swap_touched_rows_matches_fresh_engine(variant):
    fields = _fields(variant=variant)
    pair = _Pair(fields, 0.03, 0.03, block_n=128)
    users = np.arange(25)
    pair.topk(users, 5)  # build the layouts the swap patches
    touched_i, touched_u = np.asarray([0, 5, 128, 129, 599]), np.asarray([3, 9])
    new = _perturb(fields, touched_i, touched_u)
    if variant == "bias":
        new["item_bias"] = fields["item_bias"].copy()
        new["item_bias"][touched_i] += 0.5
        new["user_bias"] = fields["user_bias"].copy()
        new["user_bias"][touched_u] -= 0.5
    assert pair.swap(new, touched_users=touched_u, touched_items=touched_i) == 1
    assert pair.port.version == 1
    _assert_matches_fresh(pair, new, users, 5, 0.03, 0.03)


@pytest.mark.parametrize("variant", ["funk", "bias"])
def test_swap_repeated_unsorted_touched_ids(variant):
    """Touched ids may repeat and come in any order: the patch rewrites a
    repeated row with the same values."""
    fields = _fields(variant=variant)
    pair = _Pair(fields, 0.03, 0.03, block_n=128)
    users = np.arange(25)
    pair.topk(users, 5)
    touched_i = np.asarray([599, 5, 0, 5, 128, 129, 0, 599])
    new = _perturb(fields, np.unique(touched_i), [3])
    if variant == "bias":
        new["item_bias"] = fields["item_bias"].copy()
        new["item_bias"][touched_i] += 0.5
    pair.swap(new, touched_users=[3], touched_items=touched_i)
    _assert_matches_fresh(pair, new, users, 5, 0.03, 0.03)


def test_swap_never_writes_into_the_previous_snapshot():
    """The previous snapshot's ranks, biases and tiles keep their values:
    a batch still holding it finishes on its own version."""
    fields = _fields()
    engine = ServingEngine(_port(fields), 0.03, 0.03, device="cpu", block_n=128)
    engine.topk(np.arange(8), 5)
    prev = engine._snap
    before = [t.clone() for t in (prev.r_i, prev.item_bias_vec, *prev.stream_layout()[:2])]
    touched = np.asarray([1, 2, 300])
    new = _perturb(fields, touched, [0], scale=0.5)
    new["item_bias"] = fields["item_bias"] + 1.0
    engine.swap(_port(new), touched_users=[0], touched_items=touched)
    after = (prev.r_i, prev.item_bias_vec, *prev.stream_layout()[:2])
    for b, a in zip(before, after):
        assert torch.equal(b, a)
    assert not torch.equal(engine._snap.stream_layout()[0], before[2])


def test_swap_threshold_change_rebuilds():
    fields = _fields()
    pair = _Pair(fields, 0.03, 0.03, block_n=128)
    pair.topk([0, 1], 5)
    pair.swap(fields, 0.03, 0.06, touched_users=[], touched_items=[])
    _assert_matches_fresh(pair, fields, np.arange(20), 5, 0.03, 0.06)


def test_swap_growth_and_shrink_rejected():
    small = _fields(m=10, n=50, k=8)
    pair = _Pair(small, block_n=32)
    pair.topk([0], 5)
    grown = _fields(m=14, n=60, k=8, seed=1)
    pair.swap(grown, touched_users=None, touched_items=None)
    assert pair.port.num_users == 14 and pair.port.n_items == 60
    _assert_matches_fresh(pair, grown, np.asarray([13, 0, 7]), 5)
    for engine, params in ((pair.port, _port(small)), (pair.ref, _ref(small))):
        with pytest.raises(ValueError, match="shrink"):
            engine.swap(params)


def test_swap_versions_are_deterministic_per_batch():
    """A batch that captured version 0 finishes on it although a swap lands
    while it is being scored; the next batch serves version 1."""
    fields = _fields()
    new = _perturb(fields, np.arange(600), np.arange(40), scale=0.2)
    engine = ServingEngine(_port(fields), device="cpu", max_batch=8, block_n=128)
    users = np.arange(32)
    want0 = ServingEngine(_port(fields), device="cpu", max_batch=8, block_n=128).topk(users, 6)
    want1 = ServingEngine(_port(new), device="cpu", max_batch=8, block_n=128).topk(users, 6)
    assert not np.array_equal(want0[1], want1[1])

    first_chunk, swapped = threading.Event(), threading.Event()
    score = engine._topk_block

    def slow_block(snap, pu, topk):
        first_chunk.set()
        assert swapped.wait(60)
        return score(snap, pu, topk)

    engine._topk_block = slow_block
    result = {}
    worker = threading.Thread(target=lambda: result.update(out=engine.topk(users, 6)))
    worker.start()
    assert first_chunk.wait(60)
    engine.swap(_port(new), touched_users=None, touched_items=None)
    swapped.set()
    worker.join(60)
    assert not worker.is_alive()
    del engine._topk_block
    _assert_equal(result["out"], want0)  # four chunks, all on version 0
    _assert_equal(engine.topk(users, 6), want1)


def test_swaps_under_concurrent_load_drop_nothing():
    """Swaps while client threads submit through the queue: every request
    completes, each row equal to one version's row."""
    versions = [_fields(m=48, n=800)]
    for s in range(3):
        versions.append(_perturb(versions[-1], np.arange(s, 800, 7), np.arange(s, 48, 5), seed=s))
    rows = [ServingEngine(_port(f), 0.03, 0.03, device="cpu", block_n=128).topk(np.arange(48), 5)
            for f in versions]
    engine = ServingEngine(_port(versions[0]), 0.03, 0.03, device="cpu", block_n=128)
    engine.start(linger_ms=1.0)
    stop, lock = threading.Event(), threading.Lock()
    failures, completed = [], [0]

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            user = int(rng.integers(0, 48))
            try:
                s, i = engine.submit(user, 5, timeout=60).result(timeout=120)
                assert any(np.array_equal(i, r[1][user]) and np.array_equal(s, r[0][user])
                           for r in rows)
                with lock:
                    completed[0] += 1
            except Exception as exc:  # noqa: BLE001
                with lock:
                    failures.append(repr(exc))

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    for t in threads:
        t.start()
    try:
        for f in versions[1:]:
            engine.swap(_port(f), touched_users=None, touched_items=None)
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        engine.stop()
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert engine.version == 3
    assert not failures, failures[:5]
    assert completed[0] > 0


def test_swap_touched_only_lru_invalidation_svdpp():
    """Untouched users keep their cached vectors; touched users and users
    whose history holds a touched implicit row are dropped; results match a
    fresh engine, in both packages."""
    m, n, k = 20, 60, 8
    fields = _fields(m, n, k, variant="svdpp")
    hist = np.random.default_rng(0).integers(0, n, (m, 4)).astype(np.int32)
    hist[7] = [50, 51, 52, 53]     # user 7's history holds touched item 50
    hist[5] = [10, 11, 12, 13]     # user 5's avoids the touched rows
    pair = _Pair(fields, block_n=32, user_history=hist)
    pair.topk([3, 5, 7], 5)
    assert len(pair.port.vector_cache) == 3
    touched_u, touched_i = [3], [50]
    new = _perturb(fields, np.asarray(touched_i), np.asarray(touched_u))
    new["implicit"] = fields["implicit"].copy()
    new["implicit"][50] += 0.3
    pair.swap(new, touched_users=touched_u, touched_items=touched_i,
              touched_implicit_items=touched_i)
    for engine in (pair.port, pair.ref):
        assert engine.vector_cache.get(5) is not None
        assert engine.vector_cache.get(3) is None
        assert engine.vector_cache.get(7) is None
    _assert_matches_fresh(pair, new, np.asarray([3, 5, 7]), 5)


def test_swap_accepts_one_shot_iterators():
    fields = _fields()
    pair = _Pair(fields, 0.03, 0.03, block_n=128)
    users = np.arange(25)
    pair.topk(users, 5)
    new = _perturb(fields, np.asarray([0, 5, 599]), np.asarray([3, 9]))
    for engine, params in ((pair.port, _port(new)), (pair.ref, _ref(new))):
        engine.swap(params, touched_users=iter([3, 9]), touched_items=iter([0, 5, 599]))
    _assert_matches_fresh(pair, new, users, 5, 0.03, 0.03)


# ---------------------------------------------------------------------------
# eviction remap and the spilled-user fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["funk", "bias"])
def test_fallback_for_evicted_ids(variant):
    fields = _fields(m=30, n=200, k=8, variant=variant)
    remap = np.arange(30, dtype=np.int32)
    remap[[4, 11, 29]] = -1                  # spilled users
    pair = _Pair(fields, 0.02, 0.02, block_n=64, user_remap=remap, remap_epoch=1)
    users = np.asarray([4, 0, 11, 5, 29, 4])
    (ps, pi), (rs, ri) = pair.topk(users, 9)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(ps, rs, rtol=1e-5, atol=1e-5)
    for engine in (pair.port, pair.ref):
        fs, fi = engine._snap.fallback_topk(9)
        got_s, got_i = engine.topk(users, 9)
        for row in (0, 2, 4, 5):
            np.testing.assert_array_equal(got_i[row], fi)
            np.testing.assert_array_equal(got_s[row], fs)
    np.testing.assert_array_equal(pair.port._snap.fallback_topk(9)[1],
                                  np.asarray(pair.ref._snap.fallback_topk(9)[1]))
    np.testing.assert_array_equal(pair.port._snap.fallback_topk(9)[0],
                                  np.asarray(pair.ref._snap.fallback_topk(9)[0]))
    if variant == "funk":  # all-zero scores: items 0..topk-1
        np.testing.assert_array_equal(pair.port._snap.fallback_topk(9)[1], np.arange(9))
    # resident users serve their physical rows, as an engine without a remap
    plain = ServingEngine(_port(fields), 0.02, 0.02, device="cpu", block_n=64)
    _assert_equal(pair.port.topk([0, 5], 9), plain.topk([0, 5], 9))
    # the queue goes through the same translation
    s, i = pair.port.submit(11, 9).result(timeout=60)
    pair.port.stop()
    np.testing.assert_array_equal(i, pair.port._snap.fallback_topk(9)[1])
    with pytest.raises(ValueError, match="unknown user"):
        pair.port.topk([30], 3)


def test_patch_swap_fallback_reads_the_new_item_biases():
    """After a touched-rows swap the item biases are the new params' whole
    vector, as in the reference, even where a bias moved outside the
    touched rows: the fallback ranking and the kernel operands read it."""
    fields = _fields(m=30, n=200, k=8, variant="bias")
    remap = np.arange(30, dtype=np.int32)
    remap[[4, 11]] = -1
    pair = _Pair(fields, 0.02, 0.02, block_n=64, user_remap=remap, remap_epoch=1)
    pair.topk([4, 0], 9)
    new = dict(fields)
    new["item_bias"] = fields["item_bias"][::-1].copy()  # every bias moves
    pair.swap(new, touched_users=[], touched_items=[3])
    port_fb, ref_fb = pair.port._snap.fallback_topk(9), pair.ref._snap.fallback_topk(9)
    np.testing.assert_array_equal(port_fb[1], np.asarray(ref_fb[1]))
    np.testing.assert_array_equal(port_fb[0], np.asarray(ref_fb[0]))
    want = np.argsort(-(new["item_bias"][:, 0] + new["global_mean"]), kind="stable")[:9]
    np.testing.assert_array_equal(port_fb[1], want)
    assert torch.equal(pair.port._snap.kernel_layout()[2],
                       torch.as_tensor(new["item_bias"][:, 0]))
    (ps, pi), (rs, ri) = pair.topk([4, 11, 0], 9)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(ps, rs, rtol=1e-5, atol=1e-5)


def test_swap_remap_epoch_bump_may_shrink():
    """A compaction (remap_epoch bump) renumbers the physical rows and may
    shrink the user table; external ids keep serving through the new remap
    and the result equals a fresh engine's with that remap."""
    fields = _fields(m=30, n=200, k=8)
    pair = _Pair(fields, 0.02, 0.02, block_n=64, cache_size=16)
    pair.topk(np.arange(30), 5)
    keep = np.asarray([2, 3, 5, 7, 11, 13, 17, 19, 23, 29])  # rows that stay resident
    compact = dict(fields, p=fields["p"][keep], user_bias=fields["user_bias"][keep])
    remap = np.full(30, -1, np.int32)
    remap[keep] = np.arange(keep.size, dtype=np.int32)
    for engine, params in ((pair.port, _port(compact)), (pair.ref, _ref(compact))):
        with pytest.raises(ValueError, match="user_remap"):
            engine.swap(params, remap_epoch=1)
    pair.swap(compact, user_remap=remap, remap_epoch=1, touched_users=[0], touched_items=[1])
    assert pair.port.remap_epoch == 1 and pair.port.num_external == 30
    assert pair.port.num_users == keep.size
    users = np.arange(30)
    _assert_matches_fresh(pair, compact, users, 5, 0.02, 0.02, user_remap=remap, remap_epoch=1)
    # omitting both remap arguments carries the remap forward
    pair.swap(compact, touched_users=[], touched_items=[])
    assert pair.port.remap_epoch == 1
    _assert_matches_fresh(pair, compact, users, 5, 0.02, 0.02, user_remap=remap, remap_epoch=1)


# ---------------------------------------------------------------------------
# compact_latent
# ---------------------------------------------------------------------------


def _live_grid(m, n, k, live, seed=0):
    """1/8-grid factors with items zero past ``live`` columns, so the
    compacted width is bounded by construction."""
    rng = np.random.default_rng(seed)
    p = (rng.integers(-16, 17, (m, k)) / 8.0).astype(np.float32)
    q = np.zeros((n, k), np.float32)
    q[:, :live] = (rng.integers(1, 17, (n, live)) / 8.0) * rng.choice([-1.0, 1.0], (n, live))
    return {"p": p, "q": q.astype(np.float32), "user_bias": None, "item_bias": None,
            "global_mean": None, "implicit": None}


def test_compact_latent_bitwise_equal_and_truncates():
    fields, t = _live_grid(20, 500, 32, 12, seed=3), 0.05
    plain = _Pair(fields, t, t, block_n=128)
    compact = _Pair(fields, t, t, block_n=128, compact_latent=True)
    users = np.arange(20)
    (p0, r0), (p1, r1) = plain.topk(users, 5), compact.topk(users, 5)
    _assert_equal(p1, p0)
    _assert_equal(r1, r0)
    _assert_equal(p0, r0)
    assert compact.port._snap.stream_layout()[0].shape[2] == 16   # round8(12), from 32
    assert plain.port._snap.stream_layout()[0].shape[2] == 32


def test_compact_latent_disabled_at_threshold_zero():
    fields = _live_grid(16, 300, 24, 24, seed=4)
    compact = ServingEngine(_port(fields), 0.0, 0.0, device="cpu", block_n=64,
                            compact_latent=True)
    assert compact._snap.stream_layout()[0].shape[2] == 24
    want = JServingEngine(_ref(fields), 0.0, 0.0, use_kernel=False, block_n=64).topk(
        np.arange(16), 5)
    _assert_equal(compact.topk(np.arange(16), 5), want)


@pytest.mark.parametrize("grow", [True, False])
def test_compact_swap_rebuilds_or_patches(grow):
    """A touched row whose rank outgrows the compacted width forces a full
    rebuild at the wider width; one that fits keeps the patch; either way
    the result equals a fresh engine's, in both packages."""
    fields, t = _live_grid(20, 500, 32, 12, seed=5 if grow else 6), 0.05
    pair = _Pair(fields, t, t, block_n=128, compact_latent=True)
    pair.topk(np.arange(4), 5)
    new = dict(fields, q=fields["q"].copy())
    if grow:
        new["q"][7] = (np.arange(32) % 8 + 1) / 8.0     # rank 32 > width 16
    else:
        new["q"][3, :10] = (np.arange(10) % 8 + 1) / 8.0  # rank 10 <= width 16
    pair.swap(new, t, t, touched_users=np.array([0]), touched_items=np.array([7 if grow else 3]))
    for engine in (pair.port, pair.ref):
        assert engine._snap.stream_layout()[0].shape[2] == (32 if grow else 16)
    _assert_matches_fresh(pair, new, np.arange(20), 5, t, t, compact_latent=False)
