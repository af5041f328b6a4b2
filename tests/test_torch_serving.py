"""The port's serving path (``repro_torch.serving``, ``mf.predict_all_items``,
checkpoint reading, the launcher) held against the JAX reference on the CPU,
with the factors carried across by ``params_from_numpy``."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import mf as jmf
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint.checkpoint import CorruptCheckpointError, load_raw
from repro_torch.core import mf
from repro_torch.serving import MicroBatcher, RequestQueue, ServingEngine
from repro_torch.serving.engine import load_mf_checkpoint

REPO = Path(__file__).resolve().parents[1]


def _carry(jparams):
    """Reference MFParams -> the port's, on the CPU."""
    fields = {k: None if v is None else np.asarray(v) for k, v in jparams._asdict().items()}
    return mf.params_from_numpy(fields, device="cpu")


def _grid_params(m, n, k, seed=0, variant="bias"):
    """1/8-grid factors (exact arithmetic: results independent of batch
    shape and summation order) with duplicated items for exact ties."""
    rng = np.random.default_rng(seed)
    g = lambda *s: (rng.integers(-8, 9, s) / 8.0).astype(np.float32)  # noqa: E731
    q = g(n, k)
    q[rng.integers(0, n, n // 2)] = q[rng.integers(0, n, n // 2)]
    bias = variant == "bias"
    return mf.params_from_numpy({
        "p": g(m, k), "q": q,
        "user_bias": g(m, 1) if bias else None,
        "item_bias": g(n, 1) if bias else None,
        "global_mean": np.float32(3.0) if bias else None,
    }, device="cpu")


@pytest.mark.parametrize("variant", ["funk", "bias", "svdpp"])
def test_engine_matches_reference_engine(variant):
    m, n, k = 80, 1200, 16
    rng = np.random.default_rng(4)
    jparams = jmf.init_params(jax.random.PRNGKey(0), m, n, k, variant=variant, global_mean=3.1)
    if variant != "funk":  # non-zero biases so they matter
        jparams = jparams._replace(
            user_bias=jnp.asarray(rng.normal(0, 0.2, (m, 1)), jnp.float32),
            item_bias=jnp.asarray(rng.normal(0, 0.2, (n, 1)), jnp.float32),
        )
    hist = rng.integers(0, n, (m, 6)).astype(np.int32) if variant == "svdpp" else None
    t = 0.04
    want = JServingEngine(jparams, t, t, use_kernel=False, max_batch=32, block_n=256,
                          user_history=hist)
    got = ServingEngine(_carry(jparams), t, t, device="cpu", max_batch=32, block_n=256,
                        user_history=hist)
    users = rng.integers(0, m, 41).astype(np.int32)  # odd size: pad + chunk
    want_s, want_i = want.topk(users, 7)
    got_s, got_i = got.topk(users, 7)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
    rec = got.recommend(users[:2], 3)
    assert [r["item"] for r in rec[1]] == got_i[1, :3].tolist()
    if variant == "svdpp":  # second pass is served from the hot-user LRU
        again_s, again_i = got.topk(users, 7)
        assert got.vector_cache.hits > 0
        np.testing.assert_array_equal(again_i, got_i)
        np.testing.assert_array_equal(again_s, got_s)


@pytest.mark.parametrize("variant", ["funk", "bias", "svdpp"])
@pytest.mark.parametrize("t", [0.0, 0.05])
def test_predict_all_items_matches_reference(variant, t):
    m, n, k = 30, 90, 12
    rng = np.random.default_rng(2)
    jparams = jmf.init_params(jax.random.PRNGKey(1), m, n, k, variant=variant, global_mean=2.5)
    users = rng.integers(0, m, 9)
    hist = rng.integers(0, n + 1, (9, 4)) if variant == "svdpp" else None
    want = jmf.predict_all_items(
        jparams, jnp.asarray(users), t, t, use_kernel=True, interpret=True,
        hist=None if hist is None else jnp.asarray(hist))
    got = mf.predict_all_items(
        _carry(jparams), torch.as_tensor(users), t, t,
        hist=None if hist is None else torch.as_tensor(hist), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    pred, pr = mf.predict_pairs(_carry(jparams), torch.as_tensor(users),
                                torch.as_tensor(users % n), t, t)
    jpred, jpr = jmf.predict_pairs(jparams, jnp.asarray(users), jnp.asarray(users % n), t, t)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jpr))


def test_entry_points_refuse_cpu_without_device(monkeypatch):
    """Without a card and without device="cpu", every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = _grid_params(4, 10, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServingEngine(params)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mf.predict_all_items(params, torch.arange(2))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mf.params_from_numpy({"p": np.zeros((2, 2)), "q": np.zeros((2, 2))})


def test_engine_validates_requests():
    engine = ServingEngine(_grid_params(5, 20, 4), device="cpu")
    for bad_ids in ([5], [-1], [0, 7]):
        with pytest.raises(ValueError, match="unknown user ids"):
            engine.topk(bad_ids, 3)
    for bad_k in (0, 21):
        with pytest.raises(ValueError, match="topk"):
            engine.topk([0], bad_k)
    s, i = engine.topk([], 3)
    assert s.shape == (0, 3) and i.shape == (0, 3)
    # any topk <= n, wider than a kernel tile or the old 1024 ceiling
    wide = ServingEngine(_grid_params(2, 1032, 2), device="cpu")
    s, i = wide.topk([1], 1032)
    assert sorted(i[0].tolist()) == list(range(1032))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_engine_topk_limit_is_the_catalog_on_every_device(device):
    """The engine takes any topk <= n_items on CUDA as on the CPU (the
    kernel has no ceiling of its own)."""
    from types import SimpleNamespace

    # the request-id domain is the snapshot's num_external (num_users
    # without an eviction remap)
    snap = SimpleNamespace(n_items=5000, num_users=3, num_external=3, device=torch.device(device))
    ids = ServingEngine._validate_for(snap, [0, 2], 5000)
    assert ids.tolist() == [0, 2]
    with pytest.raises(ValueError, match=r"topk must be in \[1, 5000\]"):
        ServingEngine._validate_for(snap, [0], 5001)


def _write_reference_checkpoint(directory, jparams, t_p, t_q):
    tree = {"params": jparams, "t_p": jnp.float32(t_p), "t_q": jnp.float32(t_q)}
    return jckpt.save(str(directory), 3, tree, metadata={"epoch": 1})


@pytest.mark.parametrize("variant", ["funk", "bias"])
def test_checkpoint_written_by_reference_serves_the_same(tmp_path, variant):
    jparams = jmf.init_params(jax.random.PRNGKey(3), 50, 300, 8, variant=variant, global_mean=3.0)
    _write_reference_checkpoint(tmp_path, jparams, 0.03, 0.05)
    want = JServingEngine.from_checkpoint(str(tmp_path), use_kernel=False)
    got = ServingEngine.from_checkpoint(str(tmp_path), device="cpu")
    assert float(got.t_p) == np.float32(0.03) and float(got.t_q) == np.float32(0.05)
    users = np.arange(0, 50, 3)
    want_s, want_i = want.topk(users, 6)
    got_s, got_i = got.topk(users, 6)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
    params, _, _, _, meta = load_mf_checkpoint(str(tmp_path), device="cpu")
    assert meta["step"] == 3 and meta["epoch"] == 1
    np.testing.assert_array_equal(params.q.numpy(), np.asarray(jparams.q))


def test_corrupt_checkpoint_raises(tmp_path):
    jparams = jmf.init_params(jax.random.PRNGKey(3), 10, 20, 4)
    path = _write_reference_checkpoint(tmp_path, jparams, 0.0, 0.0)
    npz = Path(os.path.realpath(path)) / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    with pytest.raises(CorruptCheckpointError):
        load_raw(str(tmp_path))
    with pytest.raises(CorruptCheckpointError):
        ServingEngine.from_checkpoint(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_raw(str(tmp_path / "missing"))


def test_queue_rows_are_byte_identical_to_topk():
    engine = ServingEngine(_grid_params(60, 400, 8), 1 / 8, 1 / 8, device="cpu",
                           max_batch=16, block_n=64)
    users = np.random.default_rng(1).integers(0, 60, 40)
    queue = RequestQueue(engine, start=False, max_batch=16)
    futures = [queue.submit(int(u), 9) for u in users]
    while queue.drain_once():
        pass
    want_s, want_i = engine.topk(users, 9)
    for row, fut in enumerate(futures):
        s, i = fut.result(timeout=0)
        assert s.tobytes() == want_s[row].tobytes()
        assert i.tobytes() == want_i[row].tobytes()
    assert queue.requests_served == len(users) and queue.batches_served >= 3
    # the threaded frontend gives the same bytes
    threaded = [engine.submit(int(u), 9) for u in users[:12]]
    for row, fut in enumerate(threaded):
        s, i = fut.result(timeout=30)
        assert s.tobytes() == want_s[row].tobytes() and i.tobytes() == want_i[row].tobytes()
    engine.stop()
    assert engine.queue_depth == 0
    batcher = MicroBatcher(engine, topk=9)
    tickets = [batcher.submit(int(u)) for u in users[:5]]
    out = batcher.drain()
    for row, ticket in enumerate(tickets):
        assert out[ticket][1].tobytes() == want_i[row].tobytes()


def test_serve_cli_runs_on_cpu(tmp_path):
    jparams = jmf.init_params(jax.random.PRNGKey(5), 40, 200, 8, variant="bias", global_mean=3.0)
    _write_reference_checkpoint(tmp_path, jparams, 0.02, 0.02)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--ckpt", str(tmp_path), "--users", "0", "3", "--topk", "5",
         "--batched-requests", "64", "--concurrent", "16", "--clients", "4"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "batched: 64 requests" in out.stdout
    assert "concurrent: 16 requests" in out.stdout


def test_port_imports_neither_jax_nor_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "repro"
                     or m.startswith("repro."))
        assert not bad, bad
        assert len(names) >= 15, names
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
