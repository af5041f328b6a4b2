"""The port's out-of-core training path held against the JAX reference on the
CPU: ``FeistelPermutation``, the store files, ``RatingsStore``,
``ShardedRatingsLoader``'s slabs, the store-mode trainer (parity, mid-epoch
resume within the port and across the two packages) and
``launch/train --store-dir``.

Tolerances: bitwise for permutations, store files, gathered rows, slabs and
a killed-then-resumed port run against its own uninterrupted run; the
store-mode trainers of the two packages (the same store, initial factors
and Feistel batch order) to identical permutations, thresholds within 1e-6
relative and epoch records within 1e-4 relative, as
``test_torch_training.py`` holds the in-memory trainers.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro.core import trainer as jtrainer
from repro.data import ratings as jratings
from repro.store import ratings_store as jstore
from repro_torch.core import mf, trainer
from repro_torch.data.ratings import RatingsDataset
from repro_torch.launch import train as train_launch
from repro_torch.store import ratings_store as store


def _ds(n_ratings=2048, users=150, items=80, seed=0):
    return jratings.synthetic_ratings(users, items, n_ratings, seed=seed)


def _port_ds(ds):
    return RatingsDataset(ds.user, ds.item, ds.rating, ds.num_users, ds.num_items,
                          ds.rating_min, ds.rating_max)


def _np(x):
    return None if x is None else np.asarray(x)


def _relclose(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(b), 1e-12)


# ---------------------------------------------------------------------------
# Feistel permutation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 5, 64, 1000, 1024, 1025])
@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 7), (3, 1)])
def test_feistel_matches_reference_bitwise(n, seed, epoch):
    got = store.FeistelPermutation(n, seed, epoch)(np.arange(n))
    want = jstore.FeistelPermutation(n, seed, epoch)(np.arange(n))
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("n,start,count", [
    (1337, 0, 10), (1337, 100, 257), (1337, 1332, 5),
    ((1 << 32) + 17, (1 << 32) - 3000, 4000),   # past 2^32: 34-bit domain, cycle walks
])
def test_permuted_indices_match_reference(n, start, count):
    got = store.permuted_indices(n, 11, 4, start, count)
    np.testing.assert_array_equal(got, jstore.permuted_indices(n, 11, 4, start, count))
    assert got.min() >= 0 and got.max() < n and np.unique(got).size == count
    if n < 1 << 20:
        full = store.FeistelPermutation(n, 11, 4)(np.arange(n))
        np.testing.assert_array_equal(got, full[start:start + count])


# ---------------------------------------------------------------------------
# the columnar store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard_rows", [300, 1 << 20])
def test_build_store_writes_the_reference_bytes(tmp_path, shard_rows):
    ds = _ds()
    ref_dir = jstore.build_store(ds, str(tmp_path / "ref"), shard_rows=shard_rows)
    port_dir = store.build_store(_port_ds(ds), str(tmp_path / "port"), shard_rows=shard_rows)
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir))
    assert "index.json" in names and len(names) == 1 + -(-len(ds) // shard_rows)
    for name in names:
        with open(os.path.join(ref_dir, name), "rb") as a, open(os.path.join(port_dir, name),
                                                               "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_store_reads_the_others(tmp_path, writer):
    ds = _ds()
    build = jstore.build_store if writer == "ref" else store.build_store
    directory = build(ds if writer == "ref" else _port_ds(ds), str(tmp_path / "s"),
                      shard_rows=257)
    got, want = store.RatingsStore(directory), jstore.RatingsStore(directory)
    for field in ("num_examples", "num_users", "num_items", "rating_min", "rating_max",
                  "global_mean", "shard_rows"):
        assert getattr(got, field) == getattr(want, field), field
    idx = np.random.default_rng(0).integers(0, len(ds), 500)  # any order, duplicates
    for a, b, col in zip(got.gather(idx), want.gather(idx), (ds.user, ds.item, ds.rating)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, col[idx])
    back = got.to_dataset()
    for a, b in ((back.user, ds.user), (back.item, ds.item), (back.rating, ds.rating)):
        np.testing.assert_array_equal(a, b)
    assert [tuple(map(np.asarray, c)) for c in got.iter_shards()][0][0].shape == (257,)
    with pytest.raises(IndexError):
        got.gather(np.array([len(ds)]))


def test_corrupt_shard_is_quarantined_as_the_reference_does(tmp_path):
    ds = _ds(600, 40, 30)
    for name, module in (("ref", jstore), ("port", store)):
        directory = module.build_store(ds if name == "ref" else _port_ds(ds),
                                       str(tmp_path / name), shard_rows=256)
        path = os.path.join(directory, "shard_00001.bin")
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(path, "wb").write(bytes(blob))
        st = module.RatingsStore(directory)
        st.gather(np.arange(10))  # shard 0 is intact
        with pytest.raises(module.CorruptShardError, match="quarantined"):
            st.gather(np.array([300]))
        assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
        # with verification off the intact shard still reads
        assert module.RatingsStore(directory, verify_checksums=False).gather(
            np.arange(5))[0].shape == (5,)


def test_legacy_index_without_crc_loads_in_both(tmp_path):
    ds = _ds(600, 40, 30)
    directory = store.build_store(_port_ds(ds), str(tmp_path / "s"), shard_rows=256)
    path = os.path.join(directory, "index.json")
    index = json.load(open(path))
    for shard in index["shards"]:
        del shard["crc32"]
    json.dump(index, open(path, "w"))
    idx = np.arange(len(ds))[::-1]
    for a, b in zip(store.RatingsStore(directory).gather(idx),
                    jstore.RatingsStore(directory).gather(idx)):
        np.testing.assert_array_equal(a, b)
    index["version"] = 999
    json.dump(index, open(path, "w"))
    with pytest.raises(ValueError, match="version"):
        store.RatingsStore(directory)


# ---------------------------------------------------------------------------
# the streaming slab loader
# ---------------------------------------------------------------------------


def _port_loader(directory, batch, **kw):
    return store.ShardedRatingsLoader(store.RatingsStore(directory), batch, device="cpu", **kw)


@pytest.mark.parametrize("batch,slab_steps,prefetch", [(64, 7, 2), (32, 4, 1), (100, 50, 3)])
@pytest.mark.parametrize("seed,epoch,shuffle", [(3, 5, True), (0, 0, True), (0, 2, False)])
def test_epoch_slabs_match_the_reference_loader(tmp_path, batch, slab_steps, prefetch, seed,
                                                epoch, shuffle):
    ds = _ds()
    directory = store.build_store(_port_ds(ds), str(tmp_path / "s"), shard_rows=500)
    port = _port_loader(directory, batch, slab_steps=slab_steps, prefetch=prefetch)
    ref = jstore.ShardedRatingsLoader(jstore.RatingsStore(directory), batch,
                                      slab_steps=slab_steps, prefetch=prefetch)
    assert (port.num_steps, port.num_slabs, port.slab_steps) == (
        ref.num_steps, ref.num_slabs, ref.slab_steps)
    want = list(ref.epoch_slabs(seed, epoch, shuffle=shuffle))
    got = list(port.epoch_slabs(seed, epoch, shuffle=shuffle))
    assert [s.slab_idx for s in got] == [s.slab_idx for s in want] == list(range(ref.num_slabs))
    for g, w in zip(got, want):
        assert g.steps == w.steps
        assert g.batches["user"].dtype == g.batches["item"].dtype == torch.int64
        assert g.batches["rating"].dtype == torch.float32
        assert g.host_bytes == g.steps * port.batch_size * 12
        assert set(g.timings) == {"perm", "gather"}
        for key in ("user", "item", "rating"):
            np.testing.assert_array_equal(g.batches[key].numpy(), np.asarray(w.batches[key]))
    for start in (1, port.num_slabs - 1, port.num_slabs):  # a resume replays the tail
        tail = list(port.epoch_slabs(seed, epoch, start_slab=start, shuffle=shuffle))
        assert [s.slab_idx for s in tail] == list(range(start, port.num_slabs))
        for g, t in zip(got[start:], tail):
            for key in g.batches:
                assert torch.equal(g.batches[key], t.batches[key])


def _prefetchers():
    return sum(t.name == "ratings-prefetch" and t.is_alive() for t in threading.enumerate())


def test_loader_close_errors_and_validation(tmp_path, monkeypatch):
    ds = _ds()
    directory = store.build_store(_port_ds(ds), str(tmp_path / "s"))
    loader = _port_loader(directory, 32, slab_steps=2, prefetch=2)
    before = _prefetchers()
    gen = loader.epoch_slabs(0, 0)
    next(gen)
    gen.close()  # abandoned mid-epoch: the worker stops
    assert _prefetchers() == before

    def broken(idx, *cols):
        raise OSError("disk gone")

    monkeypatch.setattr(loader.store, "_gather_into", broken)
    with pytest.raises(OSError, match="disk gone"):  # a worker error, raised in the consumer
        list(loader.epoch_slabs(0, 0))
    assert _prefetchers() == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="start_slab"):
        list(loader.epoch_slabs(0, 0, start_slab=loader.num_slabs + 1))
    with pytest.raises(IndexError):
        loader.slab_bounds(loader.num_slabs)
    st = store.RatingsStore(directory)
    for kw, match in ((dict(batch_size=0), "batch_size"), (dict(batch_size=8, slab_steps=0),
                                                           "slab_steps"),
                      (dict(batch_size=8, prefetch=0), "prefetch")):
        with pytest.raises(ValueError, match=match):
            store.ShardedRatingsLoader(st, device="cpu", **kw)
    empty = store.build_store(_port_ds(_ds(0, 5, 5)), str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="nothing to stream"):
        store.ShardedRatingsLoader(store.RatingsStore(empty), 8, device="cpu")


# ---------------------------------------------------------------------------
# the store-mode trainer
# ---------------------------------------------------------------------------


def _store_cfg(module, store_dir, ckpt_dir=None, **kw):
    base = dict(k=6, epochs=2, batch_size=32, lr=0.05, pruning_rate=0.5, seed=0,
                store_dir=store_dir, slab_steps=4, prefetch_slabs=2, checkpoint_dir=ckpt_dir,
                checkpoint_every_epochs=1, checkpoint_every_slabs=2)
    base.update(kw)
    return module.TrainConfig(**base)


def _run_epochs(t, module, *, kill_after_scans=0):
    """Run the remaining epochs; with ``kill_after_scans`` raise
    KeyboardInterrupt at that slab scan, before it writes anything (the
    reference test's kill)."""
    calls = {"n": 0}
    original = module.mf.train_epoch_scan

    def counting(*args, **kwargs):
        calls["n"] += 1
        if kill_after_scans and calls["n"] > kill_after_scans:
            raise KeyboardInterrupt
        return original(*args, **kwargs)

    module.mf.train_epoch_scan = counting
    try:
        while t.epoch < t.config.epochs:
            t.run_epoch()
    except KeyboardInterrupt:
        pass
    finally:
        module.mf.train_epoch_scan = original
        if t._ckpt is not None:
            t._ckpt.wait()


def _port_trainer(cfg, init=None, test_ds=None):
    t = trainer.DPMFTrainer(cfg, None, test_ds, device="cpu")
    if init is not None:
        t.params = mf.params_from_numpy(init, device="cpu")
        t.opt_state = mf.init_opt_state(t.params, t.opt)
    return t


def _assert_state_equal(a, b):
    for x, y in zip(a.params, b.params):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)
    for ga, gb in zip(a.opt_state, b.opt_state):
        for key in (ga or {}):
            assert torch.equal(ga[key], gb[key]), key


def test_store_trainer_killed_and_resumed_is_bitwise(tmp_path):
    ds = _ds(1024, 100, 60)
    store_dir = store.build_store(_port_ds(ds), str(tmp_path / "store"))
    baseline = _port_trainer(_store_cfg(trainer, store_dir))
    assert baseline.train_ds is None
    assert baseline.params.p.shape == (ds.num_users, 6)
    assert baseline.params.q.shape == (ds.num_items, 6)
    _run_epochs(baseline, trainer)
    num_slabs = baseline._loader.num_slabs
    assert num_slabs >= 4

    ckpt_dir = str(tmp_path / "ckpt")
    killed = _port_trainer(_store_cfg(trainer, store_dir, ckpt_dir))
    # die 3 scans into epoch 1, past its slab-2 mid-epoch checkpoint
    _run_epochs(killed, trainer, kill_after_scans=num_slabs + 3)
    assert killed.epoch == 1

    resumed = _port_trainer(_store_cfg(trainer, store_dir, ckpt_dir))
    assert resumed.maybe_restore()
    assert resumed.epoch == 1 and resumed._resume_slab == 2
    _run_epochs(resumed, trainer)
    _assert_state_equal(baseline, resumed)
    for field in ("train_abs_err", "work_fraction", "t_p", "t_q"):
        assert getattr(baseline.history[-1], field) == getattr(resumed.history[-1], field)
    assert baseline.history[-1].step_retries == 0 and baseline.history[-1].straggler_slabs >= 0


STORE_PARITY_CASES = {
    "sgd-fused": dict(optimizer="sgd", use_fused_kernel=True, lr=0.01),
    "sgd": dict(optimizer="sgd", lr=0.01),
    "adagrad": dict(optimizer="adagrad"),
}


# slab durations fed to both trainers' straggler detectors in place of the
# wall clock: steady, then one outlier once the detector has its 10 samples
SLAB_SECONDS = [10.0 if i == 11 else 0.1 + 0.001 * (i % 3) for i in range(64)]


def _scripted_slab_times(trainer_obj):
    """The trainer's ``StragglerDetector`` records :data:`SLAB_SECONDS` in
    order, whatever each slab took."""
    seconds, record = iter(SLAB_SECONDS), trainer_obj.straggler.record
    trainer_obj.straggler.record = lambda _measured: record(next(seconds))


@pytest.mark.parametrize("case", sorted(STORE_PARITY_CASES))
def test_store_trainer_matches_the_reference_store_trainer(tmp_path, case):
    """The same store, initial factors and (Feistel) batch order: the
    reference's store-mode trainer in scan mode against the port's, both
    detectors fed the same scripted slab durations."""
    tr, te = jratings.train_test_split(jratings.synthetic_ratings(200, 150, 6000, seed=0),
                                       0.2, seed=0)
    store_dir = jstore.build_store(tr, str(tmp_path / "s"), shard_rows=1000)
    kw = dict(k=16, epochs=3, batch_size=256, pruning_rate=0.3, slab_steps=4,
              checkpoint_every_epochs=0, checkpoint_every_slabs=0, **STORE_PARITY_CASES[case])
    ref = jtrainer.DPMFTrainer(_store_cfg(jtrainer, store_dir, **kw), None, te)
    init = {k: _np(v) for k, v in ref.params._asdict().items()}
    _scripted_slab_times(ref)
    want = ref.run()
    port = _port_trainer(_store_cfg(trainer, store_dir, **kw), init, _port_ds(te))
    _scripted_slab_times(port)
    got = port.run()
    np.testing.assert_array_equal(port.perm.numpy(), np.asarray(ref.perm))
    assert _relclose(float(port.t_p), float(ref.t_p), 1e-6)
    assert _relclose(float(port.t_q), float(ref.t_q), 1e-6)
    assert [r.epoch for r in got] == [r.epoch for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        for field in ("train_abs_err", "test_mae", "work_fraction"):
            assert _relclose(getattr(g, field), getattr(w, field), 1e-4), (g, w)
        assert (g.straggler_slabs, g.step_retries) == (w.straggler_slabs, w.step_retries)
    assert sum(r.straggler_slabs for r in got) == 1
    assert got[0].work_fraction == 1.0 and got[2].work_fraction < 1.0


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_resume_from_the_other_packages_mid_epoch_checkpoint(tmp_path, writer):
    """One package is killed mid-epoch; the other restores its checkpoint and
    finishes: within the parity tolerances of an uninterrupted run."""
    ds = _ds(1024, 100, 60)
    store_dir = jstore.build_store(ds, str(tmp_path / "store"))
    kw = dict(optimizer="sgd", lr=0.01)
    ref = jtrainer.DPMFTrainer(_store_cfg(jtrainer, store_dir, **kw))
    init = {k: _np(v) for k, v in ref.params._asdict().items()}
    baseline = _port_trainer(_store_cfg(trainer, store_dir, **kw), init)
    _run_epochs(baseline, trainer)
    num_slabs = baseline._loader.num_slabs

    ckpt_dir = str(tmp_path / "ckpt")
    if writer == "ref":
        # the same seed and sizes: the reference draws the same initial factors
        killed = jtrainer.DPMFTrainer(_store_cfg(jtrainer, store_dir, ckpt_dir, **kw))
        _run_epochs(killed, jtrainer, kill_after_scans=num_slabs + 3)
        resumed = _port_trainer(_store_cfg(trainer, store_dir, ckpt_dir, **kw))
        module = trainer
    else:
        killed = _port_trainer(_store_cfg(trainer, store_dir, ckpt_dir, **kw), init)
        _run_epochs(killed, trainer, kill_after_scans=num_slabs + 3)
        resumed = jtrainer.DPMFTrainer(_store_cfg(jtrainer, store_dir, ckpt_dir, **kw))
        module = jtrainer
    assert resumed.maybe_restore()
    assert resumed.epoch == 1 and resumed._resume_slab == 2
    _run_epochs(resumed, module)
    np.testing.assert_allclose(np.asarray(resumed.params.p), baseline.params.p.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(resumed.params.q), baseline.params.q.numpy(),
                               rtol=1e-4, atol=1e-5)
    for field in ("train_abs_err", "work_fraction"):
        assert _relclose(getattr(resumed.history[-1], field),
                         getattr(baseline.history[-1], field), 1e-4)


@pytest.mark.parametrize("change,match", [
    (dict(epoch_mode="python"), "scan"),
    (dict(variant="svdpp"), "svdpp"),
    (dict(objective="implicit"), "explicit"),
    (dict(store_dir=None), "either train_ds"),
])
def test_store_trainer_rejects_what_the_reference_rejects(tmp_path, change, match):
    store_dir = store.build_store(_port_ds(_ds(256, 30, 20)), str(tmp_path / "s"))
    for module, kwargs in ((trainer, dict(device="cpu")), (jtrainer, {})):
        cfg = module.TrainConfig(**{**dict(k=4, epochs=1, batch_size=32, store_dir=store_dir),
                                    **change})
        with pytest.raises(ValueError, match=match):
            module.DPMFTrainer(cfg, None, None, **kwargs)


# ---------------------------------------------------------------------------
# launch/train --store-dir
# ---------------------------------------------------------------------------


def test_train_launcher_builds_a_store_is_killed_and_resumes(tmp_path, capsys, monkeypatch):
    """``launch.train --store-dir --build-store`` killed mid-epoch, then the
    same command again: it resumes at the saved slab and ends with the
    tables of an uninterrupted run, bitwise (CPU)."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib

    store_dir = str(tmp_path / "store")
    argv = ["--device", "cpu", "--scale", "0.05", "--k", "8", "--epochs", "2",
            "--batch-size", "64", "--optimizer", "sgd", "--use-fused-kernel", "--lr", "0.01",
            "--store-dir", store_dir, "--build-store", "--slab-steps", "2",
            "--ckpt-every-slabs", "2"]
    train_launch.main(argv + ["--ckpt", str(tmp_path / "clean")])
    assert "built store" in capsys.readouterr().out
    slabs = store.ShardedRatingsLoader(store.RatingsStore(store_dir), 64, slab_steps=2,
                                       device="cpu").num_slabs
    assert slabs >= 4

    calls = {"n": 0}
    original = trainer.mf.train_epoch_scan

    def dying(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] > slabs + 3:  # 3 scans into epoch 1, past its slab-2 checkpoint
            raise KeyboardInterrupt
        return original(*args, **kwargs)

    ckpt = str(tmp_path / "ckpt")
    monkeypatch.setattr(trainer.mf, "train_epoch_scan", dying)
    with pytest.raises(KeyboardInterrupt):
        train_launch.main(argv + ["--ckpt", ckpt])
    monkeypatch.setattr(trainer.mf, "train_epoch_scan", original)
    capsys.readouterr()
    train_launch.main(argv + ["--ckpt", ckpt])
    out = capsys.readouterr().out
    assert "resumed from checkpoint at epoch 1, slab 2" in out
    report = json.loads(out[out.index("{"):])
    assert report["device"] == "cpu" and np.isfinite(report["final_mae"])
    want, _ = ckpt_lib.load_raw(str(tmp_path / "clean"))
    got, meta = ckpt_lib.load_raw(ckpt)
    assert meta["step"] == 2 * slabs and sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
