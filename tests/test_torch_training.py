"""The port's training slice held against the JAX reference on the CPU: row
optimizers, schedules, rearrangement, the train step on both routes, the
epoch loops, the loaders and the trainer end to end, all from the same numpy
inputs (factors carried across with ``params_from_numpy``).  Tolerances:
1e-5 in float32 for one step or epoch, bitwise on 1/8-grid factors, 1e-4
relative for whole-run epoch records (rounding compounds over epochs)."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import mf as jmf
from repro.core import rearrange as jrearrange
from repro.core import trainer as jtrainer
from repro.data import loader as jloader
from repro.data import ratings as jratings
from repro.optim import optimizers as joptim
from repro.optim import schedules as jschedules
from repro_torch.core import mf, rearrange, trainer
from repro_torch.data import loader, ratings
from repro_torch.distributed.fault_tolerance import (
    StepFailure,
    StragglerDetector,
    run_with_retries,
)
from repro_torch.kernels import fused_mf_sgd
from repro_torch.optim import optimizers, schedules

OPTIMIZERS = ("sgd", "momentum", "adagrad", "adadelta", "adam")


def _np(x):
    return None if x is None else np.asarray(x)


def _carry(jparams):
    return mf.params_from_numpy({k: _np(v) for k, v in jparams._asdict().items()}, device="cpu")


def _carry_state(jstate):
    return mf.MFOptState(*(
        None if d is None else {k: torch.tensor(np.array(v)) for k, v in d.items()}
        for d in jstate
    ))


def _assert_tree_close(got, want, tol=1e-5, exact=False):
    """Port NamedTuple of tensors/dicts against the reference's."""
    for name, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None), name
        if g is None:
            continue
        if isinstance(g, dict):
            assert sorted(g) == sorted(w), name
            pairs = [(f"{name}.{k}", g[k], w[k]) for k in g]
        else:
            pairs = [(name, g, w)]
        for label, gv, wv in pairs:
            gv, wv = gv.numpy(), np.asarray(wv)
            if exact:
                np.testing.assert_array_equal(gv, wv, err_msg=label)
            else:
                np.testing.assert_allclose(gv, wv, rtol=tol, atol=tol, err_msg=label)


# ---------------------------------------------------------------------------
# row optimizers and schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_row_optimizer_matches_reference_with_duplicates(name):
    rng = np.random.default_rng(0)
    table = rng.normal(0, 0.3, (10, 6)).astype(np.float32)
    jopt, opt = joptim.RowOptimizer(name=name), optimizers.RowOptimizer(name=name)
    jparam, jstate = jnp.asarray(table), jopt.init(jnp.asarray(table))
    param = torch.tensor(table)
    state = opt.init(param)
    for step in range(3):  # state carries: momentum, adam's t, adagrad's acc
        idx = rng.integers(0, 10, 16)
        idx[:4] = [3, 3, 7, 3]  # duplicates, the last occurrence of 3 at 3
        grad = rng.normal(0, 1, (16, 6)).astype(np.float32)
        mask = (rng.random((16, 6)) < 0.7).astype(np.float32) * rng.choice([0.0, 0.5, 1.0], (16, 1))
        jparam, jstate = jopt.apply_rows(jparam, jstate, jnp.asarray(idx), jnp.asarray(grad),
                                         jnp.asarray(mask, jnp.float32), jnp.float32(0.05))
        got, state = opt.apply_rows(param, state, torch.tensor(idx), torch.tensor(grad),
                                    torch.tensor(mask.astype(np.float32)), 0.05)
        assert got is param  # in place
        np.testing.assert_allclose(param.numpy(), np.asarray(jparam), rtol=1e-5, atol=1e-6)
        assert sorted(state) == sorted(jstate)
        for key in state:
            np.testing.assert_allclose(state[key].numpy(), np.asarray(jstate[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


def test_last_occurrence_picks_the_last_duplicate():
    idx = torch.tensor([3, 1, 3, 2, 1, 3, 0])
    keep = optimizers.last_occurrence(idx)
    assert sorted(keep.tolist()) == [3, 4, 5, 6] and sorted(idx[keep].tolist()) == [0, 1, 2, 3]


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("k", [7, 16])
def test_schedules_match_reference(epoch, k):
    np.testing.assert_array_equal(schedules.twin_learners_mask(k, epoch).numpy(),
                                  np.asarray(jschedules.twin_learners_mask(k, epoch)))
    got, want = schedules.cosine(0.1, 100, warmup=10, floor=0.01), jschedules.cosine(0.1, 100, 10, 0.01)
    for step in (0, 5, 10, 55, 100, 150):
        assert abs(float(got(step)) - float(want(step))) < 1e-7
    assert schedules.constant(0.3)(7) == jschedules.constant(0.3)(7)


# ---------------------------------------------------------------------------
# rearrangement (Alg. 1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk_rows", [1, 7, 1 << 20])
@pytest.mark.parametrize("m,n,k", [(300, 200, 16), (1000, 77, 50)])
def test_rearrangement_matches_reference(chunk_rows, m, n, k):
    """The row-chunked, in-place path against the reference's whole-array
    one: the same joint sparsity (bitwise), perm and permuted tables."""
    rng = np.random.default_rng(k)
    p = rng.normal(0, 0.1, (m, k)).astype(np.float32)
    q = rng.normal(0, 0.1, (n, k)).astype(np.float32)
    want = jrearrange.rearrangement(jnp.asarray(p), jnp.asarray(q), jnp.float32(0.05),
                                    jnp.float32(0.04))
    got = rearrange.rearrangement(torch.tensor(p), torch.tensor(q), 0.05, 0.04,
                                  chunk_rows=chunk_rows)
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_array_equal(got.joint_sparsity.numpy(), np.asarray(want.joint_sparsity))
    tp, tq = torch.tensor(p), torch.tensor(q)
    out = rearrange.apply_perm(tp, tq, got.perm, chunk_rows=chunk_rows)
    assert out[0] is tp and out[1] is tq  # in place
    wp, wq = jrearrange.apply_perm(jnp.asarray(p), jnp.asarray(q), want.perm)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(wq))
    acc = torch.tensor(p * p)
    rearrange.apply_perm_tree([acc], got.perm, chunk_rows=chunk_rows)
    np.testing.assert_array_equal(acc.numpy(), (p * p)[:, np.asarray(want.perm)])


# ---------------------------------------------------------------------------
# train_step on both routes, and the epoch loops
# ---------------------------------------------------------------------------

M, N, K, B = 40, 30, 12, 64


def _setup(variant, opt_name, *, seed=0, grid=False, weighted=False, hist_len=5):
    rng = np.random.default_rng(seed)
    draw = (lambda *s: (rng.integers(-8, 9, s) / 8).astype(np.float32)) if grid else (
        lambda *s: rng.normal(0, 0.1, s).astype(np.float32))
    fields = {"p": draw(M, K), "q": draw(N, K)}
    if variant in ("bias", "svdpp"):
        fields.update(user_bias=draw(M, 1), item_bias=draw(N, 1), global_mean=np.float32(3.0))
    if variant == "svdpp":
        y = draw(N + 1, K)
        y[N] = 0.0
        fields["implicit"] = y
    jparams = jmf.MFParams(**{f: None if fields.get(f) is None else jnp.asarray(fields[f])
                              for f in jmf.MFParams._fields})
    batch = {"user": rng.integers(0, M, B), "item": rng.integers(0, N, B),
             "rating": rng.integers(1, 6, B).astype(np.float32)}
    batch["user"][:6] = batch["user"][6:12]  # duplicate rows in a batch
    if weighted:
        batch["weight"] = (rng.integers(0, 3, B) / 2).astype(np.float32)
    if variant == "svdpp":
        batch["hist"] = rng.integers(0, N + 1, (B, hist_len))
    return jparams, batch, jmf.init_opt_state(jparams, joptim.RowOptimizer(opt_name))


STEP_CASES = [  # (variant, optimizer, fused, weighted, twin)
    ("funk", "sgd", True, False, False),
    ("bias", "sgd", True, True, False),
    ("funk", "sgd", False, False, True),
    ("funk", "adagrad", False, True, False),
    ("bias", "momentum", False, False, True),
    ("bias", "adadelta", False, True, False),
    ("svdpp", "adam", False, False, False),
    ("svdpp", "adagrad", False, True, False),
]


@pytest.mark.parametrize("variant,opt_name,fused,weighted,twin", STEP_CASES)
def test_train_step_matches_reference(variant, opt_name, fused, weighted, twin):
    jparams, batch, jstate = _setup(variant, opt_name, weighted=weighted)
    params, state = _carry(jparams), _carry_state(jstate)
    jopt, opt = joptim.RowOptimizer(opt_name), optimizers.RowOptimizer(opt_name)
    jmask = jschedules.twin_learners_mask(K, 0) if twin else jnp.ones((K,))
    mask = schedules.twin_learners_mask(K, 0) if twin else torch.ones((K,))
    before = fused_mf_sgd.launches
    for t in (0.0, 0.06):  # one dense step, one pruned step
        jparams, jstate, jm = jmf.train_step(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(t),
            jnp.float32(t), jnp.float32(0.05), jmask, opt=jopt, lam=0.02,
            use_fused_kernel=fused)
        params, state, m = mf.train_step(
            params, state, {k: torch.as_tensor(v) for k, v in batch.items()}, torch.tensor(t),
            torch.tensor(t), 0.05, mask, opt=opt, lam=0.02, use_fused_kernel=fused)
        _assert_tree_close(params, jparams)
        _assert_tree_close(state, jstate)
        for key in ("abs_err", "work_fraction"):
            assert abs(float(m[key]) - float(jm[key])) <= 1e-5 * max(1.0, abs(float(jm[key])))
    assert fused_mf_sgd.launches == before  # the CPU route never launches


@pytest.mark.parametrize("variant,fused", [("funk", True), ("bias", True), ("funk", False),
                                           ("bias", False)])
def test_train_step_grid_bitwise(variant, fused):
    """1/8-grid factors, integer ratings, lr and lam powers of two: one step
    is bitwise equal to the reference's, duplicates included.  (SVD++ is
    not: its user vector scales by 1/sqrt(|N(u)|).)"""
    jparams, batch, jstate = _setup(variant, "sgd", seed=3, grid=True, weighted=True)
    params, state = _carry(jparams), _carry_state(jstate)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams, jstate, _ = jmf.train_step(
        jparams, jstate, jbatch, jnp.float32(1 / 8), jnp.float32(1 / 4), jnp.float32(1 / 16),
        jnp.ones((K,)), opt=joptim.RowOptimizer("sgd"), lam=1 / 32, use_fused_kernel=fused)
    params, state, _ = mf.train_step(
        params, state, {k: torch.as_tensor(v) for k, v in batch.items()}, torch.tensor(1 / 8),
        torch.tensor(1 / 4), 1 / 16, torch.ones((K,)), opt=optimizers.RowOptimizer("sgd"),
        lam=1 / 32, use_fused_kernel=fused)
    _assert_tree_close(params, jparams, exact=True)


@pytest.mark.parametrize("variant,opt_name,fused", [("funk", "sgd", True), ("bias", "adagrad", False),
                                                    ("svdpp", "adagrad", False)])
def test_epoch_loops_match_reference(variant, opt_name, fused):
    jparams, _, jstate = _setup(variant, opt_name)
    ds = jratings.synthetic_ratings(M, N, 800, seed=2)
    hist = jratings.build_user_history(ds, 5) if variant == "svdpp" else None
    jbatches = jloader.pack_eval_batches(ds, 128)  # any (steps, B) batches will do
    jbatches = {k: v for k, v in jbatches.items() if k != "weight"}
    jhist = None if hist is None else jnp.asarray(hist)
    params, state = _carry(jparams), _carry_state(jstate)
    jopt, opt = joptim.RowOptimizer(opt_name), optimizers.RowOptimizer(opt_name)
    jparams, jstate, jm = jmf.train_epoch_scan(
        jparams, jstate, jbatches, jnp.float32(0.04), jnp.float32(0.04), jnp.float32(0.02),
        jnp.ones((K,)), jhist, opt=jopt, lam=0.02, use_fused_kernel=fused)
    batches = {k: torch.tensor(np.array(v)).long() if k != "rating"
               else torch.tensor(np.array(v)) for k, v in jbatches.items()}
    thist = None if hist is None else torch.as_tensor(hist).long()
    params, state, m = mf.train_epoch_scan(
        params, state, batches, torch.tensor(0.04), torch.tensor(0.04), 0.02, torch.ones((K,)),
        thist, opt=opt, lam=0.02, use_fused_kernel=fused)
    _assert_tree_close(params, jparams)
    _assert_tree_close(state, jstate)
    for key in ("abs_err", "work_fraction"):
        assert abs(float(m[key]) - float(jm[key])) <= 1e-5
    jeval = jloader.pack_eval_batches(ds, 96)
    want = jmf.eval_epoch_scan(jparams, jeval, jnp.float32(0.04), jnp.float32(0.04), jhist)
    got = mf.eval_epoch_scan(params, loader.pack_eval_batches(ds, 96, device="cpu"),
                             torch.tensor(0.04), torch.tensor(0.04), thist)
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-5 * max(1.0, abs(float(w)))


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def test_loaders_match_reference_order():
    ds = jratings.synthetic_ratings(50, 40, 1003, seed=4)
    hist = jratings.build_user_history(ds, 4)
    port_ds = ratings.RatingsDataset(ds.user, ds.item, ds.rating, ds.num_users, ds.num_items)
    np.testing.assert_array_equal(ratings.build_user_history(port_ds, 4), hist)
    for shuffle, drop in ((True, True), (False, False)):
        want = list(jloader.iterate_batches(ds, 64, seed=3, epoch=2, shuffle=shuffle,
                                            drop_remainder=drop, hist=hist))
        got = list(loader.iterate_batches(port_ds, 64, seed=3, epoch=2, shuffle=shuffle,
                                          drop_remainder=drop, hist=hist))
        assert len(got) == len(want) == loader.num_steps(port_ds, 64, drop)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in g:
                np.testing.assert_array_equal(g[key], w[key])
    # the packed path gives the host loop's order: the reference's python mode
    packed = loader.pack_ratings(port_ds, 64, device="cpu")
    batches = packed.epoch_batches(3, 2)
    host = list(loader.iterate_batches(port_ds, 64, seed=3, epoch=2))
    assert batches["user"].shape == (len(host), 64)
    for s, b in enumerate(host):
        for key in ("user", "item", "rating"):
            np.testing.assert_array_equal(batches[key][s].numpy(), b[key])
    want_eval = jloader.pack_eval_batches(ds, 100)
    got_eval = loader.pack_eval_batches(port_ds, 100, device="cpu")
    for key in want_eval:
        np.testing.assert_array_equal(got_eval[key].numpy(), np.asarray(want_eval[key]))
    with pytest.raises(ValueError, match="exceeds"):
        loader.pack_ratings(port_ds, 5000, device="cpu").epoch_batches(0, 0)


# ---------------------------------------------------------------------------
# the trainer end to end
# ---------------------------------------------------------------------------


def _split(num_users=200, num_items=150, n=6000):
    tr, te = jratings.train_test_split(jratings.synthetic_ratings(num_users, num_items, n, seed=0),
                                       0.2, seed=0)
    port = [ratings.RatingsDataset(d.user, d.item, d.rating, d.num_users, d.num_items)
            for d in (tr, te)]
    return (tr, te), port


# sgd runs at lr 0.01: the zipf items put ~80 ratings of item 0 in a batch,
# and their summed updates diverge at 0.05.  SVD++ trains with sgd: under
# adagrad (which normalises near-zero gradients) its rsqrt-scaled rounding
# differences reach 1e-6 in the thresholds.
TRAINER_CASES = {
    "funk-sgd-fused": dict(optimizer="sgd", use_fused_kernel=True, lr=0.01),
    "funk-adagrad": dict(optimizer="adagrad"),
    "bias-sgd-fused": dict(variant="bias", optimizer="sgd", use_fused_kernel=True, lr=0.01),
    "svdpp-sgd": dict(variant="svdpp", optimizer="sgd", lr=0.01),
}


def _relclose(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(b), 1e-12)


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_trainer_matches_reference(case):
    """Same dataset, initial factors and batch order (the reference in
    python mode): identical perm, thresholds within 1e-6 relative, epoch
    metrics within 1e-4 relative; the port's scan mode gives the same."""
    (tr, te), (ptr, pte) = _split()
    kw = dict(k=16, epochs=3, batch_size=256, pruning_rate=0.3, **TRAINER_CASES[case])
    ref = jtrainer.DPMFTrainer(jtrainer.TrainConfig(epoch_mode="python", **kw), tr, te)
    init = {k: _np(v) for k, v in ref.params._asdict().items()}
    want = ref.run()
    for mode in ("python", "scan"):
        port = trainer.DPMFTrainer(trainer.TrainConfig(epoch_mode=mode, **kw), ptr, pte,
                                   device="cpu")
        port.params = mf.params_from_numpy(init, device="cpu")
        port.opt_state = mf.init_opt_state(port.params, port.opt)
        got = port.run()
        np.testing.assert_array_equal(port.perm.numpy(), np.asarray(ref.perm))
        assert _relclose(float(port.t_p), float(ref.t_p), 1e-6)
        assert _relclose(float(port.t_q), float(ref.t_q), 1e-6)
        assert [r.epoch for r in got] == [r.epoch for r in want] == [0, 1, 2]
        for g, w in zip(got, want):
            for field in ("train_abs_err", "test_mae", "work_fraction"):
                assert _relclose(getattr(g, field), getattr(w, field), 1e-4), (mode, g, w)
            assert _relclose(g.t_p, w.t_p, 1e-6) and _relclose(g.t_q, w.t_q, 1e-6)
        assert got[0].work_fraction == 1.0 and got[2].work_fraction < 1.0


def test_calibrate_permutes_optimizer_state():
    (_, _), (ptr, pte) = _split(80, 60, 2000)
    t = trainer.DPMFTrainer(trainer.TrainConfig(k=8, epochs=1, batch_size=128, pruning_rate=0.3,
                                                optimizer="adam"), ptr, pte, device="cpu")
    t.opt_state.p["m"].copy_(torch.arange(8.0).expand(80, 8))  # recognisable columns
    p, acc_m = t.params.p.clone(), t.opt_state.p["m"].clone()
    t.calibrate()
    perm = t.perm.long()
    np.testing.assert_array_equal(t.params.p.numpy(), p[:, perm].numpy())
    np.testing.assert_array_equal(t.opt_state.p["m"].numpy(), acc_m[:, perm].numpy())
    assert int(t.opt_state.p["t"]) == 0  # the shared step count is not a table
    assert torch.equal(t.joint_sparsity, torch.sort(t.joint_sparsity, stable=True).values)


def test_trainer_trains_from_a_store_dir(tmp_path):
    """``store_dir`` was refused until the out-of-core path was ported; the
    trainer now takes its sizes from the store and streams its epochs
    (parity with the reference: tests/test_torch_store.py)."""
    from repro_torch.store import build_store

    (_, _), (ptr, pte) = _split(20, 20, 300)
    store_dir = build_store(ptr, str(tmp_path / "store"))
    t = trainer.DPMFTrainer(trainer.TrainConfig(k=4, epochs=2, batch_size=32, pruning_rate=0.3,
                                                store_dir=store_dir, slab_steps=3), None, pte,
                            device="cpu")
    assert t.params.p.shape == (20, 4) and t.params.q.shape == (20, 4)
    history = t.run()
    assert [r.epoch for r in history] == [0, 1]
    assert all(np.isfinite(r.train_abs_err) and np.isfinite(r.test_mae) for r in history)
    assert history[1].work_fraction < 1.0 == history[0].work_fraction


def test_trainer_trains_with_ranking_metrics():
    """``ranking_topk`` was refused until ranking evaluation was ported; it
    now trains and logs HR/NDCG/recall every epoch."""
    (_, _), (ptr, pte) = _split(20, 20, 300)
    t = trainer.DPMFTrainer(trainer.TrainConfig(k=4, epochs=2, batch_size=64, pruning_rate=0.3,
                                                ranking_topk=10), ptr, pte, device="cpu")
    history = t.run()
    assert all(0.0 <= getattr(r, f) <= 1.0 for r in history for f in ("hr", "ndcg", "recall"))


def test_trainer_runs_on_the_card_unless_told(monkeypatch):
    (_, _), (ptr, pte) = _split(20, 20, 300)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        trainer.DPMFTrainer(trainer.TrainConfig(k=4), ptr, pte)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        loader.pack_ratings(ptr, 16)


def test_summary_metrics_match_reference():
    fields = [f.name for f in dataclasses.fields(trainer.EpochRecord)]
    hist = [trainer.EpochRecord(e, 1.0, 1.0, 1.0, w, 0.0, 0.0)
            for e, w in enumerate((1.0, 0.4, 0.3))]
    jhist = [jtrainer.EpochRecord(**{f: getattr(r, f) for f in fields}) for r in hist]
    assert trainer.work_speedup(hist) == jtrainer.work_speedup(jhist)
    assert trainer.work_speedup([]) == 1.0
    assert trainer.percentage_mae(0.9, 0.8) == jtrainer.percentage_mae(0.9, 0.8)


def test_fault_tolerance_helpers():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "done"

    retried = []
    assert run_with_retries(flaky, max_retries=3, backoff_s=0.0,
                            on_retry=lambda n, exc: retried.append(n)) == "done"
    assert retried == [1, 2]
    with pytest.raises(StepFailure):
        run_with_retries(lambda: (_ for _ in ()).throw(RuntimeError("x")), max_retries=1,
                         backoff_s=0.0)
    with pytest.raises(ValueError):
        run_with_retries(lambda: (_ for _ in ()).throw(ValueError("bug")), backoff_s=0.0)
    detector = StragglerDetector(window=20, z_threshold=4.0, min_samples=5)
    assert not any(detector.record(1.0 + 0.01 * (i % 3)) for i in range(10))
    assert detector.record(5.0) and detector.flagged == 1


def test_chip_smoke_variants_phase_rehearses_on_the_cpu():
    """``chip_smoke.py``'s bias-dpmf and svdpp-dpmf phase (ROADMAP C9) at
    3,000 users x 700 items x 128 on the CPU: every check holds (the launch
    counts are checked on the card only), each variant's held step within
    1e-5 of the plain step."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    chip_smoke.failures.clear()
    out = chip_smoke.variants_phase(torch.device("cpu"), (3000, 700, 2048, 512))
    assert chip_smoke.failures == []
    assert list(out) == ["bias", "svdpp"]
    for variant, stats in out.items():
        assert len(stats["step_ms"]) == chip_smoke.VARIANT_STEPS, variant
        assert stats["max_abs_err"] <= 1e-5 and all(np.isfinite(stats["abs_err"])), variant
    assert chip_smoke.PATH_LAUNCHES["variants"] == {"fused_mf_sgd": 0, "add_rows": 0}
