"""The port's ranking evaluation (``repro_torch.eval.ranking``,
``mf.eval_ranking_epoch_scan`` and the trainer's per-epoch HR/NDCG/recall)
held against the JAX reference on the CPU, from the same numpy inputs.
Tolerances: metric sums within 1e-6; ids identical on 1/8-grid factors
(exact scores, exact ties); engine and oracle metrics of the port exactly
equal at thresholds 0."""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import mf as jmf
from repro.core import trainer as jtrainer
from repro.data import ratings as jratings
from repro.eval import ranking as JR
from repro.serving import ServingEngine as JServingEngine
from repro_torch.core import mf, trainer
from repro_torch.data import ratings
from repro_torch.eval import ranking as R
from repro_torch.serving import ServingEngine


def _carry(jparams):
    return mf.params_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in jparams._asdict().items()},
        device="cpu")


def _jparams(params):
    """The port's CPU params as the reference's MFParams."""
    return jmf.MFParams(*(None if v is None else jnp.asarray(v.numpy()) for v in params))


def _grid_params(m, n, k, variant="funk", seed=0):
    """1/8-grid factors with duplicated items: exact scores and exact ties,
    so every path's ids must agree exactly."""
    rng = np.random.default_rng(seed)
    g = lambda *s: (rng.integers(-8, 9, s) / 8.0).astype(np.float32)  # noqa: E731
    q = g(n, k)
    q[rng.integers(0, n, n // 4)] = q[rng.integers(0, n, n // 4)]
    bias = variant in ("bias", "svdpp")
    implicit = None
    if variant == "svdpp":
        implicit = np.concatenate([g(n, k) / 2, np.zeros((1, k), np.float32)])
    return mf.params_from_numpy({
        "p": g(m, k), "q": q,
        "user_bias": g(m, 1) if bias else None,
        "item_bias": g(n, 1) if bias else None,
        "global_mean": np.float32(3.0) if bias else None,
        "implicit": implicit,
    }, device="cpu")


def _dataset(m, n, count, seed=0):
    ds = jratings.synthetic_ratings(num_users=m, num_items=n, num_ratings=count, seed=seed)
    return ds, ratings.RatingsDataset(ds.user, ds.item, ds.rating, ds.num_users, ds.num_items)


def _close(got: R.RankingReport, want: JR.RankingReport, tol=1e-6):
    assert got.topk == want.topk and got.users == want.users
    for field in ("hr", "ndcg", "recall"):
        assert abs(getattr(got, field) - getattr(want, field)) <= tol, (field, got, want)


# ---------------------------------------------------------------------------
# metric sums
# ---------------------------------------------------------------------------


def _padded(relevant_sets):
    width = max(max((len(r) for r in relevant_sets), default=1), 1)
    rel = np.full((len(relevant_sets), width), R.PAD_ITEM, np.int32)
    counts = np.zeros(len(relevant_sets), np.int32)
    for row, items in enumerate(relevant_sets):
        rel[row, : len(items)] = sorted(items)
        counts[row] = len(items)
    return rel, counts


@pytest.mark.parametrize("weighted", [False, True])
def test_ranking_counts_matches_reference(weighted):
    rng = np.random.default_rng(0)
    b, k, n_items = 64, 10, 200
    topk_idx = np.stack([rng.choice(n_items, k, replace=False) for _ in range(b)]).astype(np.int32)
    rel, counts = _padded([list(rng.choice(n_items, rng.integers(0, 30), replace=False))
                           for _ in range(b)])
    weight = rng.integers(0, 2, b).astype(np.float32) if weighted else None
    got = R.ranking_counts(torch.tensor(topk_idx), torch.tensor(rel), torch.tensor(counts),
                           None if weight is None else torch.tensor(weight))
    want = JR.ranking_counts(jnp.asarray(topk_idx), jnp.asarray(rel), jnp.asarray(counts),
                             None if weight is None else jnp.asarray(weight))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(R.ndcg_discounts(k).numpy(), np.asarray(JR.ndcg_discounts(k)),
                               rtol=1e-6)


def test_ranking_counts_pinned_cases():
    out = R.ranking_counts(torch.tensor([[5, 7, 1, 2]]), torch.tensor([[5, 7]]),
                           torch.tensor([2]))
    assert float(out["hr_sum"]) == 1.0 and float(out["recall_sum"]) == 1.0
    np.testing.assert_allclose(float(out["ndcg_sum"]), 1.0, rtol=1e-6)
    out = R.ranking_counts(torch.tensor([[9, 8, 7, 5]]), torch.tensor([[5]]), torch.tensor([1]))
    np.testing.assert_allclose(float(out["ndcg_sum"]), 1 / math.log2(5), rtol=1e-6)
    # zero-relevance and zero-weight rows contribute nothing
    out = R.ranking_counts(torch.tensor([[1, 2], [1, 2]]), torch.tensor([[1, 2], [1, 2]]),
                           torch.tensor([0, 2]), torch.tensor([1.0, 0.0]))
    assert float(out["weight_sum"]) == 0.0 and float(out["hr_sum"]) == 0.0
    # |R_u| > K: IDCG truncates at K, recall divides by |R_u|
    rel, counts = _padded([[0, 1, 2, 3, 4]])
    out = R.ranking_counts(torch.tensor([[0, 1, 2]]), torch.tensor(rel), torch.tensor(counts))
    assert float(out["recall_sum"]) == pytest.approx(3 / 5)
    np.testing.assert_allclose(float(out["ndcg_sum"]), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# relevance sets and packed batches
# ---------------------------------------------------------------------------


class _DS:
    user = np.asarray([3, 1, 3, 3, 2, 1, 7, 7])
    item = np.asarray([7, 5, 7, 9, 4, 6, 1, 2])
    rating = np.asarray([5.0, 4.0, 5.0, 2.0, 1.0, 5.0, 3.0, 4.5])


@pytest.mark.parametrize("kwargs", [{}, {"min_rating": 4.0}, {"max_users": 2},
                                    {"min_rating": 4.0, "max_users": 1}])
def test_relevance_from_dataset_matches_reference(kwargs):
    got = R.relevance_from_dataset(_DS, **kwargs)
    want = JR.relevance_from_dataset(_DS, **kwargs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):  # None means no cap, not 0
        R.relevance_from_dataset(_DS, max_users=0)


@pytest.mark.parametrize("batch_size,max_users", [(16, None), (7, 30), (1000, None)])
def test_pack_ranking_batches_matches_reference(batch_size, max_users):
    jds, ds = _dataset(50, 300, 1500)
    got = R.pack_ranking_batches(ds, batch_size, max_users=max_users, device="cpu")
    want = JR.pack_ranking_batches(jds, batch_size, max_users=max_users)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    with pytest.raises(ValueError, match="no users"):
        R.pack_ranking_batches(_DS, 4, min_rating=10.0, device="cpu")


# ---------------------------------------------------------------------------
# the oracle and the evaluators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["funk", "bias", "svdpp"])
@pytest.mark.parametrize("t", [0.0, 1 / 8])
def test_dense_topk_matches_reference(variant, t):
    params = _grid_params(30, 400, 12, variant, seed=1)
    hist = (np.random.default_rng(2).integers(0, 401, (30, 4)).astype(np.int32)
            if variant == "svdpp" else None)
    users = np.asarray([0, 3, 29, 3, 17])
    got_s, got_i = R.dense_topk(params, users, 25, t_p=t, t_q=t, hist=hist)
    want_s, want_i = JR.dense_topk(_jparams(params), users, 25, t_p=t, t_q=t, hist=hist)
    assert got_i.dtype == np.int32 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)


@pytest.mark.parametrize("variant", ["funk", "bias"])
def test_engine_metrics_equal_oracle_at_threshold_zero(variant):
    params = _grid_params(50, 700, 16, variant)
    jds, ds = _dataset(50, 700, 1500)
    engine = ServingEngine(params, 0.0, 0.0, device="cpu", max_batch=32)
    got = R.evaluate_engine(engine, ds, topk=10)
    assert got == R.evaluate_oracle(params, ds, topk=10)  # exact: identical ids
    want = JR.evaluate_engine(JServingEngine(_jparams(params), 0.0, 0.0, use_kernel=False,
                                             max_batch=32), jds, topk=10)
    _close(got, want)


def test_engine_and_oracle_agree_on_random_factors():
    """Random (not grid) factors: the port's engine equals its own oracle at
    T = 0 and at a pruning threshold, and both match the reference."""
    jparams = jmf.init_params(__import__("jax").random.PRNGKey(0), 50, 700, 16,
                              variant="bias", global_mean=3.0)
    params = _carry(jparams)
    jds, ds = _dataset(50, 700, 1500)
    for t in (0.0, 0.05):
        engine = ServingEngine(params, t, t, device="cpu", max_batch=32)
        got = R.evaluate_engine(engine, ds, topk=10)
        assert got == R.evaluate_oracle(params, ds, topk=10, t_p=t, t_q=t)
        _close(got, JR.evaluate_oracle(jparams, jds, topk=10, t_p=t, t_q=t))


def test_tie_scores_break_to_lower_index():
    rng = np.random.default_rng(2)
    m, n, k = 20, 150, 8
    p = (np.round(rng.normal(0, 1, (m, k)) * 2) / 8).astype(np.float32)
    q = (np.round(rng.normal(0, 1, (n, k)) * 2) / 8).astype(np.float32)
    params = mf.params_from_numpy({"p": p, "q": q}, device="cpu")
    jds, ds = _dataset(m, n, 400, seed=3)
    engine = ServingEngine(params, 0.0, 0.0, device="cpu", max_batch=16)
    got = R.evaluate_engine(engine, ds, topk=10)
    assert got == R.evaluate_oracle(params, ds, topk=10)
    _close(got, JR.evaluate_oracle(_jparams(params), jds, topk=10))


def test_topk_equals_catalog_size():
    params = _grid_params(12, 40, 8, "bias")
    _, ds = _dataset(12, 40, 300)
    engine = ServingEngine(params, 0.0, 0.0, device="cpu", max_batch=8)
    got = R.evaluate_engine(engine, ds, topk=40)
    assert got == R.evaluate_oracle(params, ds, topk=40)
    assert got.hr == 1.0 and got.recall == 1.0


def test_evaluators_accept_precomputed_relevance():
    params = _grid_params(20, 100, 8)
    _, ds = _dataset(20, 100, 400)
    engine = ServingEngine(params, 0.0, 0.0, device="cpu", max_batch=8)
    relevance = R.relevance_from_dataset(ds)
    assert R.evaluate_engine(engine, topk=5, relevance=relevance) == R.evaluate_engine(
        engine, ds, topk=5)
    assert R.evaluate_oracle(params, topk=5, relevance=relevance) == R.evaluate_oracle(
        params, ds, topk=5)
    report = R.evaluate_oracle(params, ds, topk=5)
    assert report.as_dict() == {"topk": 5, "users": report.users, "hr_at_5": report.hr,
                                "ndcg_at_5": report.ndcg, "recall_at_5": report.recall}


def test_evaluate_engine_refuses_a_mesh():
    params = _grid_params(8, 40, 8)
    _, ds = _dataset(8, 40, 100)
    engine = ServingEngine(params, device="cpu")
    # a mesh is served through topk_sharded (tests/test_torch_multirank_serving.py);
    # anything but a DeviceMesh with named dims is refused
    with pytest.raises(ValueError, match="DeviceMesh"):
        R.evaluate_engine(engine, ds, topk=5, mesh=object())


# ---------------------------------------------------------------------------
# the one-pass epoch variant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["funk", "bias"])
@pytest.mark.parametrize("t", [0.0, 1 / 8])
def test_eval_ranking_epoch_scan_matches_reference(variant, t):
    params = _grid_params(50, 700, 16, variant)
    jds, ds = _dataset(50, 700, 1500)
    sums = mf.eval_ranking_epoch_scan(params, R.pack_ranking_batches(ds, 16, device="cpu"),
                                      torch.tensor(t), torch.tensor(t), topk=10)
    want = jmf.eval_ranking_epoch_scan(_jparams(params), JR.pack_ranking_batches(jds, 16),
                                       jnp.float32(t), jnp.float32(t), topk=10)
    for key in want:
        assert sums[key].dtype == torch.float32
        np.testing.assert_allclose(float(sums[key]), float(want[key]), rtol=1e-6, err_msg=key)
    got = R.report_from_sums({key: float(v) for key, v in sums.items()}, 10)
    # the scan's ranking is the engine's: the per-user constant never reorders
    _close(got, R.evaluate_oracle(params, ds, topk=10, t_p=t, t_q=t))


def test_eval_ranking_epoch_scan_svdpp_history():
    m, n, k = 30, 300, 8
    params = _grid_params(m, n, k, "svdpp", seed=4)
    hist = np.random.default_rng(4).integers(0, n, (m, 5)).astype(np.int32)
    jds, ds = _dataset(m, n, 500, seed=5)
    sums = mf.eval_ranking_epoch_scan(
        params, R.pack_ranking_batches(ds, 8, device="cpu"), 0.0, 0.0,
        torch.as_tensor(hist, dtype=torch.int64), topk=9)
    want = jmf.eval_ranking_epoch_scan(_jparams(params), JR.pack_ranking_batches(jds, 8),
                                       jnp.float32(0.0), jnp.float32(0.0), jnp.asarray(hist),
                                       topk=9)
    for key in want:
        np.testing.assert_allclose(float(sums[key]), float(want[key]), rtol=1e-6, err_msg=key)


# ---------------------------------------------------------------------------
# the trainer's per-epoch ranking metrics
# ---------------------------------------------------------------------------


def _split(num_users, num_items, n):
    tr, te = jratings.train_test_split(
        jratings.synthetic_ratings(num_users, num_items, n, seed=0), 0.25, seed=0)
    port = [ratings.RatingsDataset(d.user, d.item, d.rating, d.num_users, d.num_items)
            for d in (tr, te)]
    return (tr, te), port


def test_trainer_logs_ranking_metrics():
    (_, _), (train, test) = _split(40, 200, 1200)
    cfg = trainer.TrainConfig(k=8, epochs=2, batch_size=256, pruning_rate=0.3, ranking_topk=10)
    t = trainer.DPMFTrainer(cfg, train, test, device="cpu")
    history = t.run()
    for record in history:
        assert 0.0 <= record.hr <= 1.0 and 0.0 <= record.ndcg <= 1.0
        assert 0.0 <= record.recall <= 1.0
    report = t.evaluate_ranking()
    assert report.topk == 10 and report.ndcg == pytest.approx(history[-1].ndcg)
    plain = trainer.DPMFTrainer(trainer.TrainConfig(k=8, epochs=1, batch_size=256), train, test,
                                device="cpu")
    assert plain.evaluate_ranking() is None
    assert math.isnan(plain.run()[-1].ndcg)


def _relclose(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(b), 1e-12)


@pytest.mark.parametrize("mode", ["python", "scan"])
def test_trainer_with_ranking_matches_reference(mode):
    """The same dataset, initial factors and batch order (the reference in
    python mode) with ``ranking_topk=10``: identical permutation, (T_p, T_q)
    within 1e-6, per-epoch MAE within the training tolerance (1e-4
    relative), per-epoch HR/NDCG/recall within 1e-6."""
    (tr, te), (ptr, pte) = _split(120, 150, 4000)
    kw = dict(k=16, epochs=3, batch_size=256, pruning_rate=0.3, optimizer="sgd",
              use_fused_kernel=True, lr=0.01, ranking_topk=10, ranking_max_users=100)
    ref = jtrainer.DPMFTrainer(jtrainer.TrainConfig(epoch_mode="python", **kw), tr, te)
    init = {k: None if v is None else np.asarray(v) for k, v in ref.params._asdict().items()}
    want = ref.run()
    port = trainer.DPMFTrainer(trainer.TrainConfig(epoch_mode=mode, **kw), ptr, pte, device="cpu")
    port.params = mf.params_from_numpy(init, device="cpu")
    port.opt_state = mf.init_opt_state(port.params, port.opt)
    got = port.run()
    np.testing.assert_array_equal(port.perm.numpy(), np.asarray(ref.perm))
    assert _relclose(float(port.t_p), float(ref.t_p), 1e-6)
    assert _relclose(float(port.t_q), float(ref.t_q), 1e-6)
    assert [r.epoch for r in got] == [r.epoch for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        for field in ("train_abs_err", "test_mae", "work_fraction"):
            assert _relclose(getattr(g, field), getattr(w, field), 1e-4), (field, g, w)
        for field in ("hr", "ndcg", "recall"):
            assert math.isfinite(getattr(g, field))
            assert abs(getattr(g, field) - getattr(w, field)) <= 1e-6, (field, g, w)
    assert got[0].work_fraction == 1.0 and got[2].work_fraction < 1.0
