"""The port's workloads (implicit and BPR objectives) held against the JAX
reference on the CPU, from the same numpy inputs.

Tolerances: bitwise for the sampled negatives, the BPR triples and every
derived dataset array (both packages draw with the same numpy calls);
1e-5 in float32 for one BPR step against the reference; bitwise against the
port's own ``bpr_step_ref`` on 1/8-grid factors with dyadic lr and lam; the
trainer end to end as ``tests/test_torch_training.py`` holds the explicit
objective (identical permutation, thresholds within 1e-6 relative, epoch
records within 1e-4 relative).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import mf as jmf
from repro.core import trainer as jtrainer
from repro.data import ratings as jratings
from repro.kernels import ref as jref
from repro.online import stream as jstream
from repro.optim.optimizers import RowOptimizer as JRowOptimizer
from repro.workloads import bpr as jbpr
from repro.workloads import implicit as jimplicit
from repro_torch.core import mf, trainer
from repro_torch.data import ratings
from repro_torch.kernels import fused_mf_sgd, ref
from repro_torch.online import stream
from repro_torch.optim.optimizers import RowOptimizer
from repro_torch.workloads import bpr, implicit

K, M, N = 8, 24, 32
LR, LAM = 0.5, 0.25          # dyadic: grid arithmetic stays exact
T_GRID = 0.25


def _grid(rng, shape):
    """float32 multiples of 1/8 in [-2, 2]: sums and products stay exact."""
    return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)


def _log(seed=0, n=200, full_user=True):
    """A reference log; with ``full_user`` user 0 has rated every item, so
    no true negative exists for them."""
    ds = jratings.synthetic_ratings(num_users=M, num_items=N, num_ratings=n, seed=seed)
    if full_user:
        ds = jratings.RatingsDataset(
            user=np.concatenate([ds.user, np.zeros(N, np.int32)]),
            item=np.concatenate([ds.item, np.arange(N, dtype=np.int32)]),
            rating=np.concatenate([ds.rating, np.full(N, 3.0, np.float32)]),
            num_users=M, num_items=N)
    return ds


def _port_ds(ds):
    return ratings.RatingsDataset(ds.user, ds.item, ds.rating, ds.num_users, ds.num_items,
                                  ds.rating_min, ds.rating_max)


def _assert_ds_equal(got, want):
    for field in ("user", "item", "rating"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert (got.num_users, got.num_items, got.rating_min, got.rating_max) == (
        want.num_users, want.num_items, want.rating_min, want.rating_max)


# ---------------------------------------------------------------------------
# implicit: datasets, negatives, stream batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha,negatives,seed", [(40.0, 4, 0), (4.0, 2, 3), (1.0, 0, 1)])
def test_implicit_dataset_matches_reference(alpha, negatives, seed):
    ds = _log(seed)
    want, want_w = jimplicit.implicit_dataset(ds, alpha=alpha, negatives=negatives, seed=seed)
    got, got_w = implicit.implicit_dataset(_port_ds(ds), alpha=alpha, negatives=negatives,
                                           seed=seed)
    _assert_ds_equal(got, want)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(implicit.confidence_weights(ds.rating, alpha),
                                  jimplicit.confidence_weights(ds.rating, alpha))
    _assert_ds_equal(implicit.binarize_positives(_port_ds(ds)), jimplicit.binarize_positives(ds))
    with pytest.raises(ValueError, match="negatives"):
        implicit.implicit_dataset(_port_ds(ds), negatives=-1)


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_negatives_bitwise_and_rejects_positives(seed):
    """The same draws as the reference's per-user sets, including user 0,
    who rated the whole catalog and keeps the 16th redraw."""
    ds = _log(seed)
    users = np.concatenate([ds.user, np.zeros(50, np.int32)])
    want = jimplicit._sample_negatives(np.random.default_rng(seed), users,
                                       jimplicit._positive_sets(ds.user, ds.item, M), N)
    positives = implicit.PositiveSet(ds.user, ds.item, N)
    got = implicit._sample_negatives(np.random.default_rng(seed), users, positives, N)
    np.testing.assert_array_equal(got, want)
    pos = {(int(u), int(i)) for u, i in zip(ds.user, ds.item)}
    assert not any((int(u), int(n)) in pos for u, n in zip(users, got) if u != 0)
    np.testing.assert_array_equal(positives.contains(ds.user, ds.item), True)
    assert not implicit.PositiveSet(ds.user[:0], ds.item[:0], N).contains(users, got).any()


def _event_batch(module, seed, rated, weighted, num_items):
    rng = np.random.default_rng(seed)
    n = 60
    user = rng.integers(0, 5, n).astype(np.int32)
    item = rng.integers(0, num_items + 2, n).astype(np.int32)  # some past the catalog
    user[:num_items] = 4                        # user 4 clicked every item
    item[:num_items] = np.arange(num_items)
    return module.EventBatch(
        user=user, item=item,
        rating=rng.integers(1, 6, n).astype(np.float32) if rated else None,
        weight=rng.random(n).astype(np.float32) if weighted else None)


@pytest.mark.parametrize("rated,weighted", [(True, False), (False, False), (True, True)])
def test_implicit_event_batch_matches_reference(rated, weighted):
    """Small catalog, so rows clash and redraw one at a time; user 4 clicked
    the whole catalog and exhausts its 16 redraws."""
    num_items = 6
    want = jimplicit.implicit_event_batch(
        _event_batch(jstream, 1, rated, weighted, num_items), num_items=num_items, alpha=3.0,
        negatives=4, rng=np.random.default_rng(5))
    got = implicit.implicit_event_batch(
        _event_batch(stream, 1, rated, weighted, num_items), num_items=num_items, alpha=3.0,
        negatives=4, rng=np.random.default_rng(5))
    for field in ("user", "item", "rating", "weight"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def test_implicit_microbatches_from_stripped_stream_match_reference():
    def batches(module, wl):
        source = module.PoissonSource(40, 30, seed=2, new_user_prob=0.05, new_item_prob=0.05)
        return list(wl.implicit_microbatches(wl.strip_ratings(source), 64, num_items=30,
                                             alpha=2.0, negatives=2, seed=9, max_events=300,
                                             half_life_s=0.01))

    want, got = batches(jstream, jimplicit), batches(stream, implicit)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for field in ("user", "item", "rating", "weight"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))


# ---------------------------------------------------------------------------
# BPR: the oracle, the step, the epoch, the sampler
# ---------------------------------------------------------------------------


def _params_np(seed, variant, grid=True):
    rng = np.random.default_rng(seed)
    draw = (lambda shape: _grid(rng, shape)) if grid else (
        lambda shape: rng.normal(0, 0.3, shape).astype(np.float32))
    out = {"p": draw((M, K)), "q": draw((N, K)), "user_bias": None, "item_bias": None,
           "global_mean": None, "implicit": None}
    if variant == "bias":
        out.update(user_bias=draw((M, 1)), item_bias=draw((N, 1)),
                   global_mean=np.float32(0.5))
    return out


def _triples_np(seed, b=40):
    """Random triples with a duplicated triple and a pos == neg."""
    rng = np.random.default_rng(seed)
    u, i, j = (rng.integers(0, hi, b).astype(np.int32) for hi in (M, N, N))
    u[1], i[1], j[1] = u[0], i[0], j[0]
    j[2] = i[2]
    return u, i, j


def _ref_params(fields):
    return jmf.MFParams(*(None if fields[name] is None else jnp.asarray(fields[name])
                          for name in jmf.MFParams._fields))


def _port_batch(u, i, j, w=None):
    batch = {"user": torch.as_tensor(u, dtype=torch.int64),
             "pos": torch.as_tensor(i, dtype=torch.int64),
             "neg": torch.as_tensor(j, dtype=torch.int64)}
    if w is not None:
        batch["weight"] = torch.as_tensor(w)
    return batch


@pytest.mark.parametrize("variant", ["funk", "bias"])
@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bpr_train_step_matches_reference(variant, opt_name, weighted):
    fields = _params_np(11, variant, grid=False)
    u, i, j = _triples_np(12)
    w = np.random.default_rng(13).integers(0, 3, u.size).astype(np.float32) if weighted else None
    t_p, t_q, lr = 0.1, 0.12, 0.05
    jopt = JRowOptimizer(name=opt_name)
    jparams = _ref_params(fields)
    jbatch = {"user": jnp.asarray(u), "pos": jnp.asarray(i), "neg": jnp.asarray(j)}
    if weighted:
        jbatch["weight"] = jnp.asarray(w)
    want, want_state, want_m = jbpr.bpr_train_step(
        jparams, jmf.init_opt_state(jparams, jopt), jbatch, jnp.float32(t_p), jnp.float32(t_q),
        jnp.float32(lr), jnp.ones((K,)), opt=jopt, lam=0.02)
    opt = RowOptimizer(name=opt_name)
    params = mf.params_from_numpy(fields, device="cpu")
    state = mf.init_opt_state(params, opt)
    got, got_state, got_m = bpr.bpr_train_step(
        params, state, _port_batch(u, i, j, w), torch.tensor(t_p), torch.tensor(t_q), lr,
        torch.ones(K), opt=opt, lam=0.02)
    for name in ("p", "q", "item_bias", "user_bias"):
        g, wv = getattr(got, name), getattr(want, name)
        assert (g is None) == (wv is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    for name in ("p", "q"):
        for key, value in got_state._asdict()[name].items():
            np.testing.assert_allclose(value.numpy(), np.asarray(want_state._asdict()[name][key]),
                                       rtol=1e-5, atol=1e-5)
    for key in ("abs_err", "work_fraction"):
        assert abs(float(got_m[key]) - float(want_m[key])) <= 1e-5, key


@pytest.mark.parametrize("variant", ["funk", "bias"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("t", [T_GRID, 0.0])
def test_bpr_step_on_the_grid_equals_its_oracle(variant, weighted, t):
    """1/8-grid factors, dyadic lr and lam: the step equals the port's
    ``bpr_step_ref`` bitwise and the reference's within 1e-6; at T = 0 it is
    dense (work fraction 1); untouched rows stay bitwise."""
    fields = _params_np(31, variant)
    u, i, j = _triples_np(32)
    w = np.random.default_rng(33).integers(0, 3, u.size).astype(np.float32) if weighted else None
    bias_np = None if variant == "funk" else fields["item_bias"][:, 0]
    want_p, want_q, want_b, want_loss = jref.bpr_step_ref(
        fields["p"], fields["q"], u, i, j, t, t, lr=LR, lam=LAM, item_bias=bias_np, weight=w)
    plain = ref.bpr_step_ref(
        torch.tensor(fields["p"]), torch.tensor(fields["q"]), *(
            torch.as_tensor(x, dtype=torch.int64) for x in (u, i, j)), t, t, lr=LR, lam=LAM,
        item_bias=None if bias_np is None else torch.tensor(bias_np),
        weight=None if w is None else torch.tensor(w))
    opt = RowOptimizer(name="sgd")
    params = mf.params_from_numpy(fields, device="cpu")
    got, _, metrics = bpr.bpr_train_step(
        params, mf.init_opt_state(params, opt), _port_batch(u, i, j, w), torch.tensor(t),
        torch.tensor(t), LR, torch.ones(K), opt=opt, lam=LAM)
    assert torch.equal(got.p, plain[0]) and torch.equal(got.q, plain[1])
    np.testing.assert_allclose(got.p.numpy(), want_p, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.q.numpy(), want_q, rtol=0, atol=1e-6)
    if variant == "bias":
        assert torch.equal(got.item_bias[:, 0], plain[2])
        np.testing.assert_allclose(got.item_bias[:, 0].numpy(), want_b, rtol=0, atol=1e-6)
    assert abs(float(metrics["abs_err"]) - plain[3]) <= 1e-6
    assert abs(float(metrics["abs_err"]) - want_loss) <= 1e-6
    if t == 0.0:
        assert float(metrics["work_fraction"]) == 1.0
    untouched_u = np.setdiff1d(np.arange(M), u)
    untouched_q = np.setdiff1d(np.arange(N), np.concatenate([i, j]))
    np.testing.assert_array_equal(got.p.numpy()[untouched_u], fields["p"][untouched_u])
    np.testing.assert_array_equal(got.q.numpy()[untouched_q], fields["q"][untouched_q])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bpr_weight_zero_triples_are_bitwise_inert(seed):
    rng = np.random.default_rng(seed)
    fields = _params_np(int(rng.integers(0, 2**31)), "funk")
    b = 8
    u = rng.permutation(M)[:b].astype(np.int32)
    perm = rng.permutation(N)   # disjoint pos/neg pools: a dead triple shares no row
    i, j = perm[:b].astype(np.int32), perm[b:2 * b].astype(np.int32)
    keep = rng.integers(0, 2, b).astype(np.float32)
    opt = RowOptimizer(name="sgd")
    params = mf.params_from_numpy(fields, device="cpu")
    got, _, _ = bpr.bpr_train_step(params, mf.init_opt_state(params, opt),
                                   _port_batch(u, i, j, keep), torch.tensor(T_GRID),
                                   torch.tensor(T_GRID), LR, torch.ones(K), opt=opt, lam=LAM)
    dead = keep == 0.0
    np.testing.assert_array_equal(got.p.numpy()[u[dead]], fields["p"][u[dead]])
    np.testing.assert_array_equal(got.q.numpy()[i[dead]], fields["q"][i[dead]])
    np.testing.assert_array_equal(got.q.numpy()[j[dead]], fields["q"][j[dead]])


def _bpr_log():
    return _log(4, n=96, full_user=False)


@pytest.mark.parametrize("seed,epoch", [(5, 0), (5, 2), (9, 1)])
def test_bpr_sampler_triples_match_reference(seed, epoch):
    ds = _log(seed, n=150)   # user 0 rated everything: their negatives are the 16th draw
    want = jbpr.BPRSampler(ds, batch_size=32, seed=seed).epoch_triples(epoch)
    sampler = bpr.BPRSampler(_port_ds(ds), batch_size=32, seed=seed, device="cpu")
    got = sampler.epoch_triples(epoch)
    assert sampler.num_steps == want["user"].shape[0]
    for key in ("user", "pos", "neg"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    tiny = bpr.BPRSampler(_port_ds(_log(0, n=20, full_user=False)), 10_000, device="cpu")
    assert tiny.batch_size == 20 and tiny.num_steps == 1
    empty = ratings.RatingsDataset(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                   np.zeros(0, np.float32), M, N)
    with pytest.raises(ValueError, match="exceeds"):
        bpr.BPRSampler(empty, 4, device="cpu").epoch_triples(0)


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
def test_bpr_epoch_scan_equals_folded_steps(opt_name):
    sampler = bpr.BPRSampler(_port_ds(_bpr_log()), batch_size=24, seed=9, device="cpu")
    triples = sampler.epoch_triples(0)
    opt = RowOptimizer(name=opt_name)
    args = (torch.tensor(T_GRID), torch.tensor(T_GRID), 0.05, torch.ones(K))
    fields = _params_np(61, "bias")
    want = mf.params_from_numpy(fields, device="cpu")
    want_state = mf.init_opt_state(want, opt)
    errs = []
    for step in range(triples["user"].shape[0]):
        batch = {key: value[step] for key, value in triples.items()}
        want, want_state, m = bpr.bpr_train_step(want, want_state, batch, *args, opt=opt,
                                                 lam=LAM)
        errs.append(m["abs_err"])
    got = mf.params_from_numpy(fields, device="cpu")
    got, _, metrics = bpr.bpr_epoch_scan(got, mf.init_opt_state(got, opt), triples, *args,
                                         opt=opt, lam=LAM)
    assert torch.equal(got.p, want.p) and torch.equal(got.q, want.q)
    assert torch.equal(got.item_bias, want.item_bias)
    assert float(metrics["abs_err"]) == float(sum(errs) / len(errs))


# ---------------------------------------------------------------------------
# the trainer under the implicit and BPR objectives
# ---------------------------------------------------------------------------


def _split():
    tr, te = jratings.train_test_split(
        jratings.synthetic_ratings(num_users=120, num_items=90, num_ratings=3000, seed=0),
        0.2, seed=1)
    return (tr, te), (_port_ds(tr), _port_ds(te))


class _PortOrder:
    """Feeds the reference's scan-mode epoch the port's batch order (numpy's
    ``epoch_permutation``), which its ``jax.random`` reshuffle cannot give."""

    def __init__(self, packed):
        self.packed = packed

    def epoch_batches(self, seed, epoch):
        out = self.packed.epoch_batches(seed, epoch)
        return {key: jnp.asarray(value.numpy().astype(np.int32) if value.dtype == torch.int64
                                 else value.numpy()) for key, value in out.items()}


TRAINER_CASES = {
    # implicit through the fused kernel with its weight column (confidence
    # 1 + 4 r); sgd at lr 0.01 as the explicit parity tests train
    "implicit-funk-sgd-fused": dict(objective="implicit", implicit_alpha=4.0,
                                    implicit_negatives=2, optimizer="sgd",
                                    use_fused_kernel=True, lr=0.01),
    # adagrad normalises the near-zero gradients of the preference-0 rows,
    # and its rounding reaches 1.5e-6 in the thresholds; bias trains with sgd
    "implicit-bias-sgd-fused": dict(objective="implicit", implicit_alpha=4.0,
                                    implicit_negatives=2, variant="bias", optimizer="sgd",
                                    use_fused_kernel=True, lr=0.01),
    "bpr-funk-sgd": dict(objective="bpr", optimizer="sgd", lr=0.05),
    "bpr-bias-adagrad": dict(objective="bpr", variant="bias"),
}


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_trainer_objectives_match_reference(case):
    """Same log, initial factors and batch order (implicit: the port's
    order fed to the reference's scan; bpr: both samplers draw the same
    triples): identical perm and thresholds within 1e-6, epoch records
    within 1e-4 relative, HR/NDCG/recall within 1e-6."""
    (tr, te), (ptr, pte) = _split()
    kw = dict(k=K, epochs=3, batch_size=128, pruning_rate=0.3, ranking_topk=5,
              **TRAINER_CASES[case])
    ref_t = jtrainer.DPMFTrainer(jtrainer.TrainConfig(**kw), tr, te)
    init = {name: None if v is None else np.asarray(v) for name, v in ref_t.params._asdict().items()}
    port = trainer.DPMFTrainer(trainer.TrainConfig(**kw), ptr, pte, device="cpu")
    _assert_ds_equal(port.train_ds, ref_t.train_ds)
    _assert_ds_equal(port.test_ds, ref_t.test_ds)
    if kw["objective"] == "implicit":
        np.testing.assert_array_equal(port._packed_train.weight.numpy(),
                                      np.asarray(ref_t._packed_train.weight))
        ref_t._packed_train = _PortOrder(port._packed_train)
    port.params = mf.params_from_numpy(init, device="cpu")
    port.opt_state = mf.init_opt_state(port.params, port.opt)
    before = fused_mf_sgd.launches
    want = ref_t.run()
    got = port.run()
    np.testing.assert_array_equal(port.perm.numpy(), np.asarray(ref_t.perm))
    for a, b in ((port.t_p, ref_t.t_p), (port.t_q, ref_t.t_q)):
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))
    for g, w in zip(got, want):
        for field in ("train_abs_err", "test_mae", "work_fraction"):
            gv, wv = getattr(g, field), getattr(w, field)
            if kw["objective"] == "bpr" and field == "test_mae":
                assert np.isnan(gv) and np.isnan(wv)
                continue
            assert abs(gv - wv) <= 1e-4 * max(abs(wv), 1e-12), (field, g, w)
        for field in ("hr", "ndcg", "recall"):
            assert abs(getattr(g, field) - getattr(w, field)) <= 1e-6, (field, g, w)
    assert got[0].work_fraction == 1.0 and got[-1].work_fraction < 1.0
    # the CPU route of the kernel counts no launch
    assert fused_mf_sgd.launches == before
    if kw["objective"] == "bpr":
        assert got[-1].train_abs_err < got[0].train_abs_err
        assert np.isnan(port.evaluate())


@pytest.mark.parametrize("change,train,error", [
    (dict(objective="pointwise"), True, "unknown objective"),
    (dict(objective="implicit", epoch_mode="python"), True, "scan"),
    (dict(objective="bpr", variant="svdpp"), True, "svdpp"),
    (dict(objective="bpr"), False, "train_ds"),
    (dict(objective="implicit", store_dir="/nonexistent"), True, "explicit objective"),
])
def test_trainer_objective_validation_matches_reference(change, train, error):
    (tr, te), (ptr, pte) = _split()
    with pytest.raises(ValueError, match=error) as want:
        jtrainer.DPMFTrainer(jtrainer.TrainConfig(k=4, **change), tr if train else None, te)
    with pytest.raises(ValueError, match=error) as got:
        trainer.DPMFTrainer(trainer.TrainConfig(k=4, **change), ptr if train else None, pte,
                            device="cpu")
    assert str(got.value) == str(want.value)
