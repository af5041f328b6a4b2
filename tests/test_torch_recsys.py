"""The port's recsys models (FM, DLRM, SASRec, BST), their layers and their
click data held against the JAX reference on the CPU, from the same numpy
weights and batches, at the configs' smoke sizes.

Tolerances: bitwise for the click batches (the same numpy calls);
1e-6 for ``embedding_bag``; 1e-5 (relative and absolute) for the layers,
each forward and retrieval, each loss and its gradient (float32 sums taken
in another order by XLA and by PyTorch); at rate 0 the kernel route of the
retrievals against the dense route bitwise on 1/8-grid weights.  The
reference's kernel route runs its Pallas kernel with ``interpret=True``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bst_arch, dlrm_mlperf, fm_arch, sasrec_arch
from repro.data import clicks as jclicks
from repro.models import layers as jlayers
from repro.models import recsys as jrecsys
from repro_torch.data import clicks
from repro_torch.kernels import pruned_matmul
from repro_torch.models import layers, recsys

TOL = 1e-5
BATCH = 16


def _port_cfg(jcfg, cls):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls) if f.name != "dtype"}
    return cls(**fields)


def _numpy_tree(tree, rng, fill_zeros=True):
    """The reference's tree as numpy; arrays that are all zeros (biases,
    FM's linear weights) get small normal values, so they count."""
    def leaf(a):
        a = np.array(a)
        if fill_zeros and not a.any():
            a = rng.normal(0, 0.05, a.shape).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(leaf, tree)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _grads_close(got_tree, want_tree):
    flat_got = jax.tree_util.tree_leaves(got_tree)
    flat_want = jax.tree_util.tree_leaves(want_tree)
    assert len(flat_got) == len(flat_want)
    for got, want in zip(flat_got, flat_want):
        _close(got, want)


def _port_grads(params):
    """The port's parameter tree's ``.grad``s as numpy, in the tree's layout."""
    return jax.tree_util.tree_map(lambda t: t.grad.numpy(), params,
                                  is_leaf=lambda x: isinstance(x, torch.Tensor))


def _requires_grad(params):
    for t in jax.tree_util.tree_leaves(params, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        t.requires_grad_(True)
    return params


# -- click data --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_click_batches_are_bitwise_the_reference(seed):
    cases = [
        ("criteo_batch", dict(n_dense=13, vocab_sizes=(50, 7, 100000, 3))),
        ("fm_batch", dict(n_fields=8, vocab_per_field=100)),
        ("sasrec_batch", dict(seq_len=12, n_items=500)),
        ("bst_batch", dict(seq_len=8, n_items=500, n_profile=4)),
    ]
    for name, kw in cases:
        got = getattr(clicks, name)(37, seed=seed, **kw)
        want = getattr(jclicks, name)(37, seed=seed, **kw)
        assert set(got) == set(want), name
        for key in want:
            assert got[key].dtype == want[key].dtype, (name, key)
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name}/{key}")


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_layers_match_reference(activation):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 7, 12)).astype(np.float32)
    p = {"wi": rng.normal(size=(12, 20)).astype(np.float32),
         "bi": rng.normal(size=(20,)).astype(np.float32),
         "wo": rng.normal(size=(20, 9)).astype(np.float32),
         "bo": rng.normal(size=(9,)).astype(np.float32)}
    _close(layers.mlp(_t(x), {k: _t(v) for k, v in p.items()}, activation),
           jlayers.mlp(jnp.asarray(x), _jax_tree(p), activation))
    _close(layers.dense(_t(x), _t(p["wi"])), jlayers.dense(jnp.asarray(x), jnp.asarray(p["wi"])))
    scale, bias = rng.normal(size=12).astype(np.float32), rng.normal(size=12).astype(np.float32)
    _close(layers.layer_norm(_t(x), _t(scale), _t(bias)),
           jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    table, ids = rng.normal(size=(30, 4)).astype(np.float32), rng.integers(0, 30, (3, 5))
    np.testing.assert_array_equal(layers.embed_lookup(_t(table), _t(ids)).numpy(),
                                  np.asarray(jlayers.embed_lookup(jnp.asarray(table),
                                                                  jnp.asarray(ids))))
    gen = torch.Generator().manual_seed(0)
    init = layers.init_dense(gen, 12, 20, bias=True, device="cpu")
    assert init["w"].shape == (12, 20) and not init["b"].any()
    assert abs(float(init["w"].std()) - (2.0 / 32) ** 0.5) < 0.1


# -- embedding_bag ----------------------------------------------------------

@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(combiner, weighted):
    rng = np.random.default_rng(2)
    table = rng.normal(size=(40, 6)).astype(np.float32)
    values = rng.integers(0, 40, 90)
    segments = np.sort(rng.integers(0, 12, 90))  # bag 11 may be empty
    segments[segments == 5] = 6                  # bag 5 is empty
    weights = rng.uniform(0.1, 2.0, 90).astype(np.float32) if weighted else None
    got = recsys.embedding_bag(_t(table), _t(values), _t(segments), 12, combiner=combiner,
                               weights=None if weights is None else _t(weights))
    want = jrecsys.embedding_bag(jnp.asarray(table), jnp.asarray(values), jnp.asarray(segments),
                                 12, combiner=combiner,
                                 weights=None if weights is None else jnp.asarray(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_embedding_bag_sum_gradient_is_the_gather():
    rng = np.random.default_rng(3)
    table = _t(rng.normal(size=(20, 4)).astype(np.float32)).requires_grad_(True)
    values, segments = _t(rng.integers(0, 20, 30)), _t(np.sort(rng.integers(0, 5, 30)))
    upstream = _t(rng.normal(size=(5, 4)).astype(np.float32))
    (recsys.embedding_bag(table, values, segments, 5) * upstream).sum().backward()
    want = torch.zeros(20, 4).index_add_(0, values, upstream[segments])
    np.testing.assert_allclose(table.grad.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_embedding_bag_rejects_unknown_combiner():
    with pytest.raises(ValueError, match="unknown combiner"):
        recsys.embedding_bag(torch.zeros(3, 2), torch.zeros(1, dtype=torch.long),
                             torch.zeros(1, dtype=torch.long), 1, combiner="prod")


# -- the four models ----------------------------------------------------------

@pytest.fixture(scope="module")
def fm():
    jcfg = fm_arch.smoke_config()
    rng = np.random.default_rng(10)
    tree = _numpy_tree(jrecsys.init_fm_params(jax.random.PRNGKey(0), jcfg), rng)
    batch = jclicks.fm_batch(BATCH, n_fields=jcfg.n_fields, vocab_per_field=jcfg.vocab_per_field,
                             seed=1)
    return jcfg, _port_cfg(jcfg, recsys.FMConfig), tree, batch


@pytest.fixture(scope="module")
def dlrm():
    jcfg = dlrm_mlperf.smoke_config()
    rng = np.random.default_rng(11)
    tree = _numpy_tree(jrecsys.init_dlrm_params(jax.random.PRNGKey(1), jcfg), rng)
    batch = jclicks.criteo_batch(BATCH, n_dense=jcfg.n_dense, vocab_sizes=jcfg.vocab_sizes, seed=2)
    return jcfg, _port_cfg(jcfg, recsys.DLRMConfig), tree, batch


@pytest.fixture(scope="module")
def sasrec():
    jcfg = sasrec_arch.smoke_config()
    rng = np.random.default_rng(12)
    tree = _numpy_tree(jrecsys.init_sasrec_params(jax.random.PRNGKey(2), jcfg), rng)
    batch = jclicks.sasrec_batch(BATCH, seq_len=jcfg.seq_len, n_items=jcfg.n_items, seed=3)
    return jcfg, _port_cfg(jcfg, recsys.SASRecConfig), tree, batch


@pytest.fixture(scope="module")
def bst():
    jcfg = bst_arch.smoke_config()
    rng = np.random.default_rng(13)
    tree = _numpy_tree(jrecsys.init_bst_params(jax.random.PRNGKey(3), jcfg), rng)
    batch = jclicks.bst_batch(BATCH, seq_len=jcfg.seq_len, n_items=jcfg.n_items,
                              n_profile=jcfg.n_profile, seed=4)
    return jcfg, _port_cfg(jcfg, recsys.BSTConfig), tree, batch


def test_params_round_trip_keeps_keys_and_values(dlrm):
    _, _, tree, _ = dlrm
    back = recsys.recsys_params_to_numpy(recsys.recsys_params_from_numpy(tree, "cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model,init,cfg_of", [
    ("fm", recsys.init_fm_params, fm_arch.smoke_config),
    ("dlrm", recsys.init_dlrm_params, dlrm_mlperf.smoke_config),
    ("sasrec", recsys.init_sasrec_params, sasrec_arch.smoke_config),
    ("bst", recsys.init_bst_params, bst_arch.smoke_config),
])
def test_init_has_the_reference_tree(model, init, cfg_of):
    """The port's init draws its own numbers, into the reference's keys,
    nesting, shapes and dtypes."""
    jcfg = cfg_of()
    jinit = getattr(jrecsys, init.__name__)
    cls = {"fm": recsys.FMConfig, "dlrm": recsys.DLRMConfig, "sasrec": recsys.SASRecConfig,
           "bst": recsys.BSTConfig}[model]
    got = recsys.recsys_params_to_numpy(init(torch.Generator().manual_seed(0),
                                             _port_cfg(jcfg, cls), device="cpu"))
    want = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.isfinite(g).all()
        # zeros, ones and random draws at the reference's scale
        assert abs(float(g.std()) - float(w.std())) <= 0.5 * float(w.std()) + 1e-6


@pytest.mark.parametrize("t_v", [0.0, fm_arch.PRUNE_T])
def test_fm_forward_loss_and_gradient_match_reference(fm, t_v):
    jcfg, cfg, tree, batch = fm
    params = _requires_grad(recsys.recsys_params_from_numpy(tree, "cpu"))
    tb = {key: _t(value) for key, value in batch.items()}
    _close(recsys.fm_forward(params, tb["ids"], cfg, t_v).detach(),
           jrecsys.fm_forward(_jax_tree(tree), jnp.asarray(batch["ids"]), jcfg, t_v))
    loss = recsys.fm_loss(params, tb, cfg, t_v)
    loss.backward()
    want_loss, want_grads = jax.value_and_grad(jrecsys.fm_loss)(
        _jax_tree(tree), _jax_tree(batch), jcfg, t_v)
    _close(loss.item(), want_loss)
    _grads_close(_port_grads(params), want_grads)


@pytest.mark.parametrize("t_v", [0.0, fm_arch.PRUNE_T])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_fm_retrieval_matches_reference(fm, t_v, use_kernel):
    jcfg, cfg, tree, _ = fm
    rng = np.random.default_rng(20)
    user_ids = rng.integers(0, jcfg.vocab_per_field, (5, jcfg.n_fields - 1)).astype(np.int32)
    cand = rng.integers(0, jcfg.vocab_per_field, 37).astype(np.int32)
    params = recsys.recsys_params_from_numpy(tree, "cpu")
    got = recsys.fm_retrieval(params, _t(user_ids), _t(cand), cfg, t_v, use_kernel=use_kernel)
    want = jrecsys.fm_retrieval(_jax_tree(tree), jnp.asarray(user_ids), jnp.asarray(cand), jcfg,
                                t_v, use_kernel=use_kernel, interpret=True)
    assert got.shape == (5, 37) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("t_v", [0.0, dlrm_mlperf.PRUNE_T, 0.1])
def test_dlrm_forward_loss_gradient_and_retrieval_match_reference(dlrm, t_v):
    jcfg, cfg, tree, batch = dlrm
    params = _requires_grad(recsys.recsys_params_from_numpy(tree, "cpu"))
    tb = {key: _t(value) for key, value in batch.items()}
    _close(recsys.dlrm_forward(params, tb["dense"], tb["sparse"], cfg, t_v).detach(),
           jrecsys.dlrm_forward(_jax_tree(tree), jnp.asarray(batch["dense"]),
                                jnp.asarray(batch["sparse"]), jcfg, t_v))
    loss = recsys.dlrm_loss(params, tb, cfg, t_v)
    loss.backward()
    want_loss, want_grads = jax.value_and_grad(jrecsys.dlrm_loss)(
        _jax_tree(tree), _jax_tree(batch), jcfg, t_v)
    _close(loss.item(), want_loss)
    _grads_close(_port_grads(params), want_grads)
    cand = np.arange(jcfg.vocab_sizes[0], dtype=np.int32)
    got = recsys.dlrm_retrieval(params, tb["dense"][:1], tb["sparse"][:1], _t(cand), cfg, t_v)
    want = jrecsys.dlrm_retrieval(_jax_tree(tree), jnp.asarray(batch["dense"][:1]),
                                  jnp.asarray(batch["sparse"][:1]), jnp.asarray(cand), jcfg, t_v)
    _close(got.detach(), want)


def test_dlrm_interaction_order_is_the_reference_triu(dlrm):
    """The top MLP reads the interactions' upper triangle in the order of
    ``jnp.triu_indices``, at the smoke width and at MLPerf's 27 features."""
    _, cfg, _, _ = dlrm
    for f in (cfg.n_sparse + 1, recsys.DLRMConfig().n_sparse + 1):
        iu, ju = np.asarray(jnp.triu_indices(f, k=1))
        got_iu, got_ju = torch.triu_indices(f, f, offset=1)
        np.testing.assert_array_equal(got_iu.numpy(), iu)
        np.testing.assert_array_equal(got_ju.numpy(), ju)


@pytest.mark.parametrize("t_v", [0.0, sasrec_arch.PRUNE_T, 0.01])
def test_sasrec_encode_loss_gradient_match_reference(sasrec, t_v):
    jcfg, cfg, tree, batch = sasrec
    params = _requires_grad(recsys.recsys_params_from_numpy(tree, "cpu"))
    tb = {key: _t(value) for key, value in batch.items()}
    h = recsys.sasrec_encode(params, tb["seq"], cfg)
    _close(h.detach(), jrecsys.sasrec_encode(_jax_tree(tree), jnp.asarray(batch["seq"]), jcfg))
    pad = batch["seq"] == 0
    assert pad.any() and not h.detach().numpy()[pad].any()
    loss = recsys.sasrec_loss(params, tb, cfg)
    loss.backward()
    want_loss, want_grads = jax.value_and_grad(jrecsys.sasrec_loss)(
        _jax_tree(tree), _jax_tree(batch), jcfg)
    _close(loss.item(), want_loss)
    _grads_close(_port_grads(params), want_grads)


@pytest.mark.parametrize("t_v", [0.0, sasrec_arch.PRUNE_T, 0.01])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_cands", [False, True])
def test_sasrec_retrieval_matches_reference(sasrec, t_v, use_kernel, with_cands):
    jcfg, cfg, tree, batch = sasrec
    cand = np.int32([3, 17, 0, 40, 499, 500, 3])
    params = recsys.recsys_params_from_numpy(tree, "cpu")
    got = recsys.sasrec_retrieval(params, _t(batch["seq"]), cfg, t_v, use_kernel=use_kernel,
                                  cand_ids=_t(cand) if with_cands else None)
    want = jrecsys.sasrec_retrieval(_jax_tree(tree), jnp.asarray(batch["seq"]), jcfg, t_v,
                                    use_kernel=use_kernel, interpret=True,
                                    cand_ids=jnp.asarray(cand) if with_cands else None)
    assert got.shape == (BATCH, len(cand) if with_cands else jcfg.n_items + 1)
    _close(got, want)


def test_bst_forward_loss_gradient_and_candidates_match_reference(bst):
    jcfg, cfg, tree, batch = bst
    params = _requires_grad(recsys.recsys_params_from_numpy(tree, "cpu"))
    tb = {key: _t(value) for key, value in batch.items()}
    hist = batch["hist"].copy()
    hist[:3, :2] = 0  # padded history positions
    tb["hist"] = _t(hist)
    jb = dict(batch, hist=hist)
    _close(recsys.bst_forward(params, tb["hist"], tb["target"], tb["profile"], cfg).detach(),
           jrecsys.bst_forward(_jax_tree(tree), jnp.asarray(hist), jnp.asarray(batch["target"]),
                               jnp.asarray(batch["profile"]), jcfg))
    loss = recsys.bst_loss(params, tb, cfg)
    loss.backward()
    want_loss, want_grads = jax.value_and_grad(jrecsys.bst_loss)(_jax_tree(tree), _jax_tree(jb),
                                                                jcfg)
    _close(loss.item(), want_loss)
    _grads_close(_port_grads(params), want_grads)
    # the retrieval_cand form: one history against many candidate targets
    cand = np.arange(1, 65, dtype=np.int32)
    got = recsys.bst_forward(params, tb["hist"][:1].expand(64, -1), _t(cand),
                             tb["profile"][:1].expand(64, -1), cfg)
    want = jrecsys.bst_forward(_jax_tree(tree), jnp.broadcast_to(hist[:1], (64, jcfg.seq_len)),
                               jnp.asarray(cand),
                               jnp.broadcast_to(batch["profile"][:1], (64, jcfg.n_profile)), jcfg)
    _close(got.detach(), want)


def _grid_tree(tree, rng):
    return jax.tree_util.tree_map(
        lambda a: (rng.integers(-16, 17, np.shape(a)) / 8.0).astype(np.float32), tree)


def test_retrievals_at_rate_zero_are_the_dense_model_bitwise(fm, sasrec):
    """At t_v = 0 the kernel route equals the dense route within 1e-5 on
    random weights and bitwise on 1/8-grid weights (every product and sum
    exact)."""
    rng = np.random.default_rng(30)
    jcfg, cfg, tree, _ = fm
    user_ids = _t(rng.integers(0, jcfg.vocab_per_field, (6, jcfg.n_fields - 1)))
    cand = _t(rng.integers(0, jcfg.vocab_per_field, 50))
    for weights, exact in ((tree, False), (_grid_tree(tree, rng), True)):
        params = recsys.recsys_params_from_numpy(weights, "cpu")
        kernel = recsys.fm_retrieval(params, user_ids, cand, cfg, 0.0, use_kernel=True)
        plain = recsys.fm_retrieval(params, user_ids, cand, cfg, 0.0, use_kernel=False)
        if exact:
            np.testing.assert_array_equal(kernel.numpy(), plain.numpy())
        else:
            _close(kernel, plain)
    jcfg, cfg, tree, batch = sasrec
    params = recsys.recsys_params_from_numpy(tree, "cpu")
    seq = _t(batch["seq"])
    _close(recsys.sasrec_retrieval(params, seq, cfg, 0.0, use_kernel=True),
           recsys.sasrec_retrieval(params, seq, cfg, 0.0, use_kernel=False))
    # grid session vectors against a grid table: the scoring itself exact
    h = _t(_grid_tree(np.zeros((5, cfg.embed_dim), np.float32), rng))
    table = _t(_grid_tree(np.zeros((40, cfg.embed_dim), np.float32), rng))
    k = torch.full((5,), cfg.embed_dim, dtype=torch.int32)
    np.testing.assert_array_equal(
        pruned_matmul.pruned_matmul_ranked(h, table, k, torch.full((40,), cfg.embed_dim,
                                                                   dtype=torch.int32)).numpy(),
        (h @ table.T).numpy())


def test_losses_fall_after_one_sgd_step(fm, sasrec):
    """The planted-signal batches are learnable through the port's autograd."""
    for (jcfg, cfg, tree, batch), loss_fn, extra in (
            (fm, recsys.fm_loss, (fm_arch.PRUNE_T,)), (sasrec, recsys.sasrec_loss, ())):
        params = _requires_grad(recsys.recsys_params_from_numpy(tree, "cpu"))
        tb = {key: _t(value) for key, value in batch.items()}
        loss = loss_fn(params, tb, cfg, *extra)
        loss.backward()
        with torch.no_grad():
            for t in jax.tree_util.tree_leaves(params, is_leaf=lambda x: isinstance(x, torch.Tensor)):
                t -= 0.1 * t.grad
        assert loss_fn(params, tb, cfg, *extra).item() < loss.item()


def test_chip_smoke_recsys_phase_rehearses_on_the_cpu():
    """``chip_smoke.py``'s recsys phase end to end on the CPU at a tiny size:
    every check holds except the three card-only launch counts (the CPU path
    launches no kernel)."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    chip_smoke.failures.clear()
    out = chip_smoke.recsys_phase(torch.device("cpu"), dict(
        fm_vocab=64, sr_items=300, bst_items=300, dlrm_cap=256, serve=16, train=64, cands=500,
        rank_cands=64, sessions=40, topk=5, slice=64, check_rows=8, check_vocab=64,
        max_batch=16))
    assert chip_smoke.failures == [
        "pruned_matmul launched twice on the recsys path, by fm_retrieval and sasrec_retrieval (0)",
        "pruned_topk launched once per 16-session chunk by serve_sessions (0 of 3)",
        "add_rows launched 30 times on the recsys path, by gather_rows' gradients: SASRec's "
        "seq, pos and neg, BST's seq, DLRM's tables (0)"]
    chip_smoke.failures.clear()
    assert chip_smoke.PATH_LAUNCHES["recsys"] == {"pruned_matmul": 0, "pruned_topk": 0,
                                                  "add_rows": 0}
    assert out["dlrm_rows"] == sum(chip_smoke.dlrm_vocabs(256))
    # the card's cut: the five tables above 2^23 rows cut to it (PERF.md section 4)
    assert sum(chip_smoke.dlrm_vocabs()) == 46_009_036
    assert sum(chip_smoke.dlrm_vocabs(1 << 62)) == 187_770_572
    assert set(out["card_vs_cpu"]) == {"fm", "sasrec", "bst", "dlrm"}
    assert all(np.isfinite(v) for v in out["losses"].values())


def test_chip_smoke_cells_phase_rehearses_on_the_cpu():
    """``chip_smoke.py``'s cells phase (every ported cell's step once, held
    against the same step on the CPU on slices) and its dpmf serve cell end to end
    on the CPU at tiny sizes, with the configs set to them for the phase
    only: every check holds (the launch counts are checked on the card
    only, and none is made here)."""
    import os
    import sys

    from repro_torch import configs
    from repro_torch.core import mf
    from repro_torch.core.threshold import thresholds_from_matrices

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    chip_smoke.failures.clear()
    chip_smoke.PATH_LAUNCHES.pop("cells", None)
    before = {arch: configs.get_config(arch) for arch in configs.PORTED_ARCHS}
    out = chip_smoke.cells_phase(torch.device("cpu"), dict(
        fm_vocab=64, sr_items=65535, bst_items=300, dlrm_cap=256, train=32, serve=8, bulk=16,
        cands=500, rank_cands=64, slice=64, dpmf_users=4096, dpmf_items=2048, dpmf_batch=1024))
    gen = torch.Generator().manual_seed(0)
    cpu = torch.device("cpu")
    p, q = chip_smoke.decaying_factors(gen, 3000, cpu), chip_smoke.decaying_factors(gen, 2000, cpu)
    served = chip_smoke.dpmf_serve_cell(cpu, mf.MFParams(p, q, None, None, None, None),
                                        *thresholds_from_matrices(p, q, 0.3))
    assert chip_smoke.failures == []
    assert {arch: configs.get_config(arch) for arch in configs.PORTED_ARCHS} == before
    assert set(out) == {"fm", "sasrec", "bst", "dlrm-mlperf", "dpmf"}
    for arch in ("fm", "sasrec", "bst", "dlrm-mlperf"):
        assert set(out[arch]["ms"]) == set(configs.shape_ids(arch))
        assert np.isfinite(out[arch]["loss"])
    assert out["sasrec"]["max_abs_err"]["serve_bulk"] <= 1e-5
    assert out["dpmf"]["max_abs_err"] <= 1e-5 and served["max_abs_err"] <= 1e-5
    assert chip_smoke.PATH_LAUNCHES["cells"] == {"pruned_topk": 0, "pruned_matmul": 0,
                                                 "add_rows": 0}
