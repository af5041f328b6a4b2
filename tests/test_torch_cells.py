"""The port's cells (``repro_torch.configs``) run and held against the
reference's cells on the CPU.

Both packages' arch modules get a small ``CONFIG`` (pytest's
``monkeypatch``): the smoke config, except SASRec's catalog, which holds
131,072 rows (``n_items`` 131,071) so that the reference's 65,536-row
chunks slice it.  Each cell's step takes the same numpy weights
(``recsys_params_from_numpy``) and a batch of a few hundred rows and a few
thousand candidates drawn with numpy from a seed; the reference's step runs
under ``jax.jit``.

Tolerances (float32 sums taken in another order by XLA and by PyTorch):
train cells, the loss and every updated parameter within 1e-5; serve and
retrieval cells within 1e-5; top-k ids identical, and scores and ids
bitwise on 1/8-grid inputs.  FM's and SASRec's retrievals take the port's
kernel route (``pruned_matmul``'s plain version here) against the
reference's ``use_kernel=False``.

The LM cells (gemma-7b, qwen1.5-4b, qwen3-4b, deepseek-v2-lite-16b,
granite-moe-1b-a400m): ``train_4k``, ``prefill_32k`` and ``decode_32k`` at
each arch's smoke config (2 or 3 layers, d 64, float32; the MoE archs
dropless) on 2 x 16 tokens, from the same numpy weights: the train
step's loss within 1e-5 and Adam's first step by
``chip_smoke.adam_first_step``; prefill's last logits, and one decode step's
logits and caches (written in place), within 1e-5.

gat-cora: ``full_graph_sm`` and ``molecule`` at their published widths and
counts, one Adam step: the loss within 1e-5 of the reference's; the
gradients (from Adam's moments) within 1e-5 of each leaf's largest; the
weights within 1e-5 of the reference's, plus the slack that tolerance
allows near g = 0, and of Adam's step from their own moments
(``chip_smoke.adam_first_step``).

dpmf: ``train_1m`` and ``serve_top100`` at the smoke size; one
``train_1m_sm`` and one ``train_1m_smc`` step on 4 gloo ranks (a (2, 2)
mesh) against the reference's jitted step on 4 of 8 forced host devices,
in a subprocess, at the tolerances of ``test_torch_multirank.py`` (mode
none 2e-8 + 1e-6 relative; int8 with adagrad: at most one element in 64,
and at least 2, off by up to one int8 step).  The recsys layouts: ``shard_tree`` / ``assemble_tree``
with ``recsys_spec_fn`` on 4 gloo ranks, bitwise.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_multirank_cases as cases
from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.distributed import sharding as jsharding
from repro_torch import configs, tree
from repro_torch.configs import base
from repro_torch.data import clicks
from repro_torch.distributed import sharding
from repro_torch.models import recsys
from repro_torch.testing.ranks import RankPool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
ROWS, CANDS = 256, 2048
RECSYS = ("fm", "sasrec", "bst", "dlrm-mlperf")
RECSYS_CELLS = [(arch, sid) for arch in RECSYS for sid in jconfigs.shape_ids(arch)]


def _port_cfg(jcfg, cls):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls) if f.name != "dtype"}
    return cls(**fields)


def _small(monkeypatch, arch):
    """Both packages' ``CONFIG`` of ``arch`` set to its small config; the
    reference's."""
    jmod, pmod = jconfigs.get_module(arch), configs.get_module(arch)
    jcfg = jmod.smoke_config()
    if arch == "sasrec":
        jcfg = dataclasses.replace(jcfg, n_items=131_071)
    monkeypatch.setattr(jmod, "CONFIG", jcfg)
    monkeypatch.setattr(pmod, "CONFIG", _port_cfg(jcfg, type(pmod.CONFIG)))
    return jcfg


def _weights(jmod, seed):
    """The reference's init as numpy; all-zero leaves (biases, FM's linear
    weights) get small normal values, so they count."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.array(a)
        return rng.normal(0, 0.05, a.shape).astype(a.dtype) if not a.any() else a

    return jax.tree_util.tree_map(leaf, jmod._init(jax.random.PRNGKey(seed)))


def _batch(arch, cfg, specs, seed):
    """A numpy batch with the keys, dtypes and row counts of the cell's
    abstract batch: ``ROWS`` rows (1 for a retrieval's context) and
    ``CANDS`` candidates."""
    rng = np.random.default_rng(seed)
    if arch == "fm":
        full = clicks.fm_batch(ROWS, n_fields=cfg.n_fields, vocab_per_field=cfg.vocab_per_field,
                               seed=seed)
        lo, hi = 0, cfg.vocab_per_field
    elif arch == "sasrec":
        full = clicks.sasrec_batch(ROWS, seq_len=cfg.seq_len, n_items=cfg.n_items, seed=seed)
        lo, hi = 1, cfg.n_items + 1
    elif arch == "bst":
        full = clicks.bst_batch(ROWS, seq_len=cfg.seq_len, n_items=cfg.n_items,
                                n_profile=cfg.n_profile, seed=seed)
        lo, hi = 1, cfg.n_items + 1
    else:
        full = clicks.criteo_batch(ROWS, n_dense=cfg.n_dense, vocab_sizes=cfg.vocab_sizes,
                                   seed=seed)
        lo, hi = 0, cfg.vocab_sizes[0]
    out = {}
    for key, spec in specs.items():
        if key == "cand_ids":
            out[key] = rng.integers(lo, hi, CANDS)
        elif key == "user_ids":
            out[key] = full["ids"][:1, :spec.shape[1]]
        else:
            out[key] = full[key][:1] if spec.shape[0] == 1 else full[key]
        out[key] = out[key].astype(np.dtype(spec.dtype))
    return out


def _leaves_by_path(t, port):
    if port:
        out = {}
        tree.map_with_path(t, lambda parts, leaf: out.__setitem__(tuple(parts), leaf))
        return {path: leaf.detach().numpy() for path, leaf in out.items()}
    flat, _ = jax.tree_util.tree_flatten_with_path(t)
    return {tuple(jsharding._path_parts(path)): np.asarray(leaf) for path, leaf in flat}


def _chip_smoke():
    """The repo root's ``chip_smoke.py`` as a module (its checks' helpers)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# the recsys cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,sid", RECSYS_CELLS, ids=["::".join(c) for c in RECSYS_CELLS])
def test_recsys_cell_step_matches_reference(monkeypatch, arch, sid):
    jcfg = _small(monkeypatch, arch)
    jcell, cell = jconfigs.build_cell(arch, sid), configs.build_cell(arch, sid)
    seed = RECSYS_CELLS.index((arch, sid))
    weights = _weights(jconfigs.get_module(arch), seed)
    batch = _batch(arch, jcfg, jcell.abstract_args[1], seed + 100)
    want = jax.jit(jcell.step_fn)(jax.tree_util.tree_map(jnp.asarray, weights),
                                  {key: jnp.asarray(v) for key, v in batch.items()})
    params = recsys.recsys_params_from_numpy(weights, device="cpu")
    got = cell.step_fn(params, {key: torch.as_tensor(v) for key, v in batch.items()})
    if cell.kind == "train":
        new_params, loss = got
        assert new_params is params  # updated in place
        _close(loss, want[1], what="loss")
        got_p, want_p = _leaves_by_path(new_params, True), _leaves_by_path(want[0], False)
        assert set(got_p) == set(want_p)
        start = _leaves_by_path(weights, False)
        for path, value in got_p.items():
            _close(value, want_p[path], what=str(path))
        assert any(not np.array_equal(value, start[path]) for path, value in got_p.items())
    elif isinstance(want, tuple):  # SASRec's top-100 over the catalog
        scores, ids = got
        assert scores.dtype == torch.float32 and ids.dtype == torch.int32
        _close(scores, want[0], what="scores")
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want[1]))
    else:
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, what=sid)


def test_streaming_topk_scores_is_the_reference_bitwise_on_the_grid():
    rng = np.random.default_rng(7)
    h = (rng.integers(-16, 17, (64, 16)) / 8).astype(np.float32)
    table = (rng.integers(-16, 17, (3 * 4096 + 100, 16)) / 8).astype(np.float32)
    got_s, got_i = base.streaming_topk_scores(torch.as_tensor(h), torch.as_tensor(table), k=50,
                                              chunk=4096)
    want_s, want_i = jbase.streaming_topk_scores(jnp.asarray(h), jnp.asarray(table), k=50,
                                                 chunk=4096)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # only the first max(V // chunk, 1) * chunk rows are scored
    assert int(got_i.max()) < 3 * 4096
    # grid ties everywhere: the lower item index first, as the reference
    order = np.lexsort((got_i.numpy(), -got_s.numpy()), axis=1)
    np.testing.assert_array_equal(order, np.broadcast_to(np.arange(50), order.shape))
    with pytest.raises(ValueError, match="fewer than one"):
        base.streaming_topk_scores(torch.as_tensor(h), torch.as_tensor(table[:4000]), chunk=4096)


# ---------------------------------------------------------------------------
# the LM cells (dense, MLA and MoE transformers)
# ---------------------------------------------------------------------------

LM_ARCHS = ("gemma-7b", "qwen1.5-4b", "qwen3-4b", "deepseek-v2-lite-16b", "granite-moe-1b-a400m")
LM_CELLS = [(arch, sid) for arch in LM_ARCHS for sid in ("train_4k", "prefill_32k", "decode_32k")]


def _lm_small(monkeypatch, arch):
    """Both packages' ``CONFIG`` of ``arch`` set to its smoke config (2
    layers, d 64, float32); the reference's."""
    jmod, pmod = jconfigs.get_module(arch), configs.get_module(arch)
    monkeypatch.setattr(jmod, "CONFIG", jmod.smoke_config())
    monkeypatch.setattr(pmod, "CONFIG", pmod.smoke_config())
    return jmod.CONFIG


@pytest.mark.parametrize("arch,sid", LM_CELLS, ids=["::".join(c) for c in LM_CELLS])
def test_lm_cell_step_matches_reference(monkeypatch, arch, sid):
    """A cell's step at the smoke config on 2 x 16 tokens (labels the next
    token, some masked) from the same numpy weights: train (one Adam step
    in place, lr 3e-4: the loss within 1e-5, Adam's first step by
    ``chip_smoke.adam_first_step``), prefill (the last logits within 1e-5)
    and decode (a cache of 16 positions holding 5, drawn with numpy, the
    leading dense layer's too; the logits and the caches within 1e-5,
    written in place)."""
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer

    jcfg = _lm_small(monkeypatch, arch)
    jcell, cell = jconfigs.build_cell(arch, sid), configs.build_cell(arch, sid)
    assert (cell.kind, cell.donate_argnums) == (jcell.kind, jcell.donate_argnums)
    seed = LM_CELLS.index((arch, sid))
    rng = np.random.default_rng(seed)
    weights = jax.tree_util.tree_map(
        lambda a: np.array(a) if np.array(a).any() else rng.normal(0, 0.1, a.shape).astype(
            np.float32), jtfm.init_params(jax.random.PRNGKey(seed), jcfg))
    params = transformer.transformer_params_from_numpy(weights, device="cpu")
    jweights = jax.tree_util.tree_map(jnp.asarray, weights)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    if cell.kind == "train":
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1
        labels[1, :4] = -1
        jstate = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype),
                                        jcell.abstract_args[1])
        want_p, want_s, want_loss = jax.jit(jcell.step_fn)(
            jweights, jstate, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
        state = tree.map_leaves(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                                cell.abstract_args[1])
        start = tree.map_leaves(lambda t: t.clone(), (params, state))
        got_p, got_s, loss = cell.step_fn(params, state, {"tokens": torch.as_tensor(tokens),
                                                          "labels": torch.as_tensor(labels)})
        assert got_p is params and got_s is state
        _close(loss, want_loss, what="loss")
        assert int(state["t"]) == int(want_s["t"]) == 1
        ok, errs = _chip_smoke().adam_first_step(
            start, (params, state),
            tree.map_leaves(lambda _, w: torch.as_tensor(np.array(w)), (params, state),
                            (want_p, want_s)), 3e-4, TOL)
        assert ok, errs
    elif cell.kind == "prefill":
        want = jax.jit(jcell.step_fn)(jweights, jnp.asarray(tokens))
        got = cell.step_fn(params, torch.as_tensor(tokens))
        assert not got.requires_grad
        _close(got, want, what="prefill")
    else:
        state = transformer.init_decode_state(configs.get_config(arch), 2, 16, length=5,
                                              device="cpu")
        drawn = tree.map_leaves(lambda t: rng.normal(0, 1, tuple(t.shape)).astype(np.float32),
                                (state.caches.k, state.caches.v,
                                 [(c.k, c.v) for c in state.first_caches]))
        jstate = jtfm.DecodeState(
            caches=jtfm.KVCache(jnp.asarray(drawn[0]), jnp.asarray(drawn[1]), jnp.int32(5)),
            first_caches=tuple(jtfm.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.int32(5))
                               for k, v in drawn[2]))
        tree.map_leaves(lambda t, a: t.copy_(torch.as_tensor(a)),
                        (state.caches.k, state.caches.v,
                         [(c.k, c.v) for c in state.first_caches]), drawn)
        want_logits, want_state = jax.jit(jcell.step_fn)(jweights, jstate, jnp.asarray(tokens[:, :1]))
        logits, new_state = cell.step_fn(params, state, torch.as_tensor(tokens[:, :1]))
        _close(logits, want_logits, what="logits")
        assert new_state.caches.k is state.caches.k  # in place (donated)
        assert int(new_state.caches.length) == int(want_state.caches.length) == 6
        _close(new_state.caches.k, want_state.caches.k, what="k")
        _close(new_state.caches.v, want_state.caches.v, what="v")
        for got, want in zip(new_state.first_caches, want_state.first_caches, strict=True):
            _close(got.k, want.k, what="first k")
            _close(got.v, want.v, what="first v")


# ---------------------------------------------------------------------------
# gat-cora
# ---------------------------------------------------------------------------


def _graph_cell_batch(sid, a_batch, seed):
    """``sid``'s batch at the cell's own counts (Cora: 2,708 nodes and 10,556
    edges; 128 molecules of 30 nodes and 64 edges), padded to the cell's
    shapes: nodes with label -1, edges (0, 0) with mask 0."""
    from repro_torch.data import graphs

    d_feat = a_batch["features"].shape[1]
    if sid == "molecule":
        mols = [graphs.synthetic_graph(30, 34, d_feat, 8, seed=seed + i) for i in range(128)]
        real = graphs.batch_molecules(mols, 30, 64)
    else:
        g = graphs.synthetic_graph(2708, 10556 - 2708, d_feat, 7, seed=seed)
        real = {"features": g.features, "edges": g.edges, "labels": g.labels,
                "edge_mask": np.ones(len(g.edges), np.float32)}
    n, e = len(real["labels"]), len(real["edges"])
    out = {key: np.zeros(tuple(spec.shape), np.dtype(str(spec.dtype)[6:]))
           for key, spec in a_batch.items()}
    out["labels"][:] = -1
    for key in out:
        out[key][:n if key in ("features", "labels") else e] = real[key]
    return out


@pytest.mark.parametrize("sid", ["full_graph_sm", "molecule"])
def test_gat_cora_cell_step_matches_reference_at_its_counts(sid):
    """The cell at its published widths and counts (Cora's 1,433 features on
    3,072 padded nodes; 128 molecules): one step from the same numpy weights
    and zero Adam state against the reference's jitted ``step_fn``."""
    jcell, cell = jconfigs.build_cell("gat-cora", sid), configs.build_cell("gat-cora", sid)
    a_params, a_opt, a_batch = cell.abstract_args
    rng = np.random.default_rng(7)
    weights = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.05, a.shape).astype(np.float32), jcell.abstract_args[0])
    batch = _graph_cell_batch(sid, a_batch, 40)
    assert batch["labels"][-1] == -1 and (batch["labels"] >= 0).any()
    jstate = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), jcell.abstract_args[1])
    want_p, want_s, want_loss = jax.jit(jcell.step_fn)(
        jax.tree_util.tree_map(jnp.asarray, weights), jstate,
        {key: jnp.asarray(v) for key, v in batch.items()})
    params = tree.map_leaves(lambda t: torch.as_tensor(np.array(t)), weights)
    state = tree.map_leaves(lambda t: torch.zeros(t.shape, dtype=t.dtype), a_opt)
    got_p, got_s, loss = cell.step_fn(params, state, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert got_p is params and got_s is state
    _close(loss, want_loss, what="loss")
    assert int(state["t"]) == int(want_s["t"]) == 1
    # the gradients through Adam's moments (m = 0.1 g, v = 0.001 g^2), and
    # the weights against the reference's and against the moments' own step
    ok, errs = _chip_smoke().adam_first_step(
        tree.map_leaves(lambda _, w: torch.as_tensor(w), (params, state), (weights, state)),
        (params, state),
        tree.map_leaves(lambda _, w: torch.as_tensor(np.array(w)), (params, state), (want_p, want_s)),
        5e-3, TOL)
    assert ok, errs


# ---------------------------------------------------------------------------
# dpmf
# ---------------------------------------------------------------------------


def _dpmf_inputs(cfg, seed, grid=False):
    rng = np.random.default_rng(seed)
    if grid:
        p = (rng.integers(-8, 9, (cfg.num_users, cfg.k)) / 8).astype(np.float32)
        q = (rng.integers(-8, 9, (cfg.num_items, cfg.k)) / 8).astype(np.float32)
    else:
        p = rng.normal(0, 0.1, (cfg.num_users, cfg.k)).astype(np.float32)
        q = rng.normal(0, 0.1, (cfg.num_items, cfg.k)).astype(np.float32)
    return p, q, rng


@pytest.mark.parametrize("t", [0.0, 0.05])
def test_dpmf_train_1m_matches_reference(monkeypatch, t):
    jmod = jconfigs.get_module("dpmf")
    monkeypatch.setattr(jmod, "CONFIG", jmod.smoke_config())
    monkeypatch.setattr(configs.get_module("dpmf"), "CONFIG",
                        configs.get_module("dpmf").smoke_config())
    cfg = jmod.CONFIG
    jcell, cell = jconfigs.build_cell("dpmf", "train_1m"), configs.build_cell("dpmf", "train_1m")
    p, q, rng = _dpmf_inputs(cfg, 1)
    batch = {"user": rng.integers(0, cfg.num_users, 512).astype(np.int32),
             "item": rng.integers(0, cfg.num_items, 512).astype(np.int32),
             "rating": rng.integers(1, 6, 512).astype(np.float32)}
    from repro.core import mf as jmf
    from repro.optim.optimizers import RowOptimizer as JRowOptimizer
    from repro_torch.core import mf
    from repro_torch.optim.optimizers import RowOptimizer

    jparams = jmf.MFParams(jnp.asarray(p), jnp.asarray(q), None, None, None, None)
    jstate = jmf.init_opt_state(jparams, JRowOptimizer(name="adagrad"))
    w_p, w_s, w_m = jax.jit(jcell.step_fn)(jparams, jstate,
                                           {k: jnp.asarray(v) for k, v in batch.items()},
                                           jnp.float32(t), jnp.float32(t))
    params = mf.params_from_numpy({"p": p, "q": q}, device="cpu")
    state = mf.init_opt_state(params, RowOptimizer(name="adagrad"))
    g_p, g_s, g_m = cell.step_fn(params, state, {k: torch.as_tensor(v) for k, v in batch.items()},
                                 torch.tensor(t), torch.tensor(t))
    assert g_p is params and g_s is state
    for got, want in ((g_p.p, w_p.p), (g_p.q, w_p.q), (g_s.p["acc"], w_s.p["acc"]),
                      (g_s.q["acc"], w_s.q["acc"])):
        _close(got, want)
    for key in w_m:
        _close(g_m[key], w_m[key], what=key)


@pytest.mark.parametrize("grid", [False, True])
def test_dpmf_serve_top100_matches_reference(monkeypatch, grid):
    jmod = jconfigs.get_module("dpmf")
    monkeypatch.setattr(jmod, "CONFIG", jmod.smoke_config())
    monkeypatch.setattr(configs.get_module("dpmf"), "CONFIG",
                        configs.get_module("dpmf").smoke_config())
    cfg = jmod.CONFIG
    jcell = jconfigs.build_cell("dpmf", "serve_top100")
    cell = configs.build_cell("dpmf", "serve_top100")
    p, q, rng = _dpmf_inputs(cfg, 2, grid)
    users = rng.integers(0, cfg.num_users, 64).astype(np.int32)
    t = 0.25 if grid else 0.05
    from repro.core import mf as jmf
    from repro_torch.core import mf

    want_s, want_i = jax.jit(jcell.step_fn)(
        jmf.MFParams(jnp.asarray(p), jnp.asarray(q), None, None, None, None),
        jnp.asarray(users), jnp.float32(t), jnp.float32(t))
    got_s, got_i = cell.step_fn(mf.params_from_numpy({"p": p, "q": q}, device="cpu"),
                                torch.as_tensor(users), torch.tensor(t), torch.tensor(t))
    if grid:
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    else:
        _close(got_s, want_s)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


REFERENCE = r'''
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs
from repro.configs import dpmf
from repro.core import mf
from repro.distributed import sharding as S
from repro.distributed.mesh_compat import use_mesh
from repro.optim.optimizers import RowOptimizer

dpmf.CONFIG = dpmf.smoke_config()
cfg = dpmf.CONFIG
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
rng = np.random.default_rng(11)
out = {"p": rng.normal(0, 0.1, (cfg.num_users, cfg.k)).astype(np.float32),
       "q": rng.normal(0, 0.1, (cfg.num_items, cfg.k)).astype(np.float32)}
routed = S.route_batch_to_owner_shards(
    rng.integers(0, cfg.num_users, 96), rng.integers(0, cfg.num_items, 96),
    rng.uniform(1, 5, 96).astype(np.float32), num_users=cfg.num_users, n_dp=2,
    weight=rng.uniform(0.3, 1.0, 96).astype(np.float32))
for key, value in routed.items():
    out["batch_" + key] = value
for sid in ("train_1m_sm", "train_1m_smc"):
    cell = configs.build_cell("dpmf", sid)
    step = jax.jit(cell.step_fn)
    for t in (0.0, 0.05):
        with use_mesh(mesh):
            params = mf.MFParams(jnp.asarray(out["p"]), jnp.asarray(out["q"]), None, None,
                                 None, None)
            state = mf.init_opt_state(params, RowOptimizer(name="adagrad"))
            p2, s2, m2 = step(params, state, {k: jnp.asarray(v) for k, v in routed.items()},
                              jnp.float32(t), jnp.float32(t))
        pre = f"{sid}/{t}/"
        out[pre + "p"], out[pre + "q"] = np.asarray(p2.p), np.asarray(p2.q)
        out[pre + "p_acc"], out[pre + "q_acc"] = np.asarray(s2.p["acc"]), np.asarray(s2.q["acc"])
        for key, value in m2.items():
            out[pre + "m_" + key] = np.float32(value)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def sm_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cells_ref") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE), path], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, proc.stdout + proc.stderr
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


@pytest.fixture(scope="module")
def pool():
    with RankPool(4) as held:
        yield held


@pytest.mark.parametrize("sid", ["train_1m_sm", "train_1m_smc"])
def test_dpmf_owner_compute_cells_match_reference(sm_ref, pool, sid):
    full = {"p": sm_ref["p"], "q": sm_ref["q"]}
    batch = {key[6:]: value for key, value in sm_ref.items() if key.startswith("batch_")}
    lr = configs.get_config("dpmf").lr
    for t in (0.0, 0.05):
        results = pool.run(cases.dpmf_cell_step_case, (2, 2), ("data", "model"), full, batch,
                           t, sid)
        for other in results[1:]:
            for key in results[0]:
                np.testing.assert_array_equal(other[key], results[0][key], err_msg=key)
        got, pre = results[0], f"{sid}/{t}/"
        keys = [key[len(pre):] for key in sm_ref if key.startswith(pre)]
        assert keys and set(keys) == set(got)
        for key in keys:
            have, want = np.asarray(got[key]), sm_ref[pre + key]
            if sid == "train_1m_sm":
                np.testing.assert_allclose(have, want, atol=2e-8, rtol=1e-6, err_msg=key)
            elif key.startswith("m_"):
                np.testing.assert_allclose(have, want, atol=1e-6, rtol=1e-6, err_msg=key)
            else:
                diff = np.abs(have.astype(np.float64) - want)
                off = diff > 1e-6 + 1e-6 * np.abs(want)
                assert off.sum() <= max(2, want.size // 64), (key, off.sum(), diff.max())
                assert diff.max() <= lr, (key, diff.max())


def test_owner_compute_cells_need_their_mesh():
    cell = configs.build_cell("dpmf", "train_1m_sm")
    with pytest.raises(TypeError, match="mesh"):
        cell.step_fn(None, None, {}, 0.0, 0.0)


def test_recsys_layouts_round_trip_on_four_ranks(pool):
    """A tree with tables of 8192 rows or more (sharded over every axis) and
    smaller ones and MLPs (replicated): each rank's block is its contiguous
    slice, and the assembled tree is the original, bitwise."""
    gen = torch.Generator().manual_seed(4)
    fm_cfg = recsys.FMConfig(n_fields=3, embed_dim=10, vocab_per_field=4096)
    dlrm_cfg = recsys.DLRMConfig(n_dense=5, embed_dim=8, vocab_sizes=(8192, 60, 9000),
                                 bot_mlp=(16, 8), top_mlp=(16, 1))
    full = {"fm": recsys.recsys_params_to_numpy(recsys.init_fm_params(gen, fm_cfg, "cpu")),
            "dlrm": recsys.recsys_params_to_numpy(recsys.init_dlrm_params(gen, dlrm_cfg, "cpu"))}
    full["fm"]["w"] = np.arange(12288, dtype=np.float32)
    results = pool.run(cases.recsys_blocks_case, (2, 2), ("data", "model"), full)
    flat_full = _leaves_by_path(full, False)
    for rank, (blocks, whole, layouts) in enumerate(results):
        got_blocks, got_whole = _leaves_by_path(blocks, False), _leaves_by_path(whole, False)
        assert set(got_blocks) == set(flat_full) == set(got_whole)
        for path, value in flat_full.items():
            np.testing.assert_array_equal(got_whole[path], value, err_msg=str(path))
            rows = value.shape[0] if value.ndim else 0
            sharded = path in (("fm", "v"), ("fm", "w"), ("dlrm", "tables", "0"),
                               ("dlrm", "tables", "2"))
            assert sharded == (rows >= 8192), path
            want = value[rank * rows // 4:(rank + 1) * rows // 4] if sharded else value
            np.testing.assert_array_equal(got_blocks[path], want, err_msg=str(path))
        assert layouts["fm"]["v"] == sharding.P(("data", "model"), None)
        assert layouts["dlrm"]["tables"][1] == sharding.P(None, None)
