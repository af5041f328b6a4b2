"""Sequential serving (SASRec sessions through the pruned engine) held
against the JAX reference on the CPU, at the setup of the reference's own
session tests (``tests/test_eval_ranking.py``).

Tolerances: ids identical; at thresholds 0 the port's engine equals the
port's ``dense_topk`` bitwise and the reference's ``dense_topk`` in ids
(scores within 1e-5: the two encoders sum in another order); at t > 0 the
reference engine's ids, scores within 1e-5; across 2 gloo ranks the local
``engine.topk`` bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_multirank_cases as cases
from repro.data import clicks as jclicks
from repro.eval import ranking as jranking
from repro.models import recsys as jrecsys
from repro.serving import ServingEngine as JServingEngine
from repro.workloads import sequential as jsequential
from repro_torch.eval import ranking
from repro_torch.models import recsys
from repro_torch.testing.ranks import RankPool
from repro_torch.workloads import sequential

TOL = 1e-5


def _setup(seed=0, n_items=60, sessions=12):
    jcfg = jrecsys.SASRecConfig(n_items=n_items, embed_dim=16, n_blocks=2, n_heads=2,
                                seq_len=10)
    cfg = recsys.SASRecConfig(n_items=n_items, embed_dim=16, n_blocks=2, n_heads=2, seq_len=10)
    tree = jax.tree_util.tree_map(
        np.asarray, jrecsys.init_sasrec_params(jax.random.PRNGKey(seed), jcfg))
    seqs = jclicks.sasrec_batch(sessions, seq_len=10, n_items=n_items, seed=seed)["seq"]
    return jcfg, cfg, tree, seqs


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_session_params_are_the_reference_view():
    jcfg, cfg, tree, seqs = _setup()
    view = sequential.session_params(recsys.recsys_params_from_numpy(tree, "cpu"), seqs, cfg)
    want = jsequential.session_params(_jtree(tree), jnp.asarray(seqs), jcfg)
    np.testing.assert_allclose(view.p.numpy(), np.asarray(want.p), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(view.q.numpy(), np.asarray(want.q))
    assert view.user_bias is None and view.implicit is None
    assert not view.p.requires_grad


@pytest.mark.parametrize("max_batch", [8, 256])
def test_sessions_at_rate_zero_equal_dense_topk(max_batch):
    jcfg, cfg, tree, seqs = _setup()
    params = recsys.recsys_params_from_numpy(tree, "cpu")
    sessions = np.arange(seqs.shape[0], dtype=np.int32)
    engine = sequential.session_engine(params, seqs, cfg, device="cpu", max_batch=max_batch)
    scores, ids = sequential.serve_sessions(engine, sessions, topk=10)
    own_s, own_i = ranking.dense_topk(engine.params, sessions, 10)
    np.testing.assert_array_equal(ids, own_i + 1)
    np.testing.assert_array_equal(scores, own_s)
    view = jsequential.session_params(_jtree(tree), jnp.asarray(seqs), jcfg)
    want_s, want_i = jranking.dense_topk(view, sessions, 10, t_p=0.0, t_q=0.0)
    np.testing.assert_array_equal(ids, np.asarray(want_i) + 1)
    np.testing.assert_allclose(scores, np.asarray(want_s), rtol=TOL, atol=TOL)
    # the dense sasrec_retrieval's stable argsort agrees (padding row dropped)
    dense = recsys.sasrec_retrieval(params, torch.as_tensor(seqs), cfg, 0.0,
                                    use_kernel=False).numpy()[:, 1:]
    order = np.argsort(-dense, axis=1, kind="stable")[:, :10].astype(np.int32)
    np.testing.assert_array_equal(ids, order + 1)


@pytest.mark.parametrize("t_p,t_q", [(0.0, 0.01), (0.3, 0.01), (0.3, 0.0)])
def test_pruned_sessions_match_the_reference_engine(t_p, t_q):
    jcfg, cfg, tree, seqs = _setup(seed=1, n_items=40)
    params = recsys.recsys_params_from_numpy(tree, "cpu")
    sessions = np.arange(seqs.shape[0], dtype=np.int32)
    engine = sequential.session_engine(params, seqs, cfg, t_p, t_q, device="cpu", max_batch=8)
    jengine = jsequential.session_engine(_jtree(tree), jnp.asarray(seqs), jcfg, t_p, t_q,
                                         use_kernel=False, max_batch=8)
    n = engine.n_items
    for topk in (5, n):
        scores, ids = sequential.serve_sessions(engine, sessions, topk=topk)
        want_s, want_i = jsequential.serve_sessions(jengine, sessions, topk=topk)
        assert ids.min() >= 1 and ids.max() <= n
        np.testing.assert_array_equal(ids, want_i)
        np.testing.assert_allclose(scores, want_s, rtol=TOL, atol=TOL)
    # the equally pruned oracle of the port's own view
    own_s, own_i = ranking.dense_topk(engine.params, sessions, n, t_p=t_p, t_q=t_q)
    scores, ids = sequential.serve_sessions(engine, sessions, topk=n)
    np.testing.assert_array_equal(ids, own_i + 1)


def test_serve_sessions_on_a_mesh_of_two_gloo_ranks():
    """``serve_sessions(mesh=)`` through ``topk_sharded`` on a (1, 2)
    ("data", "model") mesh: every rank returns the local engine's answer
    bitwise, and the reference's ids."""
    jcfg, cfg, tree, seqs = _setup(seed=2, n_items=61)
    sessions = np.arange(seqs.shape[0], dtype=np.int32)
    with RankPool(2) as pool:
        got = pool.run(cases.session_case, (1, 2), ("data", "model"), tree, seqs, cfg, 0.0,
                       0.005, sessions, 7)
    jengine = jsequential.session_engine(_jtree(tree), jnp.asarray(seqs), jcfg, 0.0, 0.005,
                                         use_kernel=False, max_batch=8)
    want_s, want_i = jsequential.serve_sessions(jengine, sessions, topk=7)
    for (s, i), (ls, li) in got:
        np.testing.assert_array_equal(i, li)
        np.testing.assert_array_equal(s, ls)
        np.testing.assert_array_equal(i, want_i)
        np.testing.assert_allclose(s, want_s, rtol=TOL, atol=TOL)
