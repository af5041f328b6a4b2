"""The GAT of gat-cora (``repro_torch.models.gnn``), its graph data
(``repro_torch.data.graphs``) and its batch-order gathers and segment sums
(``kernels.scatter.gather_rows`` / ``segment_sum``) held against the JAX
reference on the CPU.

Graphs are small: the smoke config (32 features, 5 classes, 4 heads) on a
200-node, 800-edge synthetic graph; one sampled minibatch (16 seeds, fanout
(5, 3), padded to 256 nodes); 4 molecules.  Both packages take the same
numpy weights (``gnn_params_from_numpy``); the reference runs under
``jax.jit``.

Tolerances: ``data/graphs`` outputs bitwise (numpy draws in both); logits
and loss within 1e-5 in float32; every parameter's gradient within 1e-5
relative + 1e-6 absolute of ``jax.grad`` (the port's segment max carries no
gradient: the softmax is shift-invariant up to its 1e-9 guard); one
``gnn_train_cell`` step (weights, Adam's ``m``, ``v``, ``t``, loss) within
1e-5; ``segment_sum`` bitwise ``jax.ops.segment_sum`` in float32 (both add
in edge order); ``gather_rows`` and ``segment_sum`` through
``torch.autograd.gradcheck`` in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import gat_cora as jgat_cora
from repro.data import graphs as jgraphs
from repro.models import gnn as jgnn
from repro_torch import tree
from repro_torch.configs import base, gat_cora
from repro_torch.data import graphs
from repro_torch.distributed.collectives import value_and_grad
from repro_torch.kernels import scatter
from repro_torch.models import gnn
from repro_torch.optim.optimizers import Adam

TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6



JCFG = jgat_cora.smoke_config()
CFG = gat_cora.smoke_config()


def _weights(seed):
    """The reference's init as numpy, biases drawn small so that they count."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.array, jgnn.init_params(jax.random.PRNGKey(seed), JCFG))
    for layer in params["layers"]:
        layer["bias"] = rng.normal(0, 0.05, layer["bias"].shape).astype(np.float32)
    return params


def _graph_batch(g):
    return {"features": g.features, "edges": g.edges, "labels": g.labels}


def _case(name):
    """A numpy batch: ``full`` (200 nodes, 800 edges with self-loops, no
    mask), ``isolated`` (no self-loops, node 7's in-edges dropped: empty
    segments), ``minibatch`` (a sampled, padded subgraph), ``molecules`` (4
    block-diagonal graphs, padded edges) and ``node0_masked`` (every edge
    into node 0 masked, its padding included)."""
    if name in ("full", "node0_masked"):
        batch = _graph_batch(graphs.synthetic_graph(200, 600, 32, 5, seed=1))
        if name == "node0_masked":
            batch["edge_mask"] = (batch["edges"][:, 1] != 0).astype(np.float32)
        return batch
    if name == "isolated":
        batch = _graph_batch(graphs.synthetic_graph(200, 800, 32, 5, seed=2,
                                                    add_self_loops=False))
        batch["edges"] = batch["edges"][batch["edges"][:, 1] != 7]
        assert (np.bincount(batch["edges"][:, 1], minlength=200) == 0).sum() >= 2
        return batch
    if name == "minibatch":
        g = graphs.synthetic_graph(300, 2400, 32, 5, seed=3)
        indptr, indices = graphs.to_csr(g.edges, g.num_nodes)
        nodes, edges_local, _ = graphs.neighbor_sample(indptr, indices, np.arange(16) * 11, (5, 3),
                                                       seed=4)
        return graphs.pad_subgraph(g, nodes, edges_local, 256)
    mols = [graphs.synthetic_graph(20 + 3 * i, 12 + 5 * i, 32, 5, seed=10 + i) for i in range(4)]
    return graphs.batch_molecules(mols, 30, 64)


CASES = ["full", "isolated", "minibatch", "molecules", "node0_masked"]


def _jax_batch(batch):
    return {key: jnp.asarray(value) for key, value in batch.items()}


def _torch_batch(batch):
    return {key: torch.as_tensor(value) for key, value in batch.items()}


def _close(got, want, rtol=TOL, atol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# data/graphs.py, bitwise
# ---------------------------------------------------------------------------


def _assert_same(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got[key].dtype == want[key].dtype, key
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        assert got == want


@pytest.mark.parametrize("self_loops", [True, False])
def test_synthetic_graph_and_csr_are_the_reference(self_loops):
    got = graphs.synthetic_graph(200, 800, 32, 5, seed=7, add_self_loops=self_loops)
    want = jgraphs.synthetic_graph(200, 800, 32, 5, seed=7, add_self_loops=self_loops)
    for field in ("features", "edges", "labels"):
        _assert_same(getattr(got, field), getattr(want, field))
    assert (got.n_classes, got.num_nodes, got.num_edges) == (5, 200, 800 + 200 * self_loops)
    _assert_same(graphs.to_csr(got.edges, 200), jgraphs.to_csr(want.edges, 200))


def test_to_csr_is_the_reference_past_16_bit_node_ids():
    """The port's stable sort runs in 16-bit digits: 300,000 nodes take both."""
    rng = np.random.default_rng(8)
    edges = rng.integers(0, 300_000, (1_000_000, 2)).astype(np.int32)
    _assert_same(graphs.to_csr(edges, 300_000), jgraphs.to_csr(edges, 300_000))
    _assert_same(graphs.to_csr(edges[:0], 4), jgraphs.to_csr(edges[:0], 4))


def test_sampler_padding_and_molecules_are_the_reference():
    g, jg = (mod.synthetic_graph(300, 2400, 32, 5, seed=3) for mod in (graphs, jgraphs))
    indptr, indices = graphs.to_csr(g.edges, g.num_nodes)
    got = graphs.neighbor_sample(indptr, indices, np.arange(16) * 11, (5, 3), seed=4)
    want = jgraphs.neighbor_sample(indptr, indices, np.arange(16) * 11, (5, 3), seed=4)
    _assert_same(got, want)
    assert got[1].shape == (16 * (5 + 15), 2) and (got[1] == -1).any()
    padded = graphs.pad_subgraph(g, got[0], got[1], 256)
    _assert_same(padded, jgraphs.pad_subgraph(jg, want[0], want[1], 256))
    # padded edges point at node 0, masked out
    assert padded["edge_mask"].min() == 0 and (padded["edges"][padded["edge_mask"] == 0] == 0).all()
    mols = [graphs.synthetic_graph(20 + 3 * i, 12 + 5 * i, 32, 5, seed=10 + i) for i in range(4)]
    jmols = [jgraphs.synthetic_graph(20 + 3 * i, 12 + 5 * i, 32, 5, seed=10 + i) for i in range(4)]
    _assert_same(graphs.batch_molecules(mols, 30, 64), jgraphs.batch_molecules(jmols, 30, 64))


# ---------------------------------------------------------------------------
# gather_rows and segment_sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7,), (7, 3), (7, 2, 3)])
def test_gather_rows_is_an_index_with_a_batch_order_gradient(shape):
    rng = np.random.default_rng(len(shape))
    table = torch.as_tensor(rng.normal(size=shape), dtype=torch.float64).requires_grad_(True)
    idx = torch.as_tensor(rng.integers(0, 6, (4, 5)), dtype=torch.int32)  # row 6 never read
    out = scatter.gather_rows(table, idx)
    assert torch.equal(out, table[idx.long()])
    torch.autograd.gradcheck(lambda t: scatter.gather_rows(t, idx), (table,))
    grad = torch.as_tensor(rng.normal(size=out.shape))
    (got,) = torch.autograd.grad(out, table, grad)
    want = torch.zeros(shape, dtype=torch.float64).index_add_(
        0, idx.reshape(-1).long(), grad.reshape((-1,) + shape[1:]))
    assert torch.equal(got, want) and not got[6].any()


@pytest.mark.parametrize("shape", [(40,), (40, 3), (40, 2, 3)])
def test_segment_sum_is_the_reference_with_a_gather_gradient(shape):
    rng = np.random.default_rng(10 + len(shape))
    seg = torch.as_tensor(rng.integers(0, 9, 40))  # segments 9 and 10 stay empty
    rows = rng.normal(size=shape)
    want = jax.ops.segment_sum(jnp.asarray(rows, jnp.float32), jnp.asarray(seg.numpy()),
                               num_segments=11)
    got = scatter.segment_sum(torch.as_tensor(rows, dtype=torch.float32), seg, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (11,) + shape[1:] and not got[9:].any()
    leaf = torch.as_tensor(rows).requires_grad_(True)
    torch.autograd.gradcheck(lambda r: scatter.segment_sum(r, seg, 11), (leaf,))


def test_edge_messages_are_the_gather_and_sum_they_fuse():
    """The GAT's messages (``alpha * h[src]`` summed into ``dst``), whose
    backward gathers ``h[src]`` again: the composition of ``gather_rows`` and
    ``segment_sum`` bitwise, and its gradient by gradcheck."""
    rng = np.random.default_rng(21)
    n, e, heads, d = 9, 60, 2, 3
    src, dst = (torch.as_tensor(rng.integers(0, n - 1, e)) for _ in range(2))  # node 8 empty
    alpha = torch.as_tensor(rng.random((e, heads))).requires_grad_(True)
    h = torch.as_tensor(rng.normal(size=(n, heads, d))).requires_grad_(True)
    got = gnn._EdgeMessages.apply(alpha, h, src, dst, n)
    want = scatter.segment_sum(alpha[..., None] * scatter.gather_rows(h, src), dst, n)
    assert torch.equal(got, want) and not got[8].any()
    torch.autograd.gradcheck(lambda a, t: gnn._EdgeMessages.apply(a, t, src, dst, n), (alpha, h))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_config_and_init_are_the_reference():
    assert CFG.layer_dims() == JCFG.layer_dims() and CFG.dtype == torch.float32
    for name in ("d_feat", "n_classes", "n_layers", "d_hidden", "n_heads", "negative_slope"):
        assert getattr(CFG, name) == getattr(JCFG, name), name
    want = jgnn.init_params(jax.random.PRNGKey(0), JCFG)
    got = gnn.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    meta = gnn.init_params(torch.Generator(), CFG, device="meta")
    assert len(got["layers"]) == len(want["layers"]) == len(meta["layers"])
    for g_layer, w_layer, m_layer in zip(got["layers"], want["layers"], meta["layers"]):
        assert list(g_layer) == list(w_layer) == list(m_layer)
        for key, value in w_layer.items():
            assert tuple(g_layer[key].shape) == value.shape == tuple(m_layer[key].shape), key
            assert g_layer[key].dtype == torch.float32 and m_layer[key].is_meta
        assert not g_layer["bias"].any()
        d_in, cols = g_layer["w"].shape
        assert abs(float(g_layer["w"].std()) / (2.0 / (d_in + cols)) ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("case", CASES)
def test_forward_loss_and_gradients_match_reference(case):
    batch = _case(case)
    np_params = _weights(CASES.index(case))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb = _jax_batch(batch)
    want_logits = jax.jit(lambda p, b: jgnn.forward(p, b["features"], b["edges"], JCFG,
                                                    b.get("edge_mask")))(jparams, jb)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jgnn.loss_fn(p, b, JCFG)))(jparams, jb)
    params = gnn.gnn_params_from_numpy(np_params, device="cpu")
    tb = _torch_batch(batch)
    logits = gnn.forward(params, tb["features"], tb["edges"], CFG, tb.get("edge_mask"))
    _close(logits, want_logits, what="logits")
    loss, grads = value_and_grad(lambda p, b: gnn.loss_fn(p, b, CFG), params, tb)
    _close(loss, want_loss, what="loss")
    for got_layer, want_layer in zip(grads["layers"], want_grads["layers"]):
        for key, want in want_layer.items():
            assert np.abs(np.asarray(want)).max() > 0, key
            _close(got_layer[key], want, GRAD_RTOL, GRAD_ATOL, what=key)
    if case == "isolated":
        # an empty segment aggregates to 0: layer 1 gives elu(bias) at node 7
        layer = params["layers"][0]
        dims = CFG.layer_dims()[0]
        h1 = gnn.gat_layer(tb["features"], tb["edges"], layer, heads=dims[1], d_out=dims[2],
                           concat=True, negative_slope=CFG.negative_slope)
        assert torch.equal(h1[7], torch.nn.functional.elu(layer["bias"]))
    if case == "node0_masked":
        # every edge into node 0 masked: its softmax runs over -1e30 scores
        # alone, and the mask zeroes what it gives
        layer = params["layers"][0]
        dims = CFG.layer_dims()[0]
        h1 = gnn.gat_layer(tb["features"], tb["edges"], layer, heads=dims[1], d_out=dims[2],
                           concat=True, negative_slope=CFG.negative_slope,
                           edge_mask=tb["edge_mask"])
        assert torch.equal(h1[0], torch.nn.functional.elu(layer["bias"]))


def _padded_batch(batch, num_nodes, num_edges):
    n, e = len(batch["labels"]), len(batch["edges"])
    out = {"features": np.zeros((num_nodes, batch["features"].shape[1]), np.float32),
           "edges": np.zeros((num_edges, 2), np.int32),
           "labels": np.full(num_nodes, -1, np.int32),
           "edge_mask": np.zeros(num_edges, np.float32)}
    out["features"][:n], out["labels"][:n] = batch["features"], batch["labels"]
    out["edges"][:e], out["edge_mask"][:e] = batch["edges"], 1.0
    return out


def test_train_cell_step_matches_reference():
    """One ``gnn_train_cell`` step at the smoke config on 200 nodes and 800
    edges (padded to 512 and 1024, which forces ``edge_mask``) against the
    reference cell's jitted ``step_fn``; then a second step."""
    jcell = jbase.gnn_train_cell("gat-cora", "smoke", JCFG, num_nodes=200, num_edges=800)
    cell = base.gnn_train_cell("gat-cora", "smoke", CFG, num_nodes=200, num_edges=800)
    assert (cell.kind, cell.donate_argnums, cell.cell_id) == (
        jcell.kind, jcell.donate_argnums, jcell.cell_id)
    a_batch = cell.abstract_args[2]
    assert {key: tuple(v.shape) for key, v in a_batch.items()} == {
        key: v.shape for key, v in jcell.abstract_args[2].items()}
    assert a_batch["features"].shape == (512, 32) and a_batch["edge_mask"].shape == (1024,)
    batch = _padded_batch(_graph_batch(graphs.synthetic_graph(200, 600, 32, 5, seed=5)), 512,
                          1024)
    np_params = _weights(11)
    jstep = jax.jit(jcell.step_fn)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jstate = jbase.Adam(lr=5e-3).init(jparams)
    params = gnn.gnn_params_from_numpy(np_params, device="cpu")
    state = Adam().init(params)
    tb = _torch_batch(batch)
    for _ in range(2):
        jparams, jstate, want_loss = jstep(jparams, jstate, _jax_batch(batch))
        new_params, new_state, loss = cell.step_fn(params, state, tb)
        assert new_params is params and new_state is state  # in place
        _close(loss, want_loss, what="loss")
        assert int(state["t"]) == int(jstate["t"])
        for got, want in ((params, jparams), (state["m"], jstate["m"]), (state["v"], jstate["v"])):
            for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
                _close(g, w)


def test_chip_smoke_gnn_phase_rehearses_on_the_cpu():
    """``chip_smoke.py``'s gat-cora block end to end on the CPU at tiny graph
    counts (the cells' feature and class widths): every check holds (the
    launch counts are checked on the card only)."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    chip_smoke.failures.clear()
    chip_smoke.PATH_LAUNCHES.pop("cells", None)
    out = chip_smoke.gnn_cells_phase(torch.device("cpu"), dict(
        full_graph_sm=(270, 1000), ogb_products=(1500, 20000), reddit=(3000, 60000), seeds=16,
        fanouts=(5, 3), molecules=4, check_nodes=64))
    assert chip_smoke.failures == []
    assert list(out) == ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
    for sid, stats in out.items():
        assert np.isfinite(stats["loss"]) and max(stats["max_abs_err"].values()) <= 1e-5, sid
        assert stats["node0_run"] >= stats["node0_padded"] > 0, sid
    assert chip_smoke.PATH_LAUNCHES["cells"] == {"pruned_topk": 0, "pruned_matmul": 0,
                                                 "add_rows": 0}
    # the card's batches: the graphs' own counts, padded as the cells pad them
    assert chip_smoke._padded(2_449_029) == 2_449_408 and chip_smoke._padded(61_859_140) == 61_859_328
    assert chip_smoke._padded(2708) == 3072 and chip_smoke._padded(10556) == 10752
