"""Graph data: synthetic cora/products-shaped graphs, a real fanout neighbor
sampler (GraphSAGE-style, uniform without replacement), and block-diagonal
batching for small molecule graphs.

Counterpart of ``repro/data/graphs.py``, in numpy as the reference is: the
same arguments and seed give the same arrays, bit for bit.  It is a copy
and not an import, because ``repro/data/__init__.py`` pulls in jax; only
``to_csr``'s stable sort takes another (faster) route to the same order.

All outputs are fixed-shape (padded) numpy arrays so one step serves every
minibatch: the padding contract is ``edge_mask`` 0 / label -1.  Padded
edges point at node 0 (``pad_subgraph``, ``batch_molecules``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    features: np.ndarray   # (N, d) float32
    edges: np.ndarray      # (E, 2) int32 [src, dst]
    labels: np.ndarray     # (N,) int32; -1 = unlabeled
    n_classes: int

    @property
    def num_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]


def synthetic_graph(
    num_nodes: int,
    num_edges: int,
    d_feat: int,
    n_classes: int = 7,
    *,
    labeled_fraction: float = 0.1,
    seed: int = 0,
    add_self_loops: bool = True,
) -> Graph:
    """Community-structured random graph: nodes get a class; edges prefer
    same-class endpoints (2:1), features = class centroid + noise, so a GAT
    can actually learn (smoke tests check loss decreases)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, num_nodes).astype(np.int32)
    centroids = rng.normal(0, 1, (n_classes, d_feat)).astype(np.float32)
    feats = centroids[labels] + rng.normal(0, 1.0, (num_nodes, d_feat)).astype(
        np.float32
    )

    n_intra = (2 * num_edges) // 3
    src_a = rng.integers(0, num_nodes, n_intra).astype(np.int32)
    # same-class destination: random node of the same label via per-class pools
    order = np.argsort(labels, kind="stable")
    class_start = np.searchsorted(labels[order], np.arange(n_classes))
    class_count = np.bincount(labels, minlength=n_classes)
    rand_off = rng.random(n_intra)
    dst_a = order[
        class_start[labels[src_a]]
        + (rand_off * np.maximum(class_count[labels[src_a]], 1)).astype(np.int64)
    ].astype(np.int32)
    src_b = rng.integers(0, num_nodes, num_edges - n_intra).astype(np.int32)
    dst_b = rng.integers(0, num_nodes, num_edges - n_intra).astype(np.int32)
    edges = np.stack(
        [np.concatenate([src_a, src_b]), np.concatenate([dst_a, dst_b])], axis=1
    )
    if add_self_loops:
        loops = np.stack([np.arange(num_nodes)] * 2, axis=1).astype(np.int32)
        edges = np.concatenate([edges, loops], axis=0)

    masked = labels.copy()
    unlabeled = rng.random(num_nodes) > labeled_fraction
    masked[unlabeled] = -1
    return Graph(features=feats, edges=edges, labels=masked, n_classes=n_classes)


def _stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for node ids (int32, 0 or more):
    two stable passes over 16-bit digits, which numpy sorts by radix sort in
    linear time (a stable permutation is unique, so it is the same one;
    114.6M edges sort in a third of the time)."""
    keys = keys.astype(np.int64, copy=False)
    order = np.argsort((keys & 0xFFFF).astype(np.uint16), kind="stable")
    return order[np.argsort((keys[order] >> 16).astype(np.uint16), kind="stable")]


def to_csr(edges: np.ndarray, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Incoming-edge CSR: for each dst node, the list of src neighbors."""
    dst = edges[:, 1]
    order = _stable_argsort(dst)
    sorted_src = edges[order, 0]
    counts = np.bincount(dst, minlength=num_nodes)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return indptr, sorted_src.astype(np.int32)


def neighbor_sample(
    indptr: np.ndarray,
    indices: np.ndarray,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    *,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Layer-wise uniform neighbor sampling (GraphSAGE).

    Returns (nodes, edges_local, seed_count): ``nodes`` are global ids with
    seeds first; ``edges_local`` index into ``nodes`` and are padded with
    (-1, -1) to the static size ``len(seeds) * prod-expansion``.
    """
    rng = np.random.default_rng(seed)
    node_ids: List[int] = list(seeds)
    local = {int(n): idx for idx, n in enumerate(seeds)}
    edge_src: List[int] = []
    edge_dst: List[int] = []
    frontier = list(seeds)
    max_edges = 0
    expansion = len(seeds)
    for fanout in fanouts:
        max_edges += expansion * fanout
        expansion *= fanout
        next_frontier: List[int] = []
        for dst_node in frontier:
            start, stop = indptr[dst_node], indptr[dst_node + 1]
            deg = stop - start
            if deg == 0:
                continue
            take = min(fanout, int(deg))
            picks = rng.choice(indices[start:stop], size=take, replace=False)
            for src_node in picks:
                src_node = int(src_node)
                if src_node not in local:
                    local[src_node] = len(node_ids)
                    node_ids.append(src_node)
                    next_frontier.append(src_node)
                edge_src.append(local[src_node])
                edge_dst.append(local[dst_node])
        frontier = next_frontier

    nodes = np.asarray(node_ids, np.int32)
    edges = np.full((max_edges, 2), -1, np.int32)
    if edge_src:
        edges[: len(edge_src), 0] = edge_src
        edges[: len(edge_dst), 1] = edge_dst
    return nodes, edges, len(seeds)


def pad_subgraph(
    graph: Graph,
    nodes: np.ndarray,
    edges_local: np.ndarray,
    num_nodes_pad: int,
):
    """Materialize a fixed-shape minibatch from a sampled subgraph."""
    n = min(len(nodes), num_nodes_pad)
    feats = np.zeros((num_nodes_pad, graph.features.shape[1]), np.float32)
    feats[:n] = graph.features[nodes[:n]]
    labels = np.full(num_nodes_pad, -1, np.int32)
    labels[:n] = graph.labels[nodes[:n]]
    mask = (edges_local[:, 0] >= 0) & (edges_local[:, 0] < n) & (
        edges_local[:, 1] < n
    )
    safe = np.where(edges_local < 0, 0, edges_local)
    return {
        "features": feats,
        "edges": safe.astype(np.int32),
        "edge_mask": mask.astype(np.float32),
        "labels": labels,
    }


def batch_molecules(
    graphs: List[Graph], nodes_per_graph: int, edges_per_graph: int
):
    """Block-diagonal batching: graph g's node i -> global g*nodes_per_graph+i."""
    b = len(graphs)
    d = graphs[0].features.shape[1]
    feats = np.zeros((b * nodes_per_graph, d), np.float32)
    edges = np.zeros((b * edges_per_graph, 2), np.int32)
    edge_mask = np.zeros(b * edges_per_graph, np.float32)
    labels = np.full(b * nodes_per_graph, -1, np.int32)
    for g, graph in enumerate(graphs):
        n = min(graph.num_nodes, nodes_per_graph)
        e = min(graph.num_edges, edges_per_graph)
        feats[g * nodes_per_graph : g * nodes_per_graph + n] = graph.features[:n]
        labels[g * nodes_per_graph : g * nodes_per_graph + n] = graph.labels[:n]
        off = g * nodes_per_graph
        edges[g * edges_per_graph : g * edges_per_graph + e] = graph.edges[:e] + off
        edge_mask[g * edges_per_graph : g * edges_per_graph + e] = 1.0
    return {
        "features": feats,
        "edges": edges,
        "edge_mask": edge_mask,
        "labels": labels,
    }
