"""gat-cora [arXiv:1710.10903]: 2-layer GAT, 8 heads x d_hidden 8, attention
aggregation.  Each shape cell carries its own graph stats (and thus d_feat /
n_classes):

  full_graph_sm : Cora      (2,708 nodes / 10,556 edges / 1,433 feats / 7 cls)
  minibatch_lg  : Reddit    (232,965 / 114.6M) sampled with fanout 15-10 from
                  1,024 seed nodes -> padded subgraph (the sampler is real:
                  data/graphs.neighbor_sample)
  ogb_products  : ogbn-products (2,449,029 / 61.9M / 100 feats / 47 cls)
  molecule      : 128 block-diagonally batched 30-node/64-edge graphs

Counterpart of ``repro/configs/gat_cora.py``: the same cells at the same
widths, node and edge counts padded to multiples of 512 by
``base.gnn_train_cell``.
"""
from repro_torch.configs import base
from repro_torch.models.gnn import GATConfig

ARCH_ID = "gat-cora"

CONFIG = GATConfig(
    name=ARCH_ID, d_feat=1433, n_classes=7, n_layers=2, d_hidden=8, n_heads=8
)

# minibatch_lg: 1,024 seeds, fanout (15, 10) -> <= 1024*(1+15+150) nodes and
# 1024*(15+150) edges; padded to these static maxima.
_MB_NODES = 1024 * (1 + 15 + 150)
_MB_EDGES = 1024 * (15 + 150)


def smoke_config() -> GATConfig:
    return GATConfig(
        name=ARCH_ID + "-smoke", d_feat=32, n_classes=5, n_layers=2,
        d_hidden=8, n_heads=4,
    )


def cells():
    return {
        "full_graph_sm": lambda: base.gnn_train_cell(
            ARCH_ID,
            "full_graph_sm",
            CONFIG,
            num_nodes=2708,
            num_edges=10556,
        ),
        "minibatch_lg": lambda: base.gnn_train_cell(
            ARCH_ID,
            "minibatch_lg",
            GATConfig(
                name=ARCH_ID, d_feat=602, n_classes=41, n_layers=2,
                d_hidden=8, n_heads=8,
            ),
            num_nodes=_MB_NODES,
            num_edges=_MB_EDGES,
            with_edge_mask=True,
            note="fanout-(15,10) sampled subgraph from 1,024 seeds; sampler in data/graphs.py",
        ),
        "ogb_products": lambda: base.gnn_train_cell(
            ARCH_ID,
            "ogb_products",
            GATConfig(
                name=ARCH_ID, d_feat=100, n_classes=47, n_layers=2,
                d_hidden=8, n_heads=8,
            ),
            num_nodes=2449029,
            num_edges=61859140,
        ),
        "molecule": lambda: base.gnn_train_cell(
            ARCH_ID,
            "molecule",
            GATConfig(
                name=ARCH_ID, d_feat=32, n_classes=8, n_layers=2,
                d_hidden=8, n_heads=8,
            ),
            num_nodes=128 * 30,
            num_edges=128 * 64,
            with_edge_mask=True,
            note="128 block-diagonal molecule graphs (data/graphs.batch_molecules)",
        ),
    }
