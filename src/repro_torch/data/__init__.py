"""Rating datasets, the batch loaders of the training path, the synthetic
click data of the recsys models (``clicks``) and the GNN's graphs, their
sampler and batching (``graphs``)."""
from repro_torch.data.clicks import (  # noqa: F401
    bst_batch,
    criteo_batch,
    fm_batch,
    sasrec_batch,
)
from repro_torch.data.graphs import (  # noqa: F401
    Graph,
    batch_molecules,
    neighbor_sample,
    pad_subgraph,
    synthetic_graph,
    to_csr,
)
from repro_torch.data.loader import (  # noqa: F401
    PackedRatings,
    epoch_permutation,
    iterate_batches,
    num_steps,
    pack_eval_batches,
    pack_ratings,
)
from repro_torch.data.ratings import (  # noqa: F401
    RatingsDataset,
    build_user_history,
    load_csv,
    paper_dataset,
    synthetic_ratings,
    train_test_split,
)
