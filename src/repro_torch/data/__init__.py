"""Rating datasets and the batch loaders of the training path."""
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
