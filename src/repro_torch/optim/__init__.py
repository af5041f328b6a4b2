"""Row optimizers for the factor tables, and learning-rate schedules."""
from repro_torch.optim.optimizers import Adam, RowOptimizer, Sgd  # noqa: F401
from repro_torch.optim.schedules import constant, cosine, twin_learners_mask  # noqa: F401
