"""Online learning: streaming pruned factor updates and zero-downtime serving.

Counterpart of ``repro/online`` on one device: consume fresh ``(user, item,
rating)`` events, apply the paper's dynamically pruned row updates to the
touched rows only, and hot-swap versioned factor snapshots into a running
:class:`~repro_torch.serving.engine.ServingEngine` without dropping
requests.  The publisher is also the replication bus of a serving fleet
(``repro_torch.serving.fleet``): it ships each version to its subscribers as
a compressed, versioned delta message.
"""
from repro_torch.online.publisher import (  # noqa: F401
    SnapshotPublisher,
    SwapReport,
    apply_delta_tree,
    fold_deltas,
)
from repro_torch.online.stream import (  # noqa: F401
    Event,
    EventBatch,
    IteratorSource,
    PoissonSource,
    RatingFreeStreamError,
    ReplaySource,
    iter_microbatches,
)
from repro_torch.online.updater import (  # noqa: F401
    OnlineUpdater,
    PublishSnapshot,
)
