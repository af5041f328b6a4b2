"""Serving: batched, pruned top-k recommendation from trained checkpoints."""
from repro_torch.serving.batching import (  # noqa: F401
    LRUCache,
    MicroBatcher,
    bucket_size,
)
from repro_torch.serving.engine import (  # noqa: F401
    ServingEngine,
    load_mf_checkpoint,
)
from repro_torch.serving.queue import (  # noqa: F401
    LatencyWindow,
    QueueFullError,
    RequestQueue,
    RequestTimeout,
)
from repro_torch.serving.slo import (  # noqa: F401
    SLOConfig,
    SLOController,
    SLODecision,
)
