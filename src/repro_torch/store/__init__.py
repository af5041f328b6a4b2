"""Out-of-core data: the mmap-backed ratings store with its streamed slab
loader, and cold-row eviction for the online path.

Counterpart of ``repro/store``.  ``ratings_store`` bounds host memory on
the training side (the ratings stay on disk; epochs stream through a
fixed-depth prefetch queue); ``eviction`` bounds device memory on the
online side (the grow-only user table gets a watermark and cold rows spill
to disk).
"""
from repro_torch.store.ratings_store import (  # noqa: F401
    CorruptShardError,
    FeistelPermutation,
    RatingsStore,
    ShardedRatingsLoader,
    build_store,
)
from repro_torch.store.eviction import (  # noqa: F401
    EvictionConfig,
    IdRemap,
    UserEvictor,
)
