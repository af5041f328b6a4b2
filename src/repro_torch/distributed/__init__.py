"""Fault tolerance of the training launcher, and the lossless codec of the
serving fleet's replication bus (distributed training across ranks comes
later)."""
from repro_torch.distributed.compression import (  # noqa: F401
    CompressedArray,
    compress_array,
    decompress_array,
)
