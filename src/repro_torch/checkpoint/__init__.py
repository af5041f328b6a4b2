"""Checkpoints in the reference trainer's npz + metadata format, read and written."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    CorruptCheckpointError,
    all_steps,
    elastic_load,
    latest_step,
    load_metadata,
    load_raw,
    restore,
    save,
    step_path,
)
