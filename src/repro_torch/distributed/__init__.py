"""Training and serving across ranks: meshes and named-axis collectives on
``torch.distributed`` (``spmd``), the MF and recsys layouts (``sharding``),
int8 gradient compression and the fleet's lossless codec
(``compression``), microbatched gradients (``collectives``), and the
training launcher's fault tolerance."""
from repro_torch.distributed.collectives import microbatch_grads  # noqa: F401
from repro_torch.distributed.compression import (  # noqa: F401
    CompressedArray,
    compress_array,
    compressed_psum,
    compress_with_feedback,
    decompress_array,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
)
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    FailureInjector,
    StepFailure,
    StragglerDetector,
    run_with_retries,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    all_axes,
    data_axes,
    decode_state_spec_fn,
    gnn_batch_shardings,
    gnn_spec_fn,
    lm_batch_shardings,
    mf_batch_shardings,
    mf_spec_fn,
    recsys_batch_shardings,
    recsys_spec_fn,
    route_batch_to_owner_shards,
    transformer_param_shardings,
    transformer_spec,
    tree_shardings,
)
