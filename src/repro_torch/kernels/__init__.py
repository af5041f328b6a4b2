"""Hand-written CUDA kernels of the port and their plain versions.

``ops`` holds the public entry points; ``pruned_matmul``, ``pruned_topk``
(serving), ``fused_mf_sgd`` and ``scatter`` (training: the batch-order row
scatter ``add_rows``) hold each kernel's wrapper, plain PyTorch version and
launch counter; ``build`` compiles ``csrc/`` with
``nvcc`` on first use; ``ref`` holds the dense oracles.
"""


def __getattr__(name):
    """``tile_block_stats`` from ``ops``, loaded on first use (``ops``
    imports ``core``, whose modules import ``kernels.scatter``).
    ``pruned_matmul``, ``pruned_topk`` and ``fused_mf_sgd`` here name the
    kernels' modules (each its wrapper, plain version and launch counter);
    their entry points are ``ops``' functions of the same names."""
    if name == "tile_block_stats":
        from repro_torch.kernels.ops import tile_block_stats
        return tile_block_stats
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
