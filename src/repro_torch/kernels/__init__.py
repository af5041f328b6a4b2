"""Hand-written CUDA kernels of the port and their plain versions.

``ops`` holds the public entry points; ``pruned_matmul``, ``pruned_topk``
(serving) and ``fused_mf_sgd`` (training) hold each kernel's wrapper, plain
PyTorch version and launch counter; ``build`` compiles ``csrc/`` with
``nvcc`` on first use; ``ref`` holds the dense oracles.
"""
