"""Hand-written CUDA kernels of the serving path and their plain versions.

``ops`` holds the public entry points; ``pruned_matmul`` and ``pruned_topk``
hold each kernel's wrapper, plain PyTorch version and launch counter;
``build`` compiles ``csrc/`` with ``nvcc`` on first use; ``ref`` holds the
dense oracles.
"""
