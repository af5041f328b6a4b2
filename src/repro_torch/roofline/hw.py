"""Hardware model: one NVIDIA H100 SXM (80 GB HBM3) at its 700 W power limit.

Counterpart of ``repro/roofline/hw.py``, which models the reference's TPU.
Dense rates without sparsity, from NVIDIA's H100 data sheet.  A card set
below 700 W (``nvidia-smi --query-gpu=power.limit``) runs slower under load,
so a share of these peaks is stated beside the card's limit.  The mesh
extents live in :mod:`repro_torch.launch.mesh`.
"""

PEAK_BF16_FLOPS = 989e12   # FLOP/s, bf16 (and fp16) on the tensor cores
PEAK_TF32_FLOPS = 495e12   # FLOP/s, TF32 on the tensor cores
PEAK_FP32_FLOPS = 67e12    # FLOP/s, float32 outside the tensor cores
HBM_BANDWIDTH = 3.35e12    # bytes/s
LINK_BANDWIDTH = 450e9     # bytes/s, NVLink 4 in one direction (within a node of 8)
