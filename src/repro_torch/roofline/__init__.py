"""The one-card roofline: the H100's peaks (:mod:`hw`) and the count of a
step's work on meta tensors (:mod:`analysis`).

Counterpart of ``repro/roofline/``."""
from repro_torch.roofline import analysis, hw  # noqa: F401
