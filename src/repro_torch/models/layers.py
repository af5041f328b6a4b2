"""Shared neural building blocks of the recsys models.

Counterpart of the part of ``repro/models/layers.py`` that
``models/recsys.py`` uses: ``dense``, ``layer_norm``, ``mlp``,
``embed_lookup`` and ``init_dense``.  Plain functions over explicit
parameter dicts with the reference's keys, so a reference tree carried
across as tensors computes the same thing.  The draws of :func:`init_dense`
come from an explicit ``torch.Generator`` and differ from ``jax.random``'s
for the same seed.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in float32, cast back to ``x``'s type."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)`` with the weight (and bias) cast to ``x``'s type."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def mlp(x: torch.Tensor, params: Dict[str, torch.Tensor], activation: str = "relu") -> torch.Tensor:
    """Plain 2-layer MLP (recsys towers): ``wi``/``bi``, then ``wo``/``bo``;
    gelu is the tanh form, as ``jax.nn.gelu``'s default."""
    h = dense(x, params["wi"], params.get("bi"))
    h = torch.relu(h) if activation == "relu" else F.gelu(h, approximate="tanh")
    return dense(h, params["wo"], params.get("bo"))


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def init_dense(generator: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Glorot-normal ``w`` (and a zero ``b``) drawn from ``generator``, which
    must live on ``device``."""
    dev = resolve_device(device)
    scale = (2.0 / (d_in + d_out)) ** 0.5
    params = {"w": torch.randn((d_in, d_out), generator=generator, dtype=dtype,
                               device=dev).mul_(scale)}
    if bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return params
