"""Shared neural building blocks: norms, gated MLPs, RoPE, embeddings.

Counterpart of ``repro/models/layers.py``, every public name of it: the
recsys models use ``dense``, ``layer_norm``, ``mlp``, ``embed_lookup`` and
``init_dense``; the transformer ``rms_norm``, ``rms_norm_lean``,
``gated_mlp`` and ``apply_rope``.  Plain functions over explicit
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


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 (``rsqrt`` of the mean square), times ``1 + scale``,
    cast back to ``x``'s type."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dtype)


def rms_norm_lean(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Memory-lean RMSNorm: the mean square accumulates in float32 without a
    float32 copy of ``x`` (the reference's dot with
    ``preferred_element_type=float32``), and the normalize and scale
    multiplies stay in ``x``'s type.  Differs from :func:`rms_norm` only by
    the rounding of those products."""
    var = torch.linalg.vector_norm(x, dim=-1, dtype=torch.float32).square() / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


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


def gated_mlp(x: torch.Tensor, params: Dict[str, torch.Tensor],
              activation: str = "swiglu") -> torch.Tensor:
    """SwiGLU / GeGLU feed-forward: ``act(x wg) * (x wi)``, then ``wo``; GeGLU's
    gelu is the tanh form (``jax.nn.gelu(approximate=True)``)."""
    gate = dense(x, params["wg"])
    up = dense(x, params["wi"])
    if activation == "swiglu":
        act = F.silu(gate)
    elif activation == "geglu":
        act = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return dense(act * up, params["wo"])


def mlp(x: torch.Tensor, params: Dict[str, torch.Tensor], activation: str = "relu") -> torch.Tensor:
    """Plain 2-layer MLP (recsys towers): ``wi``/``bi``, then ``wo``/``bo``;
    gelu is the tanh form, as ``jax.nn.gelu``'s default."""
    h = dense(x, params["wi"], params.get("bi"))
    h = torch.relu(h) if activation == "relu" else F.gelu(h, approximate="tanh")
    return dense(h, params["wo"], params.get("bo"))


def _rope_inverse(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_frequencies(head_dim: int, max_pos: int, theta: float = 10000.0,
                     device: DeviceLike = None) -> torch.Tensor:
    """The ``(max_pos, head_dim // 2)`` float32 table of rotation angles,
    ``position * theta^(-2i / head_dim)``."""
    dev = resolve_device(device)
    pos = torch.arange(max_pos, dtype=torch.float32, device=dev)
    return torch.outer(pos, _rope_inverse(head_dim, theta, dev))


def apply_rope(x: torch.Tensor,          # (..., seq, heads, head_dim)
               positions: torch.Tensor,  # (..., seq) int absolute positions
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding in float32, cast back to ``x``'s type: the two halves
    of ``head_dim`` rotate as a pair (not interleaved)."""
    ang = positions.float()[..., None] * _rope_inverse(x.shape[-1], theta, x.device)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


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
