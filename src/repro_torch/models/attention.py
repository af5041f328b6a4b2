"""Attention: grouped-query attention (with optional qk-norm and biases),
DeepSeek's multi-head latent attention (MLA), the decode-time KV caches,
and a memory-chunked causal attention that serves 32k prefill without the
full (S, S) scores of a head.

Counterpart of ``repro/models/attention.py``.  The attention is plain
tensor ops, as the reference's ``einsum`` and softmax are: no hand-written
kernel.

Chunked attention loops over query blocks; each block builds only a
(chunk, S) score slice, and is recomputed in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so live
memory is O(chunk * S) while compute stays O(S^2).  Decode attends one
query against the cache: O(S) work, which is why the 500k-position decode
cells run with full attention.

Two layout choices differ from the reference, neither visible in a value:

* The grouped products run per KV head as batched matrix products over
  ``(B, KH)``, with K and V permuted to ``(B, KH, S, hd)`` once a call.
* :func:`init_kv_cache` (and so ``transformer.init_decode_state``) lays a
  ``(B, S, KH, hd)`` cache out in memory as ``(B, KH, S, hd)``: the shape
  is the reference's, but that permutation is then a view, so a decode
  step reads the cache in place instead of copying it for the product.
  Any other layout is accepted (and copied where a product needs it).

Decode writes the new position into the cache **in place** (the port's
counterpart of the decode cell's donated state), at ``cache.length``
through a tensor index: no host sync.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import apply_rope, dense, rms_norm

NEG_INF = -2.0e38


class KVCache(NamedTuple):
    """Decode-time cache: ``k``/``v`` are ``(B, S, KH, hd)``, ``length`` a 0-d
    int32 tensor, the positions currently valid."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def init_kv_cache(shape, dtype, device: DeviceLike = None, *, lead=()) -> torch.Tensor:
    """Zeros of shape ``lead + shape`` (``shape`` = ``(B, S, KH, hd)``) laid out
    as ``lead + (B, KH, S, hd)`` in memory."""
    dev = resolve_device(device, meta_ok=True)
    b, s, kh, hd = shape
    n = len(lead)
    buf = torch.zeros(tuple(lead) + (b, kh, s, hd), dtype=dtype, device=dev)
    return buf.transpose(n + 1, n + 2)


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """``(B, S, KH, hd)`` as ``(B, KH, S, hd)``, copied only where the two
    leading dims cannot share one batch stride (a matrix product's
    batch)."""
    t = t.transpose(1, 2)
    b, kh = t.shape[:2]
    if b > 1 and kh > 1 and t.stride(0) != kh * t.stride(1):
        t = t.contiguous()
    return t


def _split_heads(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """``(..., n * d)`` -> ``(..., n, d)``: a projection's heads."""
    return t.reshape(*t.shape[:-1], n, d)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``(..., n, d)`` -> ``(..., n * d)``: the heads back into one dim."""
    return t.reshape(*t.shape[:-2], -1)


def _group_queries(q: torch.Tensor, kh: int) -> torch.Tensor:
    """``(B, Sq, H, hd)`` -> ``(B, KH, G * Sq, hd)``; head ``h = kh * G + g``."""
    b, sq, h, hd = q.shape
    g = h // kh
    return q.reshape(b, sq, kh, g, hd).permute(0, 2, 3, 1, 4).reshape(b, kh, g * sq, hd)


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, hd), k: (B, Skv, KH, hd) -> (B, H, Sq, Skv) with GQA
    head grouping (H == KH * group), in q's type."""
    b, sq, h, _ = q.shape
    kt = _heads_first(k)
    scores = torch.matmul(_group_queries(q, k.shape[2]), kt.transpose(-1, -2))
    return scores.reshape(b, h, sq, k.shape[1])


def _grouped_combine(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B, H, Sq, Skv), v: (B, Skv, KH, hd) -> (B, Sq, H, hd)."""
    b, h, sq, skv = probs.shape
    kh, hd = v.shape[2], v.shape[3]
    g = h // kh
    out = torch.matmul(probs.reshape(b, kh, g * sq, skv), _heads_first(v))
    return out.reshape(b, kh, g, sq, hd).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


def _chunk_out(q_blk: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start: int,
               softmax_dtype: torch.dtype) -> torch.Tensor:
    """One query block's causal attention: scores cast to ``softmax_dtype``,
    masked with its most negative finite value, softmax in that type."""
    chunk, s = q_blk.shape[1], k.shape[1]
    scores = _grouped_scores(q_blk, k).to(softmax_dtype)  # (B, H, chunk, S)
    qpos = start + torch.arange(chunk, device=q_blk.device)[:, None]
    kpos = torch.arange(s, device=q_blk.device)[None, :]
    # in place: a fresh tensor nothing else holds (the product's output or its
    # cast), so no clone of the (B, H, chunk, S) scores
    scores.masked_fill_(kpos > qpos, torch.finfo(softmax_dtype).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return _grouped_combine(probs, v)  # (B, chunk, H, hd)


def causal_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KH, hd)
    v: torch.Tensor,  # (B, S, KH, hd)
    *,
    chunk_size: int = 1024,
    softmax_scale: Optional[float] = None,
    softmax_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Memory-chunked causal self-attention (training and prefill).

    Query blocks of ``chunk_size`` (one block when ``S % chunk_size != 0``,
    the reference's fallback for ragged shapes), each recomputed in the
    backward pass.  ``softmax_dtype=torch.bfloat16`` halves the bytes of
    the score, mask and softmax chain."""
    b, s, h, hd = q.shape
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    chunk = min(chunk_size, s)
    if s % chunk != 0:
        chunk = s
    q = q * scale
    # K and V heads-first once, not once a chunk
    k = _heads_first(k).transpose(1, 2)
    v = _heads_first(v).transpose(1, 2)
    outs = []
    for i in range(s // chunk):
        q_blk = q[:, i * chunk:(i + 1) * chunk]
        if torch.is_grad_enabled():
            outs.append(torch.utils.checkpoint.checkpoint(
                _chunk_out, q_blk, k, v, i * chunk, softmax_dtype, use_reentrant=False))
        else:
            outs.append(_chunk_out(q_blk, k, v, i * chunk, softmax_dtype))
    return torch.cat(outs, dim=1).reshape(b, s, h, v.shape[-1])


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, hd)
    cache_k: torch.Tensor,  # (B, S, KH, hd)
    cache_v: torch.Tensor,  # (B, S, KH, hd)
    length: torch.Tensor,   # () or (B,) valid length
    *,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """One query a sequence against its cache: positions ``>= length`` masked
    with ``NEG_INF``, the softmax in float32."""
    hd = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    scores = _grouped_scores(q * scale, cache_k).float()  # (B, H, 1, S)
    s = cache_k.shape[1]
    valid = torch.arange(s, device=q.device)[None, :] < length.reshape(-1, 1)
    scores.masked_fill_(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cache_v.dtype)
    return _grouped_combine(probs, cache_v)  # (B, 1, H, hd)


# ---------------------------------------------------------------------------
# GQA block (gemma / qwen families)
# ---------------------------------------------------------------------------


def init_gqa_params(
    generator: torch.Generator,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    *,
    qkv_bias: bool = False,
    qk_norm: bool = False,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    lead: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    """``wq``, ``wk``, ``wv`` N(0, 1/d_model), ``wo`` N(0, 1/(H hd)), drawn in
    that order from ``generator``; zero biases (``qkv_bias``) and qk-norm
    scales (``qk_norm``).  ``lead`` prepends dims to every leaf (the
    transformer's stacked layers), drawn as ``lead`` independent blocks."""
    dev = resolve_device(device, meta_ok=True)

    def draw(shape, scale):
        return torch.empty(tuple(lead) + shape, dtype=dtype, device=dev).normal_(
            generator=generator).mul_(scale)

    def zeros(shape):
        return torch.zeros(tuple(lead) + shape, dtype=dtype, device=dev)

    scale = d_model ** -0.5
    params = {
        "wq": draw((d_model, n_heads * head_dim), scale),
        "wk": draw((d_model, n_kv_heads * head_dim), scale),
        "wv": draw((d_model, n_kv_heads * head_dim), scale),
        "wo": draw((n_heads * head_dim, d_model), (n_heads * head_dim) ** -0.5),
    }
    if qkv_bias:
        params["bq"] = zeros((n_heads * head_dim,))
        params["bk"] = zeros((n_kv_heads * head_dim,))
        params["bv"] = zeros((n_kv_heads * head_dim,))
    if qk_norm:
        params["q_norm"] = zeros((head_dim,))
        params["k_norm"] = zeros((head_dim,))
    return params


def gqa_qkv(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    positions: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    norm_eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projections (with biases where given), qwen3's per-head RMS qk-norm
    before RoPE where given, then RoPE on q and k."""
    b, s, _ = x.shape
    q = _split_heads(dense(x, params["wq"], params.get("bq")), n_heads, head_dim)
    k = _split_heads(dense(x, params["wk"], params.get("bk")), n_kv_heads, head_dim)
    v = _split_heads(dense(x, params["wv"], params.get("bv")), n_kv_heads, head_dim)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], norm_eps)
        k = rms_norm(k, params["k_norm"], norm_eps)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def gqa_self_attention(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    positions: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float = 10000.0,
    norm_eps: float = 1e-6,
    chunk_size: int = 1024,
    softmax_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    q, k, v = gqa_qkv(x, params, positions, n_heads=n_heads, n_kv_heads=n_kv_heads,
                      head_dim=head_dim, rope_theta=rope_theta, norm_eps=norm_eps)
    out = causal_attention(q, k, v, chunk_size=chunk_size, softmax_dtype=softmax_dtype)
    return dense(_merge_heads(out), params["wo"])


def _write_position(cache: torch.Tensor, new: torch.Tensor, length: torch.Tensor) -> None:
    """``cache[:, length] = new[:, 0]`` in place, the reference's
    ``dynamic_update_slice`` at ``length`` (clamped to the last position as
    it clamps), through a tensor index."""
    pos = length.reshape(1).long().clamp(0, cache.shape[1] - 1)
    cache.index_copy_(1, pos, new.to(cache.dtype))


def gqa_decode_attention(
    x: torch.Tensor,  # (B, 1, d)
    params: Dict[str, torch.Tensor],
    cache: KVCache,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float = 10000.0,
    norm_eps: float = 1e-6,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: this position's K and V written into ``cache.k`` and
    ``cache.v`` in place at ``cache.length``, then attention over the first
    ``length + 1`` positions.  Returns the output and the cache (the same
    tensors, ``length + 1``)."""
    b = x.shape[0]
    positions = cache.length.reshape(1, 1).to(torch.int32).expand(b, 1)
    q, k, v = gqa_qkv(x, params, positions, n_heads=n_heads, n_kv_heads=n_kv_heads,
                      head_dim=head_dim, rope_theta=rope_theta, norm_eps=norm_eps)
    _write_position(cache.k, k, cache.length)
    _write_position(cache.v, v, cache.length)
    length = cache.length + 1
    out = decode_attention(q, cache.k, cache.v, length)
    return dense(_merge_heads(out), params["wo"]), KVCache(cache.k, cache.v, length)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV with decoupled RoPE
# ---------------------------------------------------------------------------


class MLAConfig(NamedTuple):
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


def init_mla_params(
    generator: torch.Generator,
    d_model: int,
    n_heads: int,
    cfg: MLAConfig,
    *,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    lead: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    """Full-rank queries ``wq`` (V2-Lite has no query LoRA) and the joint
    down-projection ``wkv_a`` (the latent, then the shared RoPE key) N(0,
    1/d); a zero ``kv_a_norm``; the latent's up-projections ``wk_b`` and
    ``wv_b`` N(0, 1/kv_lora_rank); ``wo`` N(0, 1/(H v_head_dim)); drawn in
    that order from ``generator``, ``lead`` prepended as in
    :func:`init_gqa_params`."""
    dev = resolve_device(device, meta_ok=True)

    def draw(shape, scale):
        return torch.empty(tuple(lead) + shape, dtype=dtype, device=dev).normal_(
            generator=generator).mul_(scale)

    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    scale = d_model ** -0.5
    lora = cfg.kv_lora_rank
    return {
        "wq": draw((d_model, n_heads * qk_head), scale),
        "wkv_a": draw((d_model, lora + cfg.qk_rope_head_dim), scale),
        "kv_a_norm": torch.zeros(tuple(lead) + (lora,), dtype=dtype, device=dev),
        "wk_b": draw((lora, n_heads * cfg.qk_nope_head_dim), lora ** -0.5),
        "wv_b": draw((lora, n_heads * cfg.v_head_dim), lora ** -0.5),
        "wo": draw((n_heads * cfg.v_head_dim, d_model), (n_heads * cfg.v_head_dim) ** -0.5),
    }


def _mla_projections(x, params, positions, cfg: MLAConfig, n_heads: int, rope_theta: float,
                     norm_eps: float):
    """The queries ``(B, S, H, nope)`` and ``(B, S, H, rope)`` (RoPE'd), the
    normed latent ``(B, S, lora)`` and the shared RoPE key ``(B, S, 1,
    rope)``."""
    b, s, _ = x.shape
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    q = dense(x, params["wq"]).reshape(b, s, n_heads, qk_head)
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    kv = dense(x, params["wkv_a"])
    c_kv, k_rope = torch.split(kv, [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, params["kv_a_norm"], norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, rope_theta)  # one key for all heads
    return q_nope, q_rope, c_kv, k_rope


def mla_self_attention(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    positions: torch.Tensor,
    cfg: MLAConfig,
    *,
    n_heads: int,
    rope_theta: float = 10000.0,
    norm_eps: float = 1e-6,
    chunk_size: int = 1024,
    softmax_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Training and prefill: the latent expanded to per-head K (``nope +
    rope`` wide, the RoPE key broadcast to every head: one copy a layer) and
    V (``v_head_dim`` wide), then :func:`causal_attention` with ``softmax_scale
    = (nope + rope) ** -0.5``."""
    b, s, _ = x.shape
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_projections(x, params, positions, cfg, n_heads,
                                                    rope_theta, norm_eps)
    k_nope = dense(c_kv, params["wk_b"]).reshape(b, s, n_heads, cfg.qk_nope_head_dim)
    v = dense(c_kv, params["wv_b"]).reshape(b, s, n_heads, cfg.v_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, n_heads, cfg.qk_rope_head_dim)], dim=-1)
    out = causal_attention(q_full, k_full, v, chunk_size=chunk_size,
                           softmax_scale=qk_head ** -0.5, softmax_dtype=softmax_dtype)
    return dense(out.reshape(b, s, -1), params["wo"])


def mla_decode_attention(
    x: torch.Tensor,  # (B, 1, d)
    params: Dict[str, torch.Tensor],
    cache: KVCache,   # k: the latent (B, S, lora), v: the RoPE key (B, S, rope)
    cfg: MLAConfig,
    *,
    n_heads: int,
    rope_theta: float = 10000.0,
    norm_eps: float = 1e-6,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step against the compressed cache: this position's latent
    and RoPE key written in place at ``cache.length``, the queries mapped
    into the latent space (``W_UK`` absorbed), the two score products added
    in the activations' type before the float32 softmax, the latent context
    mapped out through ``W_UV``.  Returns the output and the cache (the same
    tensors, ``length + 1``)."""
    b = x.shape[0]
    h, lora = n_heads, cfg.kv_lora_rank
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    positions = cache.length.reshape(1, 1).to(torch.int32).expand(b, 1)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_projections(x, params, positions, cfg, n_heads,
                                                            rope_theta, norm_eps)
    _write_position(cache.k, c_kv_new, cache.length)
    _write_position(cache.v, k_rope_new[:, :, 0, :], cache.length)
    length = cache.length + 1
    ckv, krope = cache.k, cache.v
    dt = q_nope.dtype
    # q_lat[h] = q_nope[h] @ W_UK[h]^T, batched over heads: (H, B, lora)
    wk_b = params["wk_b"].to(dt).reshape(lora, h, cfg.qk_nope_head_dim)
    q_lat = torch.matmul(q_nope[:, 0].transpose(0, 1), wk_b.permute(1, 2, 0))
    scores = (torch.matmul(q_lat.transpose(0, 1), ckv.transpose(1, 2).to(dt))
              + torch.matmul(q_rope[:, 0], krope.transpose(1, 2).to(dt)))  # (B, H, S)
    scores = scores.float() * (qk_head ** -0.5)
    valid = torch.arange(ckv.shape[1], device=x.device)[None, :] < length.reshape(-1, 1)
    scores.masked_fill_(~valid[:, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(ckv.dtype)
    ctx_lat = torch.matmul(probs, ckv)                           # (B, H, lora)
    wv_b = params["wv_b"].to(ctx_lat.dtype).reshape(lora, h, cfg.v_head_dim)
    ctx = torch.matmul(ctx_lat.transpose(0, 1), wv_b.transpose(0, 1))  # (H, B, v)
    out = dense(ctx.transpose(0, 1).reshape(b, 1, -1), params["wo"])
    return out, KVCache(ckv, krope, length)
