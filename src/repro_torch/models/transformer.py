"""Decoder-only transformer: gemma-7b (GeGLU, embeddings scaled by
sqrt(d)), qwen1.5-4b (QKV biases, untied head) and qwen3-4b (GQA with
per-head qk RMS-norm), dense; deepseek-v2-lite (MLA, a leading dense layer,
then shared and routed experts) and granite-moe (GQA, routed experts),
sparse.

Counterpart of ``repro/models/transformer.py``.  Parameters are the
reference's tree: ``embed``, ``final_norm``, ``lm_head`` when untied,
``first`` (a list of leading dense layers, when the config has them) and
``layers``, whose leaves are stacked on axis 0 (``(n_layers, ...)``), so a
reference tree carried across by :func:`transformer_params_from_numpy`
computes the same thing.  :func:`init_params` draws from one explicit
``torch.Generator`` (not ``jax.random``'s draws); with ``device="meta"`` it
allocates nothing (the cells' abstract arguments).

Where the reference scans the stacked layers under ``jax.checkpoint``, the
port loops over them in Python, each layer recomputed in the backward pass
(``torch.utils.checkpoint``, non-reentrant): ``remat_policy="full"``
recomputes everything, ``"dots"`` keeps the outputs of the matrix products
without batch dims (the dense projections; the reference's
``dots_with_no_batch_dims_saveable``).  ``unroll`` selects the reference's
Python-unrolled form of the same math, which the port's loop already is.

Two departures, neither visible in a value:

* The embedding lookup is ``kernels.scatter.gather_rows``: its gradient is
  one ``add_rows`` launch on the card (repeated tokens added in batch
  order, so a training step is bitwise reproducible), where PyTorch's own
  index backward adds them with atomics.
* :func:`prefill` applies the final norm and the head to the last position
  only: the reference builds the ``(B, S, V)`` float32 logits first and
  keeps the last (33.6 GB for gemma-7b at one sequence of 32,768).

Decoding writes the caches in place (:mod:`repro_torch.models.attention`);
an MLA config's caches hold the latent ``(B, S, kv_lora_rank)`` and the
RoPE key ``(B, S, qk_rope_head_dim)``.  A mixture-of-experts layer
(:mod:`repro_torch.models.moe`) returns its aux loss, which ``forward``
sums over the layers as the reference does.  ``moe_shard_map`` is read as
the reference reads it; the port's cells run on one device with no mesh,
where it falls back to the single-device dispatch, as the reference does
without an ambient mesh.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint as checkpoint

from repro_torch import tree as tree_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.scatter import gather_rows
from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache, MLAConfig
from repro_torch.models.layers import gated_mlp, rms_norm, rms_norm_lean
from repro_torch.models.moe import MoEConfig, init_moe_params, moe_ffn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "swiglu"        # swiglu | geglu
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False         # gemma multiplies embeddings by sqrt(d)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    first_dense_layers: int = 0       # leading dense-FFN layers (deepseek: 1)
    first_dense_ff: int = 0
    attn_chunk: int = 1024
    unroll: bool = False              # the reference's unrolled form; the port always loops
    moe_shard_map: bool = False       # expert parallelism across ranks (needs a mesh)
    attn_softmax_dtype: str = "f32"   # "bf16" halves the score chain's bytes
    remat_policy: str = "full"        # "dots" saves the dense products' outputs
    mem_lean: bool = False            # lean norms + logits in the residual type
    dtype: torch.dtype = torch.bfloat16

    @property
    def _softmax_dtype(self) -> torch.dtype:
        return torch.float32 if self.attn_softmax_dtype == "f32" else torch.bfloat16

    @property
    def scan_layers(self) -> int:
        return self.n_layers - self.first_dense_layers

    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        d, hd = self.d_model, self.head_dim
        att = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            att = (
                d * self.n_heads * qk
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        if self.moe is not None:
            ffn = self.moe.num_experts * 3 * d * self.moe.d_ff + d * self.moe.num_experts
            ffn += self.moe.num_shared * 3 * d * self.moe.d_ff
        else:
            ffn = 3 * d * self.d_ff
        dense_extra = (
            self.first_dense_layers * (att + 3 * d * self.first_dense_ff)
            if self.first_dense_layers
            else 0
        )
        body = self.scan_layers * (att + ffn) + dense_extra
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return body + embed

    def active_param_count(self) -> int:
        """Activated params per token (MoE counts top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_experts = self.scan_layers * self.moe.num_experts * 3 * d * self.moe.d_ff
        active = self.scan_layers * self.moe.top_k * 3 * d * self.moe.d_ff
        return full - all_experts + active


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(generator, cfg: TransformerConfig, dev, lead: Tuple[int, ...],
                ff: Optional[int]) -> Params:
    """One layer (``lead`` = ``(n,)``: ``n`` layers stacked): attention (GQA's
    ``wq``, ``wk``, ``wv``, ``wo`` or MLA's), then the experts (``moe``, when
    the config has them and ``ff`` is None) or a dense MLP ``ff`` wide:
    ``wg``, ``wi`` N(0, 1/d) and ``wo`` N(0, 1/ff); zero norms."""
    if cfg.mla is not None:
        a = attn.init_mla_params(generator, cfg.d_model, cfg.n_heads, cfg.mla, dtype=cfg.dtype,
                                 device=dev, lead=lead)
    else:
        a = attn.init_gqa_params(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                                 dtype=cfg.dtype, device=dev, lead=lead)

    def draw(shape, scale):
        return torch.empty(lead + shape, dtype=cfg.dtype, device=dev).normal_(
            generator=generator).mul_(scale)

    zeros = functools.partial(torch.zeros, lead + (cfg.d_model,), dtype=cfg.dtype, device=dev)
    layer: Params = {"attn": a, "norm1": zeros(), "norm2": zeros()}
    if cfg.moe is not None and ff is None:
        layer["moe"] = init_moe_params(generator, cfg.d_model, cfg.moe, activation=cfg.activation,
                                       dtype=cfg.dtype, device=dev, lead=lead)
        return layer
    ff = ff or cfg.d_ff
    s_in, s_out = cfg.d_model ** -0.5, ff ** -0.5
    layer["mlp"] = {"wg": draw((cfg.d_model, ff), s_in), "wi": draw((cfg.d_model, ff), s_in),
                    "wo": draw((ff, cfg.d_model), s_out)}
    return layer


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device: DeviceLike = None) -> Params:
    """The reference's tree in ``cfg.dtype``: ``embed`` N(0, 1/d), zero
    ``final_norm``, ``lm_head`` N(0, 1/d) when untied, the leading dense
    layers, then the stacked layers (each with ``moe`` and no ``mlp`` when
    the config has experts); drawn in that order from ``generator`` (which
    must live on ``device``)."""
    dev = resolve_device(device, meta_ok=True)
    d, v = cfg.d_model, cfg.vocab_size

    def draw(shape):
        return torch.empty(shape, dtype=cfg.dtype, device=dev).normal_(
            generator=generator).mul_(d ** -0.5)

    params: Params = {"embed": draw((v, d)),
                      "final_norm": torch.zeros((d,), dtype=cfg.dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = draw((d, v))
    if cfg.first_dense_layers:
        params["first"] = [_init_layer(generator, cfg, dev, (), cfg.first_dense_ff or cfg.d_ff)
                           for _ in range(cfg.first_dense_layers)]
    params["layers"] = _init_layer(generator, cfg, dev, (cfg.scan_layers,), None)
    return params


def transformer_params_from_numpy(tree, device: DeviceLike = None) -> Params:
    """A reference parameter tree of numpy arrays (stacked layers, ``lm_head``
    when untied, the MLA leaves and the nested ``moe``/``shared`` experts;
    bfloat16 arrays too) as tensors on ``device`` (copies), keys, nesting
    and each leaf's type kept (the router float32)."""
    dev = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
        return torch.as_tensor(np.array(a, copy=True)).to(dev)

    return tree_lib.map_leaves(one, tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _unstack(stacked, n: int) -> List[Params]:
    """The ``n`` layers of a stacked tree, each leaf a view (``unbind``: one
    stacked gradient in the backward, not ``n`` full-size ones)."""
    if isinstance(stacked, dict):
        parts = {key: _unstack(value, n) for key, value in stacked.items()}
        return [{key: parts[key][i] for key in stacked} for i in range(n)]
    return list(stacked.unbind(0))


def _norm(cfg: TransformerConfig):
    return rms_norm_lean if cfg.mem_lean else rms_norm


def _ffn(h: torch.Tensor, layer: Params,
         cfg: TransformerConfig) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's experts over its (B * S) tokens and their aux loss, or
    its dense MLP and None."""
    if "moe" in layer:
        b, s, d = h.shape
        out, aux = moe_ffn(h.reshape(b * s, d), layer["moe"], cfg.moe,
                           activation=cfg.activation, use_shard_map=cfg.moe_shard_map)
        return out.reshape(b, s, d), aux
    return gated_mlp(h, layer["mlp"], cfg.activation), None


def _block(x: torch.Tensor, layer: Params, positions: torch.Tensor,
           cfg: TransformerConfig) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-norm block: attention, then the MLP or the experts, each added to
    ``x``.  Returns (output, moe_aux or None)."""
    norm = _norm(cfg)
    h = norm(x, layer["norm1"], cfg.norm_eps)
    if cfg.mla is not None:
        a = attn.mla_self_attention(
            h, layer["attn"], positions, cfg.mla, n_heads=cfg.n_heads, rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps, chunk_size=cfg.attn_chunk, softmax_dtype=cfg._softmax_dtype)
    else:
        a = attn.gqa_self_attention(
            h, layer["attn"], positions, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
            chunk_size=cfg.attn_chunk, softmax_dtype=cfg._softmax_dtype)
    x = x + a
    out, aux = _ffn(norm(x, layer["norm2"], cfg.norm_eps), layer, cfg)
    return x + out, aux


def _dots_policy(ctx, op, *args, **kwargs):
    # the dense projections fold their batch dims into one aten.mm; the
    # attention's products are aten.bmm (batch dims), recomputed
    if op == torch.ops.aten.mm.default:
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _embed(params: Params, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    x = gather_rows(params["embed"], tokens)
    if cfg.embed_scale:  # sqrt(d) rounded to the activations' type, as the reference's
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _head(params: Params, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head.to(x.dtype))


def hidden_states(params: Params, tokens: torch.Tensor,
                  cfg: TransformerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (the final-normed residual stream (B, S, d), the MoE
    aux loss summed over the layers (), float32)."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :].expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    layers = list(params.get("first", [])) + _unstack(params["layers"], cfg.scan_layers)
    block = functools.partial(_block, positions=positions, cfg=cfg)
    context = checkpoint.noop_context_fn
    if cfg.remat_policy == "dots":
        context = functools.partial(checkpoint.create_selective_checkpoint_contexts,
                                    _dots_policy)
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    for i, layer in enumerate(layers):
        # the leading dense layers run as they are, the stacked ones recomputed
        if torch.is_grad_enabled() and i >= cfg.first_dense_layers:
            x, aux = checkpoint.checkpoint(block, x, layer, use_reentrant=False,
                                           context_fn=context)
        else:
            x, aux = block(x, layer)
        if aux is not None:
            aux_total = aux_total + aux
    return _norm(cfg)(x, params["final_norm"], cfg.norm_eps), aux_total


def forward(params: Params, tokens: torch.Tensor,
            cfg: TransformerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), moe_aux ()).  Logits are float32,
    or the residual type with ``mem_lean``; the aux loss is float32, the sum
    over the MoE layers (0 for a dense model)."""
    x, aux = hidden_states(params, tokens, cfg)
    logits = _head(params, x, cfg)
    return (logits if cfg.mem_lean else logits.float()), aux


def _gold_logit(logits: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    """Each position's logit at its label: ``(..., V), (..., 1) -> (...)``."""
    return torch.gather(logits, -1, safe)[..., 0]


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: TransformerConfig) -> torch.Tensor:
    """Next-token cross entropy over the positions with ``labels >= 0``.

    With ``mem_lean`` the ``(B, S, V)`` logit chain stays in the residual
    type and only the reductions (row max, exp-sum, the gold logit)
    accumulate in float32."""
    logits, aux = forward(params, batch["tokens"], cfg)
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0)[..., None]
    if cfg.mem_lean:
        row_max = torch.amax(logits, dim=-1, keepdim=True)
        sumexp = torch.exp(logits - row_max).sum(dim=-1, dtype=torch.float32)
        logz = torch.log(sumexp) + row_max[..., 0].float()
        gold = _gold_logit(logits, safe).float()
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = _gold_logit(logits, safe)
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0) + aux


def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The last position's logits (B, V): the reference's ``forward(...)[:,
    -1]``, with the head applied to that position only."""
    x = hidden_states(params, tokens, cfg)[0][:, -1]
    logits = _head(params, x, cfg)
    return logits if cfg.mem_lean else logits.float()


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    caches: Any          # stacked KVCache over the stacked layers
    first_caches: Any    # tuple of per-layer KVCache for the leading dense layers


def init_decode_state(cfg: TransformerConfig, batch: int, max_len: int, *, length: int = 0,
                      device: DeviceLike = None) -> DecodeState:
    """Zero caches of ``(n_layers, batch, max_len, n_kv_heads, head_dim)``
    (laid out heads first: ``attention.init_kv_cache``), or with MLA the
    latent ``(n_layers, batch, max_len, kv_lora_rank)`` and the RoPE key
    ``(n_layers, batch, max_len, qk_rope_head_dim)``; ``length`` as a 0-d
    int32 tensor."""
    dev = resolve_device(device, meta_ok=True)

    def length_t():
        return torch.full((), length, dtype=torch.int32, device=dev)

    def one(lead=()):
        if cfg.mla is not None:
            return KVCache(*(torch.zeros(tuple(lead) + (batch, max_len, width), dtype=cfg.dtype,
                                         device=dev)
                             for width in (cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim)),
                           length_t())
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return KVCache(attn.init_kv_cache(shape, cfg.dtype, dev, lead=lead),
                       attn.init_kv_cache(shape, cfg.dtype, dev, lead=lead), length_t())

    first = tuple(one() for _ in range(cfg.first_dense_layers))
    return DecodeState(caches=one((cfg.scan_layers,)), first_caches=first)


def _decode_block(x: torch.Tensor, layer: Params, cache: KVCache,
                  cfg: TransformerConfig) -> Tuple[torch.Tensor, KVCache]:
    norm = _norm(cfg)
    h = norm(x, layer["norm1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, new_cache = attn.mla_decode_attention(
            h, layer["attn"], cache, cfg.mla, n_heads=cfg.n_heads, rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps)
    else:
        a, new_cache = attn.gqa_decode_attention(
            h, layer["attn"], cache, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
    x = x + a
    out, _ = _ffn(norm(x, layer["norm2"], cfg.norm_eps), layer, cfg)
    return x + out, new_cache


@torch.no_grad()
def decode_step(params: Params, tokens: torch.Tensor, state: DecodeState,
                cfg: TransformerConfig) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step: (B, 1) tokens -> (B, V) float32 logits and the state,
    its caches written in place at ``length`` (the same tensors, ``length +
    1``).  No gradient flows through it."""
    x = _embed(params, tokens, cfg)
    new_first = []
    for layer, cache in zip(params.get("first", []), state.first_caches):
        x, cache = _decode_block(x, layer, cache, cfg)
        new_first.append(cache)
    caches = state.caches
    for i, layer in enumerate(_unstack(params["layers"], cfg.scan_layers)):
        x, _ = _decode_block(x, layer, KVCache(caches.k[i], caches.v[i], caches.length), cfg)
    x = _norm(cfg)(x, params["final_norm"], cfg.norm_eps)
    logits = _head(params, x, cfg).float()
    new_state = DecodeState(caches=KVCache(caches.k, caches.v, caches.length + 1),
                            first_caches=tuple(new_first))
    return logits[:, 0], new_state
