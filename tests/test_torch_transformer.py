"""The transformer (``repro_torch.models.{layers,attention,transformer}``)
held against the JAX reference on the CPU.

Each arch (gemma-7b, qwen1.5-4b, qwen3-4b, and the MLA and MoE archs
deepseek-v2-lite-16b and granite-moe-1b-a400m) runs at its
``smoke_config()`` (2 or 3 layers, d 64, float32, ``attn_chunk`` 8, so a
16-token batch takes two chunks; the MoE smoke configs are dropless at
capacity factor 4).  Both packages take the same numpy weights (the reference's
``init_params``, its zero leaves — norms, biases, qk-norm scales — drawn
N(0, 0.1^2) so that they count) through
``transformer_params_from_numpy``; the reference runs under ``jax.jit``.
Batches are drawn with numpy: 2 x 16 tokens, labels the next token with
some masked (-1).

Tolerances: 1e-5 (rtol and atol) in float32 and 2e-2 in bfloat16, as
``tests/test_kernels.py``; gradients within 1e-5 relative + 1e-6 absolute,
as ``tests/test_torch_gnn.py``.  The ``attn_softmax_dtype="bf16"`` variant
rounds its softmax to bfloat16 (PyTorch's softmax rounds once, jax's op by
op), so its loss and gradients are held within 2e-2 of each leaf's largest
value, and it must differ from the float32 softmax.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_lite as jdeepseek
from repro.configs import gemma_7b as jgemma
from repro.configs import granite_moe as jgranite
from repro.configs import qwen3_4b as jqwen3
from repro.configs import qwen15_4b as jqwen15
from repro.distributed import sharding as jsharding
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import tree
from repro_torch.configs import deepseek_v2_lite, gemma_7b, granite_moe, qwen3_4b, qwen15_4b
from repro_torch.distributed.collectives import value_and_grad
from repro_torch.models import attention, layers, transformer
from repro_torch.optim import optimizers

TOL = 1e-5
BF16_TOL = 2e-2
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
DENSE_ARCHS = {"gemma-7b": (jgemma, gemma_7b), "qwen1.5-4b": (jqwen15, qwen15_4b),
               "qwen3-4b": (jqwen3, qwen3_4b)}
ARCHS = {**DENSE_ARCHS, "deepseek-v2-lite-16b": (jdeepseek, deepseek_v2_lite),
         "granite-moe-1b-a400m": (jgranite, granite_moe)}
B, S, DECODE_STEPS = 2, 16, 8


def port_config(jcfg, dtype=torch.float32) -> transformer.TransformerConfig:
    """The port's config with every field of the reference's ``jcfg``."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(transformer.TransformerConfig)
              if f.name != "dtype"}
    return transformer.TransformerConfig(**fields, dtype=dtype)


def _weights(jcfg, seed):
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.array(a)
        return a if a.any() else rng.normal(0, 0.1, a.shape).astype(a.dtype)

    return jax.tree_util.tree_map(leaf, jtfm.init_params(jax.random.PRNGKey(seed), jcfg))


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    return tokens, labels


def _j(tree_np):
    return jax.tree_util.tree_map(jnp.asarray, tree_np)


def _by_path(t, port):
    if port:
        out = {}
        tree.map_with_path(t, lambda parts, leaf: out.__setitem__(tuple(parts), leaf))
        return {path: leaf.detach().float().numpy() for path, leaf in out.items()}
    flat, _ = jax.tree_util.tree_flatten_with_path(t)
    return {tuple(jsharding._path_parts(path)): np.asarray(leaf, np.float32) for path, leaf in flat}


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=what)


def _hold_grads(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    got, want = _by_path(got, True), _by_path(want, False)
    assert got and set(got) == set(want)
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], rtol=rtol, atol=atol, err_msg=str(path))


def _grads_within_leaf_max(got, want, tol):
    """The largest error of each leaf over the leaf's largest value."""
    got, want = _by_path(got, True), _by_path(want, False)
    assert set(got) == set(want)
    worst = 0.0
    for path, g in got.items():
        worst = max(worst, float(np.abs(g - want[path]).max() / np.abs(want[path]).max()))
    assert worst <= tol, worst
    return worst


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _to(x, dtype):
    return torch.tensor(x).to(dtype), jnp.asarray(x).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


LAYER_CASES = [(name, dtype) for name in ("rms_norm", "rms_norm_lean", "gated_mlp_swiglu",
                                          "gated_mlp_geglu", "rope_frequencies", "apply_rope")
               for dtype in ("float32", "bfloat16") if (name, dtype) != ("rope_frequencies",
                                                                          "bfloat16")]


@pytest.mark.parametrize("name,dtype", LAYER_CASES)
def test_layer_functions_match_reference(name, dtype):
    t_dtype = getattr(torch, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(LAYER_CASES.index((name, dtype)))
    x_np = rng.normal(0, 1.0, (2, 5, 3, 16)).astype(np.float32)
    scale_np = rng.normal(0, 0.3, (16,)).astype(np.float32)
    x, jx = _to(x_np, t_dtype)
    scale, jscale = _to(scale_np, t_dtype)
    if name in ("rms_norm", "rms_norm_lean"):
        got = getattr(layers, name)(x, scale, 1e-6)
        want = getattr(jlayers, name)(jx, jscale, 1e-6)
    elif name.startswith("gated_mlp"):
        act = name.split("_")[-1]
        w_np = {k: rng.normal(0, 0.25, shp).astype(np.float32)
                for k, shp in (("wg", (16, 24)), ("wi", (16, 24)), ("wo", (24, 16)))}
        got = layers.gated_mlp(x, {k: _to(v, t_dtype)[0] for k, v in w_np.items()}, act)
        want = jlayers.gated_mlp(jx, {k: _to(v, t_dtype)[1] for k, v in w_np.items()}, act)
    elif name == "rope_frequencies":
        got = layers.rope_frequencies(16, 300, 5e6, device="cpu")
        want = jlayers.rope_frequencies(16, 300, 5e6)
    else:
        pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
        got = layers.apply_rope(x, torch.tensor(pos), 1e6)
        want = jlayers.apply_rope(jx, jnp.asarray(pos), 1e6)
    assert got.dtype == (torch.float32 if name == "rope_frequencies" else t_dtype)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, jnp.asarray(want, jnp.float32), tol, name)
    if name.startswith("gated_mlp"):
        with pytest.raises(ValueError, match="activation"):
            layers.gated_mlp(x, {k: _to(v, t_dtype)[0] for k, v in w_np.items()}, "relu")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = [  # (batch, seq, heads, kv heads, chunk)
    (2, 16, 4, 2, 4),    # GQA, four chunks, K/V copied heads first once
    (1, 16, 4, 4, 16),   # one chunk, batch 1 (no copy)
    (2, 18, 4, 2, 4),    # ragged: 18 % 4 != 0 falls back to one chunk
    (2, 16, 6, 3, 32),   # chunk larger than the sequence
]


@pytest.mark.parametrize("softmax", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kh,chunk", ATTN_CASES)
def test_causal_attention_matches_reference(b, s, h, kh, chunk, softmax):
    rng = np.random.default_rng(s * 10 + h + chunk)
    q_np, k_np, v_np = (rng.normal(0, 1, (b, s, n, 8)).astype(np.float32) for n in (h, kh, kh))
    t_sd, j_sd = ((torch.float32, jnp.float32) if softmax == "f32"
                  else (torch.bfloat16, jnp.bfloat16))
    tol = TOL if softmax == "f32" else BF16_TOL
    q, k, v = (torch.tensor(a, requires_grad=True) for a in (q_np, k_np, v_np))
    got = attention.causal_attention(q, k, v, chunk_size=chunk, softmax_dtype=t_sd)

    def ref(q, k, v):
        return jattn.causal_attention(q, k, v, chunk_size=chunk, softmax_dtype=j_sd)

    want = jax.jit(ref)(q_np, k_np, v_np)
    _close(got, want, tol)
    # the gradient of a weighted sum, through the recomputed chunks
    w_np = rng.normal(0, 1, got.shape).astype(np.float32)
    grads = torch.autograd.grad((got * torch.tensor(w_np)).sum(), (q, k, v))
    want_g = jax.jit(jax.grad(lambda *a: jnp.sum(ref(*a) * w_np), argnums=(0, 1, 2)))(
        q_np, k_np, v_np)
    for g, wg in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=GRAD_RTOL if softmax == "f32"
                                   else tol, atol=GRAD_ATOL if softmax == "f32" else tol)


@pytest.mark.parametrize("layout", ["contiguous", "heads_first"])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_matches_reference(per_row, layout):
    rng = np.random.default_rng(int(per_row) * 2 + (layout == "heads_first"))
    b, s, h, kh, hd = 3, 12, 6, 2, 8
    q_np = rng.normal(0, 1, (b, 1, h, hd)).astype(np.float32)
    k_np, v_np = (rng.normal(0, 1, (b, s, kh, hd)).astype(np.float32) for _ in range(2))
    length = np.array([5, 12, 1], np.int32) if per_row else np.int32(7)
    k, v = torch.tensor(k_np), torch.tensor(v_np)
    if layout == "heads_first":
        k, v = (attention.init_kv_cache((b, s, kh, hd), torch.float32, "cpu").copy_(t)
                for t in (k, v))
        assert k.transpose(1, 2).is_contiguous()
    got = attention.decode_attention(torch.tensor(q_np), k, v, torch.tensor(length))
    want = jax.jit(jattn.decode_attention)(q_np, k_np, v_np, jnp.asarray(length))
    _close(got, want)


def _gqa_params(rng, d, h, kh, hd, bias, qk_norm):
    out = {"wq": rng.normal(0, d ** -0.5, (d, h * hd)), "wk": rng.normal(0, d ** -0.5, (d, kh * hd)),
           "wv": rng.normal(0, d ** -0.5, (d, kh * hd)),
           "wo": rng.normal(0, (h * hd) ** -0.5, (h * hd, d))}
    if bias:
        out.update(bq=rng.normal(0, 0.1, (h * hd,)), bk=rng.normal(0, 0.1, (kh * hd,)),
                   bv=rng.normal(0, 0.1, (kh * hd,)))
    if qk_norm:
        out.update(q_norm=rng.normal(0, 0.1, (hd,)), k_norm=rng.normal(0, 0.1, (hd,)))
    return {key: value.astype(np.float32) for key, value in out.items()}


GQA = dict(n_heads=4, n_kv_heads=2, head_dim=8)


@pytest.mark.parametrize("bias,qk_norm", [(True, False), (False, True)])
def test_gqa_qkv_matches_reference(bias, qk_norm):
    rng = np.random.default_rng(int(bias))
    p_np = _gqa_params(rng, 32, 4, 2, 8, bias, qk_norm)
    x_np = rng.normal(0, 1, (2, 6, 32)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 6)).astype(np.int32)
    got = attention.gqa_qkv(torch.tensor(x_np), {k: torch.tensor(v) for k, v in p_np.items()},
                            torch.tensor(pos), rope_theta=1e6, **GQA)
    want = jax.jit(lambda x, p, pos: jattn.gqa_qkv(x, p, pos, rope_theta=1e6, **GQA))(
        x_np, _j(p_np), pos)
    for g, w in zip(got, want):
        _close(g, w)


def test_gqa_self_attention_matches_reference():
    rng = np.random.default_rng(5)
    p_np = _gqa_params(rng, 32, 4, 2, 8, True, True)
    x_np = rng.normal(0, 1, (2, 16, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    got = attention.gqa_self_attention(torch.tensor(x_np), {k: torch.tensor(v) for k, v in p_np.items()},
                                       torch.tensor(pos.copy()), chunk_size=4, **GQA)
    want = jax.jit(lambda x, p: jattn.gqa_self_attention(x, p, pos, chunk_size=4, **GQA))(
        x_np, _j(p_np))
    _close(got, want)


def test_gqa_decode_attention_writes_the_cache_in_place_as_the_reference():
    rng = np.random.default_rng(6)
    p_np = _gqa_params(rng, 32, 4, 2, 8, True, True)
    params = {k: torch.tensor(v) for k, v in p_np.items()}
    b, s = 2, 10
    k0, v0 = (rng.normal(0, 1, (b, s, 2, 8)).astype(np.float32) for _ in range(2))
    cache = attention.KVCache(*(attention.init_kv_cache((b, s, 2, 8), torch.float32, "cpu")
                                .copy_(torch.tensor(a)) for a in (k0, v0)),
                              torch.tensor(4, dtype=torch.int32))
    jcache = jattn.KVCache(jnp.asarray(k0), jnp.asarray(v0), jnp.int32(4))
    step = jax.jit(lambda x, p, c: jattn.gqa_decode_attention(x, p, c, **GQA))
    k_buf, v_buf = cache.k, cache.v
    for i in range(3):
        x_np = rng.normal(0, 1, (b, 1, 32)).astype(np.float32)
        out, cache = attention.gqa_decode_attention(torch.tensor(x_np), params, cache, **GQA)
        want, jcache = step(x_np, _j(p_np), jcache)
        _close(out, want, what=f"step {i}")
        assert cache.k is k_buf and cache.v is v_buf  # written in place
        assert int(cache.length) == int(jcache.length) == 5 + i
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)


# ---------------------------------------------------------------------------
# the three archs at their smoke configs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(ARCHS))
def arch_case(request):
    """An arch's smoke config, weights, batch and the reference's jitted
    forward, loss and gradients, prefill and eight decode steps."""
    arch = request.param
    jmod, pmod = ARCHS[arch]
    jcfg = jmod.smoke_config()
    seed = list(ARCHS).index(arch)
    w = _weights(jcfg, seed)
    tokens, labels = _batch(jcfg.vocab_size, seed + 10)
    jw = _j(w)
    batch = {"tokens": tokens, "labels": labels}
    ref = {"forward": jax.jit(lambda p, t: jtfm.forward(p, t, jcfg))(jw, tokens),
           "prefill": jax.jit(lambda p, t: jtfm.prefill(p, t, jcfg))(jw, tokens)}
    ref["loss"], ref["grads"] = jax.jit(jax.value_and_grad(
        lambda p: jtfm.lm_loss(p, batch, jcfg)))(jw)
    state = jtfm.init_decode_state(jcfg, B, S)
    ref["state0"] = state
    step = jax.jit(lambda p, t, st: jtfm.decode_step(p, t, st, jcfg))
    ref["decode"] = []
    for i in range(DECODE_STEPS):
        logits, state = step(jw, tokens[:, i:i + 1], state)
        ref["decode"].append(logits)
    ref["state"] = state
    return dict(arch=arch, jcfg=jcfg, cfg=pmod.smoke_config(), w=w, tokens=tokens,
                labels=labels, ref=ref)


def _port_params(case):
    return transformer.transformer_params_from_numpy(case["w"], device="cpu")


def test_smoke_config_is_the_reference(arch_case):
    cfg, jcfg = arch_case["cfg"], arch_case["jcfg"]
    assert cfg == port_config(jcfg)


def test_forward_matches_reference(arch_case):
    logits, aux = transformer.forward(_port_params(arch_case), torch.tensor(arch_case["tokens"]),
                                      arch_case["cfg"])
    want_logits, want_aux = arch_case["ref"]["forward"]
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    _close(logits, want_logits)
    _close(aux, want_aux, what="aux")
    assert (float(aux) == 0.0) == (arch_case["cfg"].moe is None)


def test_loss_and_every_gradient_match_reference(arch_case):
    params = _port_params(arch_case)
    before = _by_path(params, True)
    batch = {"tokens": torch.tensor(arch_case["tokens"]), "labels": torch.tensor(arch_case["labels"])}
    loss, grads = value_and_grad(lambda p, b: transformer.lm_loss(p, b, arch_case["cfg"]),
                                 params, batch)
    _close(loss, arch_case["ref"]["loss"], what="loss")
    _hold_grads(grads, arch_case["ref"]["grads"])
    for path, value in _by_path(params, True).items():
        np.testing.assert_array_equal(value, before[path])


def test_prefill_matches_reference(arch_case):
    got = transformer.prefill(_port_params(arch_case), torch.tensor(arch_case["tokens"]),
                              arch_case["cfg"])
    assert tuple(got.shape) == (B, arch_case["cfg"].vocab_size)
    _close(got, arch_case["ref"]["prefill"])


def test_init_decode_state_is_the_reference(arch_case):
    cfg = arch_case["cfg"]
    state = transformer.init_decode_state(cfg, B, S, length=3, device="cpu")
    want = jtfm.init_decode_state(arch_case["jcfg"], B, S, length=3)
    got_leaves, want_leaves = _by_path(state, True), _by_path(want, False)
    assert set(got_leaves) == set(want_leaves)
    for path, value in got_leaves.items():
        assert value.shape == want_leaves[path].shape, path
        np.testing.assert_array_equal(value, want_leaves[path], err_msg=str(path))
    assert state.caches.k.dtype == torch.float32 and state.caches.length.dtype == torch.int32
    assert len(state.first_caches) == cfg.first_dense_layers
    if cfg.mla is None:
        # laid out heads first: each layer's (B, KH, S, hd) view is contiguous
        assert state.caches.k[0].transpose(1, 2).is_contiguous()
    else:  # the latent and the RoPE key, (B, S, width) each
        assert tuple(state.caches.k.shape[1:]) == (B, S, cfg.mla.kv_lora_rank)
        assert tuple(state.caches.v.shape[1:]) == (B, S, cfg.mla.qk_rope_head_dim)


def test_eight_decode_steps_match_reference(arch_case):
    cfg, ref = arch_case["cfg"], arch_case["ref"]
    params = _port_params(arch_case)
    state = transformer.init_decode_state(cfg, B, S, device="cpu")
    k_buf = state.caches.k
    tokens = torch.tensor(arch_case["tokens"])
    for i in range(DECODE_STEPS):
        logits, state = transformer.decode_step(params, tokens[:, i:i + 1], state, cfg)
        assert logits.dtype == torch.float32 and tuple(logits.shape) == (B, cfg.vocab_size)
        _close(logits, ref["decode"][i], what=f"step {i}")
    assert state.caches.k is k_buf  # written in place
    assert int(state.caches.length) == int(ref["state"].caches.length) == DECODE_STEPS
    _close(state.caches.k, ref["state"].caches.k, what="k")
    _close(state.caches.v, ref["state"].caches.v, what="v")
    for got, want in zip(state.first_caches, ref["state"].first_caches, strict=True):
        _close(got.k, want.k, what="first k")
        _close(got.v, want.v, what="first v")
        assert int(got.length) == int(want.length) == DECODE_STEPS


# ---------------------------------------------------------------------------
# the variants (qwen3-4b: grouped heads and qk-norm), counts, refusals
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def variant_case():
    jcfg = jqwen3.smoke_config()
    w = _weights(jcfg, 20)
    tokens, labels = _batch(jcfg.vocab_size, 21)
    return jcfg, w, {"tokens": tokens, "labels": labels}


VARIANTS = {"mem_lean": dict(mem_lean=True), "bf16_softmax": dict(attn_softmax_dtype="bf16"),
            "remat_dots": dict(remat_policy="dots"), "unroll": dict(unroll=True),
            "first_dense_layer": dict(first_dense_layers=1, first_dense_ff=96, n_layers=3)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_loss_and_gradients_match_reference(variant_case, variant):
    base_jcfg, w, batch = variant_case
    jcfg = dataclasses.replace(base_jcfg, **VARIANTS[variant])
    if variant == "first_dense_layer":
        w = _weights(jcfg, 22)
    cfg = port_config(jcfg)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: jtfm.lm_loss(p, batch, jcfg)))(_j(w))
    params = transformer.transformer_params_from_numpy(w, device="cpu")
    tb = {key: torch.tensor(value) for key, value in batch.items()}
    loss, grads = value_and_grad(lambda p, b: transformer.lm_loss(p, b, cfg), params, tb)
    if variant == "bf16_softmax":
        _close(loss, want_loss, BF16_TOL, "loss")
        _grads_within_leaf_max(grads, want, BF16_TOL)
        f32_loss, _ = value_and_grad(lambda p, b: transformer.lm_loss(p, b, port_config(base_jcfg)),
                                     params, tb)
        assert abs(float(loss) - float(f32_loss)) > 1e-6  # the softmax really is bfloat16
    else:
        _close(loss, want_loss, what="loss")
        _hold_grads(grads, want)
    if variant == "first_dense_layer":
        assert len(params["first"]) == 1 and params["first"][0]["mlp"]["wg"].shape == (64, 96)
        logits, _ = transformer.forward(params, tb["tokens"], cfg)
        want_logits = jax.jit(lambda p, t: jtfm.forward(p, t, jcfg)[0])(_j(w), batch["tokens"])
        _close(logits, want_logits, what="logits")


def test_first_dense_layer_decodes_as_the_reference(variant_case):
    base_jcfg, _, batch = variant_case
    jcfg = dataclasses.replace(base_jcfg, **VARIANTS["first_dense_layer"])
    w = _weights(jcfg, 22)
    cfg = port_config(jcfg)
    params = transformer.transformer_params_from_numpy(w, device="cpu")
    state = transformer.init_decode_state(cfg, B, 8, device="cpu")
    jstate = jtfm.init_decode_state(jcfg, B, 8)
    step = jax.jit(lambda p, t, st: jtfm.decode_step(p, t, st, jcfg))
    for i in range(3):
        tok = batch["tokens"][:, i:i + 1]
        logits, state = transformer.decode_step(params, torch.tensor(tok), state, cfg)
        want, jstate = step(_j(w), tok, jstate)
        _close(logits, want, what=f"step {i}")
    _close(state.first_caches[0].k, jstate.first_caches[0].k)
    assert int(state.first_caches[0].length) == int(jstate.first_caches[0].length) == 3


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_counts_and_init_are_the_reference(arch):
    jmod, pmod = ARCHS[arch]
    for jcfg, cfg in ((jmod.CONFIG, pmod.CONFIG), (jmod.smoke_config(), pmod.smoke_config())):
        assert cfg == port_config(jcfg, cfg.dtype)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
    assert pmod.CONFIG.dtype == torch.bfloat16
    # the full config as meta tensors: the reference's leaves, nothing allocated
    meta = transformer.init_params(torch.Generator(), pmod.CONFIG, device="meta")
    want = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0), jmod.CONFIG))
    got_shapes = {}
    tree.map_with_path(meta, lambda parts, leaf: got_shapes.__setitem__(tuple(parts), leaf))
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    assert set(got_shapes) == {tuple(jsharding._path_parts(p)) for p, _ in flat}
    for path, leaf in flat:
        got = got_shapes[tuple(jsharding._path_parts(path))]
        assert got.is_meta and tuple(got.shape) == leaf.shape
        assert str(got.dtype) == f"torch.{leaf.dtype}"  # bfloat16; a MoE router float32
    # drawn from the generator: the same seed the same weights
    cfg = pmod.smoke_config()
    one, two = (transformer.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
                for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(one), tree.leaves(two)))


def test_params_from_numpy_takes_bfloat16_trees():
    jcfg = dataclasses.replace(jgemma.smoke_config(), dtype=jnp.bfloat16)
    w = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jtfm.init_params(key, jcfg))(jax.random.PRNGKey(1)))
    params = transformer.transformer_params_from_numpy(w, device="cpu")
    got, want = _by_path(params, True), _by_path(w, False)
    for path, value in got.items():
        np.testing.assert_array_equal(value, want[path], err_msg=str(path))
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves(params))
    params["embed"].add_(1.0)  # a copy: the numpy tree is untouched
    np.testing.assert_array_equal(_by_path(w, False)[("embed",)], want[("embed",)])


def test_adam_by_blocks_is_bitwise_adam_whole(monkeypatch):
    """Adam updates a leaf larger than its block row block by row: the same
    bits as the whole leaf at once (a stacked (3, 5, 7) leaf, blocks of one
    layer; a (40, 6) table, blocks of 5 rows)."""
    rng = np.random.default_rng(8)
    start = {"layers": {"w": rng.normal(0, 1, (3, 5, 7)).astype(np.float32)},
             "embed": rng.normal(0, 1, (40, 6)).astype(np.float32),
             "scale": np.float32(0.5)}
    grads = [tree.map_leaves(lambda a: rng.normal(0, 1, np.shape(a)).astype(np.float32), start)
             for _ in range(3)]

    def bf16(t):
        return tree.map_leaves(lambda a: torch.tensor(a).to(torch.bfloat16), t)

    runs = []
    for block in (1 << 26, 30):
        monkeypatch.setattr(optimizers, "_ADAM_BLOCK", block)
        adam = optimizers.Adam(lr=0.01, weight_decay=0.1)
        params = bf16(start)
        state = adam.init(params)
        for g in grads:
            adam.apply(params, state, bf16(g))
        runs.append(tree.leaves((params, state)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _chip_smoke():
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


def test_chip_smoke_transformer_phase_rehearses_on_the_cpu():
    """``chip_smoke.py``'s ``cells: transformer`` phase end to end on the CPU
    with each arch's flags at d 64, vocab 512, two layers and short
    sequences: every check holds (the launch counts are checked on the card
    only), and the card's cuts keep every published width and sequence."""
    chip_smoke = _chip_smoke()
    chip_smoke.failures.clear()
    chip_smoke.PATH_LAUNCHES.pop("cells", None)
    small = {}
    for arch, (_, pmod) in DENSE_ARCHS.items():
        grouped = pmod.CONFIG.n_kv_heads < pmod.CONFIG.n_heads
        small[arch] = dataclasses.replace(pmod.CONFIG, d_model=64, n_heads=8 if grouped else 4,
                                          n_kv_heads=2 if grouped else 4, head_dim=16, d_ff=96,
                                          vocab_size=512, attn_chunk=8)
    cuts = {arch: {sid: (2, 2) for sid in ("train_4k", "prefill_32k", "decode_32k", "long_500k")}
            for arch in DENSE_ARCHS}
    out = chip_smoke.lm_cells_phase(torch.device("cpu"), dict(
        cuts=cuts, widths=small,
        seq={"train_4k": 16, "prefill_32k": 16, "decode_32k": 16, "long_500k": 32},
        check=dict(layers=2, tokens=16, chunk=8, decode_steps=2, consistency_tokens=8)))
    assert chip_smoke.failures == []
    assert list(out) == list(DENSE_ARCHS)
    for arch, res in out.items():
        assert np.isfinite(res["train_4k"]["loss"])
        assert res["check"]["decode_vs_forward"] <= 1e-5, arch
        assert res["long_500k"]["seq"] == 32 and res["decode_32k"]["batch"] == 2
    assert chip_smoke.PATH_LAUNCHES["cells"] == {"pruned_topk": 0, "pruned_matmul": 0,
                                                 "add_rows": 0}
    # the card's cuts: the published widths, fewer layers and sequences
    for arch, cells in chip_smoke.LM_CUTS.items():
        full = DENSE_ARCHS[arch][1].CONFIG
        assert set(cells) == {"train_4k", "prefill_32k", "decode_32k", "long_500k"}
        assert all(1 <= layers <= full.n_layers and batch >= 1 for layers, batch in cells.values())
