"""The mixture of experts (``repro_torch.models.moe``) and MLA
(``repro_torch.models.attention``'s latent half) held against the JAX
reference on the CPU.

Inputs are drawn with numpy from a seed; both packages take the same
arrays.  ``moe_ffn_xla`` runs at 40 tokens of width 24 over 8 experts,
top-2, with 2 shared experts: dropless (capacity factor 4 and 8) and with
drops (capacity factor 1.0: some expert takes more than its 10 slots, so
the kept tokens must be the reference's).  The loss is ``sum(out * c) +
aux`` for a drawn ``c``; the outputs, the aux loss and the gradient of every
leaf (router, experts, shared experts, tokens) are held within 1e-5 (rtol
and atol) in float32 and, in bfloat16, within 2e-2 of each tensor's
largest value (the port sums a token's rows in float32 and rounds once,
XLA add by add).  MLA's self-attention (two chunks) and its absorbed
decode against a cache written in place: 1e-5.  The expert-parallel form
across 4 ranks is in ``tests/test_torch_multirank.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch import tree
from repro_torch.models import attention, moe
from repro_torch.models.layers import gated_mlp

TOL = 1e-5
BF16_TOL = 2e-2
T, D, E, K, F = 40, 24, 8, 2, 16


def _moe_case(seed, cf, shared=2):
    rng = np.random.default_rng(seed)
    cfg = moe.MoEConfig(num_experts=E, top_k=K, d_ff=F, num_shared=shared, capacity_factor=cf)
    p = {"router": rng.normal(0, 0.3, (D, E)).astype(np.float32),
         "wg": rng.normal(0, 0.2, (E, D, F)).astype(np.float32),
         "wi": rng.normal(0, 0.2, (E, D, F)).astype(np.float32),
         "wo": rng.normal(0, 0.2, (E, F, D)).astype(np.float32)}
    if shared:
        p["shared"] = {"wg": rng.normal(0, 0.2, (D, shared * F)).astype(np.float32),
                       "wi": rng.normal(0, 0.2, (D, shared * F)).astype(np.float32),
                       "wo": rng.normal(0, 0.2, (shared * F, D)).astype(np.float32)}
    x = rng.normal(0, 1, (T, D)).astype(np.float32)
    cot = rng.normal(0, 1, (T, D)).astype(np.float32)
    return cfg, p, x, cot


def _reference(cfg, p, x, cot, bf16):
    jcfg = jmoe.MoEConfig(*cfg)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    jp = {key: (jnp.asarray(value) if key == "router" else
                jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dt), value))
          for key, value in p.items()}

    def loss(params, xx):
        out, aux = jmoe.moe_ffn_xla(xx, params, jcfg)
        return jnp.sum(out.astype(jnp.float32) * cot) + aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x).astype(dt))
    return out, aux, grads


def _port(cfg, p, x, cot, bf16, **kwargs):
    dt = torch.bfloat16 if bf16 else torch.float32
    tp = {key: (torch.tensor(value) if key == "router" else
                tree.map_leaves(lambda a: torch.tensor(a).to(dt), value))
          for key, value in p.items()}
    tree.map_leaves(lambda t: t.requires_grad_(), tp)
    tx = torch.tensor(x).to(dt).requires_grad_()
    out, aux = moe.moe_ffn_xla(tx, tp, cfg, **kwargs)
    ((out.float() * torch.tensor(cot)).sum() + aux).backward()
    return out, aux, (tree.map_leaves(lambda t: t.grad, tp), tx.grad)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _hold(got, want, bf16, what):
    got, want = _np(got), _np(want)
    if bf16:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max(), what
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def _leaves(grads):
    p_grads, x_grad = grads
    out = {"x": x_grad}
    tree.map_with_path(p_grads, lambda parts, leaf: out.__setitem__("/".join(parts), leaf))
    return out


def _ref_leaves(grads):
    p_grads, x_grad = grads
    out = {"x": x_grad}
    flat, _ = jax.tree_util.tree_flatten_with_path(p_grads)
    for path, leaf in flat:
        out["/".join(str(getattr(part, "key", part)) for part in path)] = leaf
    return out


CASES = [("dropless_cf4", 4.0, False), ("dropless_cf8", 8.0, False), ("drops_cf1", 1.0, False),
         ("bf16_drops_cf1", 1.0, True)]


@pytest.mark.parametrize("name,cf,bf16", CASES, ids=[c[0] for c in CASES])
def test_moe_ffn_xla_matches_reference(name, cf, bf16):
    cfg, p, x, cot = _moe_case(CASES.index((name, cf, bf16)), cf)
    want_out, want_aux, want_grads = _reference(cfg, p, x, cot, bf16)
    out, aux, grads = _port(cfg, p, x, cot, bf16)
    assert out.dtype == (torch.bfloat16 if bf16 else torch.float32) and aux.dtype == torch.float32
    _hold(out, want_out, bf16, "out")
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), rtol=TOL, atol=1e-7)
    got, want = _leaves(grads), _ref_leaves(want_grads)
    assert set(got) == set(want) == {"x", "router", "wg", "wi", "wo", "shared/wg", "shared/wi",
                                     "shared/wo"}
    for key, value in got.items():
        assert value is not None and float(np.abs(_np(value)).max()) > 0, key
        _hold(value, want[key], bf16, key)
    # with drops some expert is over its capacity; dropless, none is
    r = moe.route(torch.tensor(x).to(out.dtype), torch.tensor(p["router"]), cfg)
    counts = np.bincount(r.experts.numpy().reshape(-1), minlength=E)
    assert (counts.max() > moe._capacity(T, cfg)) == (cf == 1.0), counts


def test_capacity_is_the_reference():
    for t, k, cf, e in ((40, 2, 1.25, 8), (4096, 6, 1.25, 64), (1, 8, 1.25, 32), (33, 3, 0.7, 5)):
        cfg = moe.MoEConfig(num_experts=e, top_k=k, d_ff=4, capacity_factor=cf)
        assert moe._capacity(t, cfg) == jmoe._capacity(t, jmoe.MoEConfig(*cfg))


def test_expert_ties_go_to_the_lower_index():
    """Equal router columns: every tie goes to the lower expert index, as
    ``jax.lax.top_k`` gives it."""
    cfg, p, x, cot = _moe_case(7, 4.0, shared=0)
    router = p["router"].copy()
    router[:, 5] = router[:, 2]             # experts 2 and 5 always tie
    router[:, 6] = router[:, 7] = 0.0       # so do 6 and 7
    p["router"] = router
    x[:4] = 0.0                             # four tokens tie across all 8 experts
    r = moe.route(torch.tensor(x), torch.tensor(router), cfg)
    _, want_ids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), -1), K)
    np.testing.assert_array_equal(r.experts.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(r.experts.numpy()[:4], [[0, 1]] * 4)
    both = r.experts.numpy()
    assert not ((both == 5).any(axis=1) & ~(both == 2).any(axis=1)).any()
    want_out, _, _ = _reference(cfg, p, x, cot, False)
    out, _, _ = _port(cfg, p, x, cot, False)
    _hold(out, want_out, False, "out")


def test_moe_ffn_falls_back_without_a_mesh():
    cfg, p, x, _ = _moe_case(3, 8.0)
    tp = tree.map_leaves(torch.tensor, p)
    out, aux = moe.moe_ffn(torch.tensor(x), tp, cfg, use_shard_map=True)  # no mesh
    want, want_aux = moe.moe_ffn_xla(torch.tensor(x), tp, cfg)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)
    assert out.shape == x.shape and bool(torch.isfinite(aux))
    with pytest.raises(ValueError, match="mesh"):
        moe.moe_ffn_shard_map(torch.tensor(x), tp, cfg)


def test_routes_recorded_and_replayed():
    """Routings recorded in call order and replayed: the replayed ids give
    the output and aux loss of the experts they name (a dropless config,
    held within 1e-5 against a sum over each token's experts), each call's
    own routing is still reported, the margins are the k-th probability
    less the (k+1)-th, and a replay of more or fewer routings than are made
    raises."""
    cfg, p, x, cot = _moe_case(4, 8.0)
    tp = tree.map_leaves(torch.tensor, p)
    tx = torch.tensor(x)
    with moe.routes_recorded() as store:
        want, _ = moe.moe_ffn_xla(tx, tp, cfg)
        moe.moe_ffn_xla(tx * 2, tp, cfg)
    assert len(store) == 2
    rec = store[0]
    probs = torch.softmax(tx @ tp["router"], -1)
    top = torch.sort(probs, -1, descending=True).values
    assert torch.equal(rec.experts, moe.route(tx, tp["router"], cfg).experts)
    torch.testing.assert_close(rec.margin, top[:, K - 1] - top[:, K], rtol=0, atol=1e-7)
    other = torch.roll(rec.experts, 1, dims=0)
    with moe.routes_replayed([other]) as natural:
        got, aux = moe.moe_ffn_xla(tx, tp, cfg)
    assert len(natural) == 1 and torch.equal(natural[0], rec.experts)
    assert not torch.equal(got, want)
    gates = torch.gather(probs, 1, other)
    gates = gates / gates.sum(-1, keepdim=True)
    expect = gated_mlp(tx, tp["shared"], "swiglu")
    for j in range(K):
        ex = other[:, j]
        hidden = (torch.nn.functional.silu(torch.einsum("td,tdf->tf", tx, tp["wg"][ex]))
                  * torch.einsum("td,tdf->tf", tx, tp["wi"][ex]))
        expect = expect + gates[:, j:j + 1] * torch.einsum("tf,tfd->td", hidden, tp["wo"][ex])
    torch.testing.assert_close(got, expect, rtol=TOL, atol=TOL)
    density = torch.bincount(other.reshape(-1), minlength=E).float() / (T * K)
    torch.testing.assert_close(aux, cfg.router_aux_weight * E * (density * probs.mean(0)).sum(),
                               rtol=TOL, atol=1e-7)
    with pytest.raises(RuntimeError, match="more routings"):
        with moe.routes_replayed([other]):
            moe.moe_ffn_xla(tx, tp, cfg)
            moe.moe_ffn_xla(tx, tp, cfg)
    with pytest.raises(RuntimeError, match="2 routings replayed, 1 made"):
        with moe.routes_replayed([other, other]):
            moe.moe_ffn_xla(tx, tp, cfg)


# deepseek-v2-lite's and granite-moe's routing: T, E, top-k, shared experts
PUBLISHED_ROUTING = [("deepseek_train_4k", 4096, 64, 6, 2), ("granite_prefill_32k", 32768, 32, 8, 0)]


@pytest.mark.parametrize("shared_dir", [0, 1], ids=["iid", "correlated"])
@pytest.mark.parametrize("name,t,e,k,shared", PUBLISHED_ROUTING,
                         ids=[c[0] for c in PUBLISHED_ROUTING])
def test_dropping_matches_reference_at_the_published_routing(name, t, e, k, shared, shared_dir):
    """The cells' routing shapes (tokens, experts, top-k, capacity factor
    1.25) at a narrow width (d 64, experts 8 wide): tokens of small
    integers over a router on a grid of 1/64, so that the logits are exact
    in float32 on both sides and no expert choice flips by rounding.
    Independent tokens drop almost nothing; tokens sharing a direction
    (``shared_dir``) concentrate the routing and drop 15-30% of their
    pairs.  Either way the pairs dropped are the excess of the reference's
    own top-k over the capacity, and the output is the reference's
    ``moe_ffn_xla``'s within 1e-5 of its largest value."""
    d, f = 64, 8
    rng = np.random.default_rng(5)
    cfg = moe.MoEConfig(num_experts=e, top_k=k, d_ff=f, num_shared=shared, capacity_factor=1.25)
    p = {"router": (rng.integers(-32, 33, (d, e)) / 64).astype(np.float32),
         "wg": rng.normal(0, 0.2, (e, d, f)).astype(np.float32),
         "wi": rng.normal(0, 0.2, (e, d, f)).astype(np.float32),
         "wo": rng.normal(0, 0.2, (e, f, d)).astype(np.float32)}
    if shared:
        p["shared"] = {key: rng.normal(0, 0.2, shape).astype(np.float32) for key, shape in
                       (("wg", (d, shared * f)), ("wi", (d, shared * f)), ("wo", (shared * f, d)))}
    x = (rng.integers(-2, 3, (t, d)) + rng.integers(-1, 2, d) * shared_dir).astype(np.float32)
    jcfg = jmoe.MoEConfig(*cfg)
    want, want_aux = jax.jit(lambda xx, pp: jmoe.moe_ffn_xla(xx, pp, jcfg))(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p))
    with moe.drops_counted() as drops:
        got, aux = moe.moe_ffn_xla(torch.tensor(x), tree.map_leaves(torch.tensor, p), cfg)
    ids = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1),
                                   k)[1])
    excess = np.maximum(np.bincount(ids.reshape(-1), minlength=e) - moe._capacity(t, cfg), 0)
    (dropped, pairs), = drops
    assert int(pairs) == t * k and int(dropped) == int(excess.sum())
    share = int(dropped) / (t * k)
    assert (share > 0.15) if shared_dir else (share < 0.01), share
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL, atol=1e-7)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA = dict(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
MB, MS, MD, MH = 2, 16, 64, 4


def _mla_params(seed):
    rng = np.random.default_rng(seed)
    w = jax.tree_util.tree_map(np.asarray, jattn.init_mla_params(
        jax.random.PRNGKey(seed), MD, MH, jattn.MLAConfig(**MLA)))
    w["kv_a_norm"] = rng.normal(0, 0.1, w["kv_a_norm"].shape).astype(np.float32)
    return w, rng


def test_mla_init_is_the_reference_tree():
    want = jattn.init_mla_params(jax.random.PRNGKey(0), MD, MH, jattn.MLAConfig(**MLA))
    got = attention.init_mla_params(torch.Generator().manual_seed(0), MD, MH,
                                    attention.MLAConfig(**MLA), device="cpu", lead=(3,))
    assert set(got) == set(want)
    for key, value in got.items():
        assert tuple(value.shape) == (3,) + tuple(want[key].shape), key
    assert not got["kv_a_norm"].any() and float(got["wq"].std()) == pytest.approx(MD ** -0.5, 0.1)


@pytest.mark.parametrize("chunk", [8, 16])
def test_mla_self_attention_matches_reference(chunk):
    w, rng = _mla_params(1)
    x = rng.normal(0, 1, (MB, MS, MD)).astype(np.float32)
    cot = rng.normal(0, 1, (MB, MS, MD)).astype(np.float32)
    pos = np.broadcast_to(np.arange(MS, dtype=np.int32), (MB, MS))

    def jloss(params, xx):
        out = jattn.mla_self_attention(xx, params, pos, jattn.MLAConfig(**MLA), n_heads=MH,
                                       chunk_size=chunk)
        return jnp.sum(out * cot), out

    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, w), jnp.asarray(x))
    tp = {key: torch.tensor(value).requires_grad_() for key, value in w.items()}
    tx = torch.tensor(x).requires_grad_()
    out = attention.mla_self_attention(tx, tp, torch.tensor(pos), attention.MLAConfig(**MLA),
                                       n_heads=MH, chunk_size=chunk)
    (out * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g[1]), rtol=TOL, atol=TOL)
    for key, t in tp.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g[0][key]), rtol=TOL,
                                   atol=TOL, err_msg=key)


def test_mla_decode_writes_the_latent_cache_in_place_as_the_reference():
    """Four decode steps from a cache of 16 positions holding 5 (drawn): the
    outputs, the latent and RoPE-key caches (written in place at
    ``length``) and the lengths, against the reference's steps; the
    reference's own self-attention over the same tokens agrees too."""
    w, rng = _mla_params(2)
    cfg_j, cfg_p = jattn.MLAConfig(**MLA), attention.MLAConfig(**MLA)
    ckv = rng.normal(0, 1, (MB, MS, MLA["kv_lora_rank"])).astype(np.float32)
    krope = rng.normal(0, 1, (MB, MS, MLA["qk_rope_head_dim"])).astype(np.float32)
    xs = rng.normal(0, 1, (4, MB, 1, MD)).astype(np.float32)
    jw = jax.tree_util.tree_map(jnp.asarray, w)
    tw = {key: torch.tensor(value) for key, value in w.items()}
    jcache = jattn.KVCache(jnp.asarray(ckv), jnp.asarray(krope), jnp.int32(5))
    cache = attention.KVCache(torch.tensor(ckv), torch.tensor(krope),
                              torch.tensor(5, dtype=torch.int32))
    k_buf, v_buf = cache.k, cache.v
    step = jax.jit(lambda p, x, c: jattn.mla_decode_attention(x, p, c, cfg_j, n_heads=MH))
    for i in range(4):
        want, jcache = step(jw, jnp.asarray(xs[i]), jcache)
        got, cache = attention.mla_decode_attention(torch.tensor(xs[i]), tw, cache, cfg_p,
                                                    n_heads=MH)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=f"step {i}")
    assert cache.k is k_buf and cache.v is v_buf
    assert int(cache.length) == int(jcache.length) == 9
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), rtol=TOL, atol=TOL)
    # positions past the length untouched
    np.testing.assert_array_equal(cache.k.numpy()[:, 9:], ckv[:, 9:])


def test_mla_decode_matches_self_attention():
    """Decoding a sequence step by step from an empty cache gives the
    self-attention's outputs at every position (the absorbed products
    against the compressed cache are the expanded K/V's attention)."""
    w, rng = _mla_params(3)
    cfg = attention.MLAConfig(**MLA)
    tw = {key: torch.tensor(value) for key, value in w.items()}
    x = torch.tensor(rng.normal(0, 1, (MB, 8, MD)).astype(np.float32))
    full = attention.mla_self_attention(x, tw, torch.arange(8)[None].expand(MB, 8), cfg,
                                        n_heads=MH, chunk_size=8)
    cache = attention.KVCache(torch.zeros(MB, 8, MLA["kv_lora_rank"]),
                              torch.zeros(MB, 8, MLA["qk_rope_head_dim"]),
                              torch.tensor(0, dtype=torch.int32))
    for i in range(8):
        out, cache = attention.mla_decode_attention(x[:, i:i + 1], tw, cache, cfg, n_heads=MH)
        np.testing.assert_allclose(out.numpy(), full[:, i:i + 1].detach().numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"position {i}")


# ---------------------------------------------------------------------------
# the smoke's MoE phase, rehearsed
# ---------------------------------------------------------------------------


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


def test_chip_smoke_moe_phase_rehearses_on_the_cpu():
    """``chip_smoke.py``'s ``cells: moe transformer`` phase end to end on the
    CPU with each arch's flags at d 64, vocab 512, 8 experts, a few layers
    and short sequences: every check holds (the launch counts are checked
    on the card only), the routing is compared and the drops counted; the
    card's cuts keep every expert, deepseek's dense layer and at least
    four MoE layers."""
    from repro_torch import configs

    chip_smoke = _chip_smoke()
    chip_smoke.failures.clear()
    small, cuts = {}, {}
    for arch in chip_smoke.MOE_ARCHS:
        full = configs.get_config(arch)
        kw = dict(d_model=64, n_heads=4, n_kv_heads=4 if full.mla else 2, head_dim=16, d_ff=32,
                  vocab_size=512, attn_chunk=8,
                  moe=full.moe._replace(num_experts=8, d_ff=32, top_k=min(full.moe.top_k, 3)))
        if full.mla is not None:
            kw.update(mla=full.mla._replace(kv_lora_rank=32, qk_nope_head_dim=16,
                                            qk_rope_head_dim=8, v_head_dim=16), first_dense_ff=96)
        small[arch] = dataclasses.replace(full, **kw)
        cuts[arch] = {sid: (full.first_dense_layers + 2, 2)
                      for sid in ("train_4k", "prefill_32k", "decode_32k", "long_500k")}
    out = chip_smoke.moe_cells_phase(torch.device("cpu"), dict(
        cuts=cuts, widths=small,
        seq={"train_4k": 16, "prefill_32k": 16, "decode_32k": 16, "long_500k": 32},
        check=dict(layers=2, tokens=16, chunk=8, decode_steps=2, consistency_tokens=8)))
    assert chip_smoke.failures == []
    assert list(out) == list(chip_smoke.MOE_ARCHS)
    for arch, res in out.items():
        assert np.isfinite(res["train_4k"]["loss"])
        assert 0.0 <= res["train_4k"]["dropped_share"] < 0.5
        assert res["decode_32k"]["dropped_share"] == 0.0  # one token a sequence, 2 sequences
        routing = res["check"]["routing"]
        assert routing["tokens"] > 0 and routing["flipped"] == 0, routing
        assert res["check"]["decode_vs_forward"] <= 1e-5, arch
    for arch, cells in chip_smoke.MOE_CUTS.items():
        full = configs.get_config(arch)
        assert set(cells) == {"train_4k", "prefill_32k", "decode_32k", "long_500k"}
        assert all(full.first_dense_layers + 4 <= layers <= full.n_layers and batch >= 1
                   for layers, batch in cells.values())
        assert cells["long_500k"] == (full.n_layers, 1)  # nothing cut
