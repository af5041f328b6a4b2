"""The dry run (``repro_torch.launch.dryrun``) and the count it stands on
(``repro_torch.roofline.analysis.count``), on the CPU and on meta tensors.

* The LM cells at a small config of each family (GQA: qwen3-4b's smoke
  config; MLA with MoE: deepseek-v2-lite-16b's; GQA with MoE:
  granite-moe-1b-a400m's): the counted FLOPs of the train, prefill and
  decode steps equal an analytic count within 1e-12.  The analytic count
  is the chip smoke's former ``_lm_forward_flops``, with what a step
  really runs beside the forward: a train step is the forward, both
  gradients of every product, and the recomputation of the checkpoints
  (every stacked layer's forward once more up to its last saved tensor,
  which leaves out the FFN's last down projection, and each attention
  chunk's scores once more); a decode step its products for one token and
  the attention over the whole cache.
* ``extrapolate_depth`` of the depth-1 and depth-2 counts equals the count
  at full depth exactly.
* Each kernel's wrapper, under the count, records its formula's dense
  count and runs no op of its plain version; the cells that reach a kernel
  hold its record and no product of the plain version.
* The reference example's four cells (``examples/multiarch_dryrun.py``)
  count at their published widths, and their output bytes equal those of
  ``jax.eval_shape`` of the reference's steps.
* Every cell of ``all_cells()`` (the LM cells at depth 2) is counted,
  partitioned on the production mesh; ``main`` writes its records under
  the results directory only.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs, tree
from repro_torch.configs import base
from repro_torch.kernels import fused_mf_sgd, pruned_matmul, pruned_topk, scatter
from repro_torch.launch import dryrun
from repro_torch.models.moe import _capacity
from repro_torch.roofline import analysis

REL = 1e-12
FAMILIES = ("qwen3-4b", "deepseek-v2-lite-16b", "granite-moe-1b-a400m")
B, S = 2, 32
PRODUCTS = ("mm", "bmm", "addmm", "baddbmm", "matmul")


# ---------------------------------------------------------------------------
# the analytic count
# ---------------------------------------------------------------------------


def _attn_dims(cfg):
    if cfg.mla is not None:
        m = cfg.mla
        return m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    return cfg.head_dim, cfg.head_dim


def _attn_proj(cfg):
    """Multiply-adds of one token's attention projections (prefill/train)."""
    d, h = cfg.d_model, cfg.n_heads
    qk, vh = _attn_dims(cfg)
    if cfg.mla is not None:
        m = cfg.mla
        return (d * h * qk + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * h * (m.qk_nope_head_dim + vh) + h * vh * d)
    return d * h * qk + 2 * d * cfg.n_kv_heads * qk + h * vh * d


def _ffn(cfg, t, dense_ff=None):
    """FLOPs of one FFN over ``t`` tokens: a dense MLP of ``dense_ff``, or
    the MoE layer (router, ``E x capacity`` expert rows, shared experts)."""
    d = cfg.d_model
    if dense_ff is not None:
        return 2.0 * t * 3 * d * dense_ff
    mo = cfg.moe
    rows = mo.num_experts * _capacity(t, mo)
    return (2.0 * t * d * mo.num_experts + 2.0 * rows * 3 * d * mo.d_ff
            + 2.0 * t * 3 * d * mo.num_shared * mo.d_ff)


def _stacked_ff(cfg):
    return None if cfg.moe is not None else cfg.d_ff


def forward_flops(cfg, b, s, last_only=False):
    """The chip smoke's ``_lm_forward_flops`` (as the experts run): the
    dense products, the attention's two products over all s x s scores, the
    head (the last position only for prefill)."""
    t, h = b * s, cfg.n_heads
    qk, vh = _attn_dims(cfg)
    attn = 2.0 * t * _attn_proj(cfg) + 2.0 * b * h * s * s * (qk + vh)
    body = (cfg.n_layers * attn + cfg.scan_layers * _ffn(cfg, t, _stacked_ff(cfg))
            + cfg.first_dense_layers * _ffn(cfg, t, cfg.first_dense_ff or cfg.d_ff))
    return body + 2.0 * b * (1 if last_only else s) * cfg.d_model * cfg.vocab_size


def recompute_flops(cfg, b, s):
    """What the checkpoints run again in the backward: each stacked layer's
    forward (``forward`` checkpoints it) up to its last saved tensor, so
    without the last down projection (the dense FFN's, or the shared
    experts'), and every layer's attention scores once more (each chunk is
    checkpointed inside)."""
    t, h, d = b * s, cfg.n_heads, cfg.d_model
    qk, vh = _attn_dims(cfg)
    last_ff = cfg.d_ff if cfg.moe is None else cfg.moe.num_shared * cfg.moe.d_ff
    layer = (2.0 * t * _attn_proj(cfg) + 2.0 * b * h * s * s * (qk + vh)
             + _ffn(cfg, t, _stacked_ff(cfg)) - 2.0 * t * last_ff * d)
    return cfg.scan_layers * layer + cfg.n_layers * 2.0 * b * h * s * s * qk


def decode_flops(cfg, b, kv_len):
    """One token a sequence: its products, and the attention over all
    ``kv_len`` cache positions (MLA: the absorbed form on the latent)."""
    d, h = cfg.d_model, cfg.n_heads
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        proj = (d * h * qk + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + h * m.qk_nope_head_dim * m.kv_lora_rank + h * m.kv_lora_rank * m.v_head_dim
                + h * m.v_head_dim * d)
        cache = h * kv_len * (2 * m.kv_lora_rank + m.qk_rope_head_dim)
    else:
        proj = _attn_proj(cfg)
        cache = h * kv_len * 2 * cfg.head_dim
    body = (cfg.n_layers * 2.0 * b * (proj + cache)
            + cfg.scan_layers * _ffn(cfg, b, _stacked_ff(cfg))
            + cfg.first_dense_layers * _ffn(cfg, b, cfg.first_dense_ff or cfg.d_ff))
    return body + 2.0 * b * d * cfg.vocab_size


def _small_cells(arch, cfg):
    return {
        "train": base.lm_train_cell(arch, "train", cfg, global_batch=B, seq_len=S),
        "prefill": base.lm_prefill_cell(arch, "prefill", cfg, global_batch=B, seq_len=S),
        "decode": base.lm_decode_cell(arch, "decode", cfg, global_batch=B, kv_len=S),
    }


def _count(cell):
    return analysis.count(cell.step_fn, *cell.abstract_args)


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_cells_count_the_analytic_flops(arch):
    cfg = configs.get_smoke_config(arch)
    counts = {kind: _count(cell) for kind, cell in _small_cells(arch, cfg).items()}
    fwd, rec = forward_flops(cfg, B, S), recompute_flops(cfg, B, S)
    want = {"train": 3 * fwd + rec, "prefill": forward_flops(cfg, B, S, last_only=True),
            "decode": decode_flops(cfg, B, S)}
    for kind, c in counts.items():
        assert abs(c.flops - want[kind]) <= REL * want[kind], (kind, c.flops, want[kind])
    train = counts["train"]
    assert abs(train.recompute_flops - rec) <= REL * rec
    assert counts["prefill"].recompute_flops == counts["decode"].recompute_flops == 0.0
    # a train step reads and writes every weight and both Adam moments
    params = tree.leaves(_small_cells(arch, cfg)["train"].abstract_args[0])
    weights = sum(t.numel() * t.element_size() for t in params)
    assert train.least_bytes >= 6 * weights
    assert train.kernels["add_rows"]["dense"]
    # decode reads the weights (the embedding only at its tokens' rows) and
    # the cache whole, and writes one cache position, the lengths and logits
    dec = _small_cells(arch, cfg)["decode"]
    params, state, _ = dec.abstract_args
    cache = sum(t.numel() * t.element_size() for t in tree.leaves(state))
    embed = params["embed"].numel() * params["embed"].element_size()
    most = weights + cache + cache / S + B * cfg.vocab_size * 4 + B * 4 + 8
    assert weights - embed + cache <= counts["decode"].least_bytes <= most


@pytest.mark.parametrize("arch", FAMILIES)
def test_depth_extrapolation_equals_the_full_count(arch):
    smoke = configs.get_smoke_config(arch)
    records = {}
    for depth in (1, 2, 5):
        cfg = dataclasses.replace(smoke, n_layers=smoke.first_dense_layers + depth)
        for kind, cell in _small_cells(arch, cfg).items():
            c = _count(cell)
            records[kind, depth] = {"cost": {"flops": c.flops,
                                             "bytes_accessed": c.bytes_accessed}}
    for kind in ("train", "prefill", "decode"):
        est = analysis.extrapolate_depth(records[kind, 1], records[kind, 2], 5)
        full = records[kind, 5]["cost"]
        assert est["flops"] == full["flops"], kind
        assert est["bytes_accessed"] == full["bytes_accessed"], kind


# ---------------------------------------------------------------------------
# the kernels under the count
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


KERNELS = {
    "pruned_topk": (lambda: pruned_topk.pruned_topk_ranked(
        _meta(300, 16), _meta(1000, 16), _meta(300, dtype=torch.int32),
        _meta(1000, dtype=torch.int32), _meta(1000), 7),
        pruned_topk.cost(300, 1000, 16, 7)),
    "pruned_matmul": (lambda: pruned_matmul.pruned_matmul_ranked(
        _meta(300, 16), _meta(1000, 16), _meta(300, dtype=torch.int32),
        _meta(1000, dtype=torch.int32)), pruned_matmul.cost(300, 1000, 16)),
    "fused_mf_sgd": (lambda: fused_mf_sgd.fused_mf_sgd_rows(
        _meta(500, 16), _meta(500, 16), _meta(500), _meta(1), _meta(1), lr=0.1, lam=0.01),
        fused_mf_sgd.cost(500, 16)),
    "add_rows": (lambda: scatter.add_rows(_meta(1000, 16), _meta(500, dtype=torch.int64),
                                          _meta(500, 16)),
                 scatter.cost(_meta(1000, 16), _meta(500, dtype=torch.int64), _meta(500, 16))),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_a_wrapper_under_the_count_records_its_formula(name):
    call, cost = KERNELS[name]
    c = analysis.count(call)
    assert c.kernels == {name: {"calls": 1, "flops": cost.flops, "bytes": cost.bytes,
                                "dense": name != "fused_mf_sgd"}}
    assert set(c.op_histogram) <= {"empty", "empty_like"}, c.op_histogram
    assert c.flops == (cost.flops if cost.products else 0.0)
    assert c.bytes_accessed == cost.bytes


@pytest.mark.parametrize("cell,kernel,calls,only_products", [
    (("dpmf", "serve_top100"), "pruned_topk", 1, True),
    (("fm", "retrieval_cand"), "pruned_matmul", 1, True),
    (("sasrec", "serve_bulk"), "pruned_topk", 1, False),
    (("dpmf", "train_1m"), "add_rows", 4, False),
])
def test_cells_hold_the_kernel_records_not_the_plain_versions(cell, kernel, calls,
                                                              only_products):
    """The plain versions' merge (a sort), scatter (``index_add_``) and, where
    the kernel is the step's only product, their products are not counted."""
    c = _count(configs.build_cell(*cell))
    assert c.kernels[kernel]["calls"] == calls and c.kernels[kernel]["dense"]
    assert "index_add" not in c.op_histogram and "sort" not in c.op_histogram
    if only_products:
        assert not set(c.op_histogram) & set(PRODUCTS), c.op_histogram
        assert c.flops == c.kernels[kernel]["flops"]


# ---------------------------------------------------------------------------
# the dry run's cells
# ---------------------------------------------------------------------------

EXAMPLE_CELLS = [("dpmf", "train_1m"), ("gemma-7b", "decode_32k"),
                 ("gat-cora", "full_graph_sm"), ("fm", "retrieval_cand")]


@pytest.mark.parametrize("cell", EXAMPLE_CELLS, ids=["::".join(c) for c in EXAMPLE_CELLS])
def test_the_example_cells_count_with_the_reference_outputs(cell):
    record = dryrun.run_cell(*cell, multi_pod=False)
    assert record["status"] == "ok" and record["device"] == "meta"
    ref = jconfigs.build_cell(*cell)
    out = jax.eval_shape(ref.step_fn, *ref.abstract_args)
    want = sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
               for leaf in jax.tree_util.tree_leaves(out))
    memory = record["memory"]
    assert memory["global_output_size_bytes"] == want
    assert 0 < memory["output_size_bytes"] <= want  # one device's blocks
    roof = record["roofline"]
    assert roof["bound_s"] > 0
    assert roof["collective_s"] == record["collectives"]["total_bytes"] / analysis.hw.LINK_BANDWIDTH
    if cell[0] == "gemma-7b":
        assert roof["dominant"] == "memory" and 0 < roof["roofline_fraction"] < 1
        gemma = configs.get_config("gemma-7b")
        # one device's share of the useful FLOPs of the 256 devices
        assert roof["model_flops"] == 2.0 * 128 * gemma.active_param_count() / 256


def test_every_cell_is_counted_or_deferred():
    """Every cell is counted on the production (16, 16) mesh (none is
    deferred any more), the LM cells at depth 2, and the MoE archs'
    ``moe_sm``/``moe_sm2`` variants too: per device, with collectives and
    a temp peak."""
    for arch, sid in configs.all_cells():
        record = dryrun.run_cell(arch, sid, multi_pod=False,
                                 calib_depth=2 if dryrun.is_lm_arch(arch) else 0)
        assert record["status"] == "ok", (arch, sid)
        memory = record["memory"]
        assert record["cost"]["least_bytes"] > 0 and record["count_s"] >= 0
        assert record["collectives"]["total_bytes"] > 0, (arch, sid)
        assert memory["temp_size_bytes"] > 0, (arch, sid)
        if record["partition"].startswith("dtensor"):  # the blocks' steps take a whole batch
            assert memory["argument_size_per_device_bytes"] == memory["argument_size_bytes"]
    for variant in ("moe_sm", "moe_sm2"):
        for arch in ("deepseek-v2-lite-16b", "granite-moe-1b-a400m"):
            record = dryrun.run_cell(arch, "decode_32k", multi_pod=False, calib_depth=1,
                                     variant=variant)
            assert record["status"] == "ok" and record["collectives"]["total_bytes"] > 0


def test_main_writes_its_records_under_the_results_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path / "dryrun_torch"))
    assert dryrun.main(["--arch", "dpmf", "--mesh", "single"]) == 0
    files = sorted(p.name for p in (tmp_path / "dryrun_torch").iterdir())
    assert files == sorted(f"dpmf__{sid}__singlepod.json" for sid in configs.shape_ids("dpmf"))
    assert [p.name for p in tmp_path.iterdir()] == ["dryrun_torch"]
    statuses = {json.loads((tmp_path / "dryrun_torch" / f).read_text())["status"] for f in files}
    assert statuses == {"ok"}
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k", "--mesh", "multi",
                        "--calib"]) == 0
    full = json.loads((tmp_path / "dryrun_torch" /
                       "qwen3-4b__decode_32k__multipod.json").read_text())
    assert full["mesh"] == "2x16x16" and full["calib"]["difference"] == {
        "flops": 0.0, "bytes_accessed": 0.0, "collective_bytes": 0.0}
