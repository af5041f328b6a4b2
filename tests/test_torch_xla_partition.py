"""The dry run's DTensor cells held to XLA's compiled record.

The reference's ``repro.launch.dryrun.run_cell(..., debug=True)`` runs in
one subprocess with 8 forced host devices and reports, for one device of
the (2, 2) or (2, 2, 2) debug mesh, the result bytes and calls of every
collective in its partitioned HLO and its argument and output bytes.  The
port's ``repro_torch.launch.dryrun.run_cell(..., debug=True)`` counts the
same cell partitioned over torch's fake process group.

Each test writes every collective of both programs as terms in the cell's
widths (layers, ``d_model``, FFN width, heads, sequence, batch, ``n_data``,
``n_model``), a reason each: the reference's terms must add up to its
record, and the port's count must be the reference's record with the
reference's terms taken out and the port's put in.  So a difference that
remains is an exact formula, and a change on either side shows here.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs import base
from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
AG, AR, RS = KINDS[:3]
CELLS = [("fm", "retrieval_cand", False), ("fm", "retrieval_cand", True),
         ("gemma-7b", "prefill_32k", False), ("gemma-7b", "train_4k", False)]
IDS = [f"{a}::{s}-{'2x2x2' if m else '2x2'}" for a, s, m in CELLS]

REFERENCE = r'''
import json
from repro.launch import dryrun
out = {}
for arch, sid, multi in %r:
    r = dryrun.run_cell(arch, sid, multi_pod=multi, debug=True)
    out[f"{arch}::{sid}/{multi}"] = {"collectives": r["collectives"], "memory": r["memory"]}
print("REFERENCE " + json.dumps(out))
''' % (CELLS,)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE)], env=env,
                          capture_output=True, text=True, timeout=60)
    line = [x for x in proc.stdout.splitlines() if x.startswith("REFERENCE ")]
    assert proc.returncode == 0 and line, proc.stdout + proc.stderr
    return json.loads(line[0][len("REFERENCE "):])


@pytest.fixture
def no_group():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def record_of(terms):
    """The collectives record (the dry run's keys) of ``terms``, each
    ``(kind, calls, bytes a call, reason)``."""
    out = {f"{k}_bytes": 0.0 for k in KINDS}
    out.update({f"{k}_count": 0 for k in KINDS})
    for kind, calls, each, reason in terms:
        assert reason
        out[f"{kind}_bytes"] += float(calls * each)
        out[f"{kind}_count"] += calls
    out["total_bytes"] = sum(out[f"{k}_bytes"] for k in KINDS)
    return out


def held(ref_record, ref_terms, port_terms):
    """The reference's record with its terms taken out and the port's put in
    (asserting first that its terms add up to it)."""
    assert record_of(ref_terms) == ref_record
    want, ref, port = dict(ref_record), record_of(ref_terms), record_of(port_terms)
    for key in want:
        want[key] += port[key] - ref[key]
    return want


# ---------------------------------------------------------------------------
# fm::retrieval_cand: one context against 1M candidates
# ---------------------------------------------------------------------------


def fm_terms(n_dp):
    """XLA gathers the candidate ids, reads every table row of the context
    and the candidates from each rank's block of ``v`` and ``w`` (split by
    rows over every axis) and all-reduces the rows once; the scores are
    computed on the replicas.  The port's ``gather_rows`` rule does the
    same per table, and ``pruned_matmul`` runs on each rank's block of the
    candidates (``launch.partition._by_columns``)."""
    cfg = configs.get_config("fm")
    k, ctx, c = cfg.embed_dim, cfg.n_fields - 1, 1_000_000
    ref = [(AG, 1, 4 * c, "the candidate ids (int32) gathered whole"),
           (AR, 1, 4 * (k + 1) * (c + ctx),
            "the candidates' and the context's v and w rows, each rank's block masked, "
            "summed whole in one all-reduce")]
    port = [(AG, 2, 4 * c, "the candidate ids (int32) gathered whole, once for each table "
                           "read (v, w): XLA shares one gather between the two"),
            (RS, 1, 4 * k * c // n_dp, "the candidates' v rows, partial over every rank, "
                                       "reduce-scattered over the data ranks as the ids lie"),
            (RS, 1, 4 * c // n_dp, "the candidates' w entries, likewise"),
            (AR, 1, 4 * k * c // n_dp, "then summed over 'model' (DTensor reduces one mesh "
                                       "dim at a time)"),
            (AR, 1, 4 * c // n_dp, "the w entries, likewise"),
            (AR, 2, 4 * k * ctx, "the context's v rows, summed over each mesh dim in turn"),
            (AR, 2, 4 * ctx, "the context's w entries, likewise")]
    return ref, port


# ---------------------------------------------------------------------------
# gemma-7b on (2, 2)
# ---------------------------------------------------------------------------


def gemma_widths(shape_id):
    cfg = configs.get_config("gemma-7b")
    shape = base.LM_SHAPES[shape_id]
    # multi-head attention: every attention weight is d x (heads x head_dim)
    assert cfg.n_kv_heads == cfg.n_heads
    return dict(L=cfg.n_layers, d=cfg.d_model, f=cfg.d_ff, q=cfg.n_heads * cfg.head_dim,
                v=cfg.vocab_size, B=shape["global_batch"], S=shape["seq_len"], n_dp=2, n_m=2)


def prefill_terms():
    """XLA's CPU partitioner gathers the batch and every weight whole and
    runs the step replicated (in float32: the CPU's bfloat16 dots are
    float32), and its HLO holds the scanned layers' body once.  DTensor
    keeps the batch over the data ranks, and after the first layer's
    partial sums the residual stream lies split over 'model' by batch rows
    too, so each of the L unrolled layers gathers its weights in bfloat16
    (the first layer's attention runs column-parallel on the replicated
    input and gathers none)."""
    w = gemma_widths("prefill_32k")
    L, d, f, q, v, B, S, n_m = (w[k] for k in ("L", "d", "f", "q", "v", "B", "S", "n_m"))
    b = B // w["n_dp"]
    ref = [(AG, 1, 4 * B * S, "the token ids (int32) gathered whole"),
           (AG, 1, 4 * d * v, "the tied head's table made whole, float32"),
           (AG, 4, 4 * d * q, "the scan body's four attention weights made whole, float32, "
                              "held once for the L layers"),
           (AG, 3, 4 * d * f, "and its three FFN weights"),
           (AR, 1, 4 * B * S * d, "the embedding rows of the whole batch, float32, each rank's "
                                  "block of the table masked")]
    port = [(AG, 3 * L, 2 * d * f, "each layer's three FFN weights made whole, bfloat16"),
            (AG, 4 * (L - 1), 2 * d * q, "each later layer's four attention weights, likewise"),
            (AG, 1, 2 * b * d, "the last position's hidden rows, gathered over 'model' for "
                               "the head"),
            (AR, 1, 2 * b * S * d, "the embedding rows of this data shard, bfloat16, partial "
                                   "over the table's 'model' blocks"),
            (AR, 2, 4 * b * S * d, "the first layer's two norms sum the residual stream's "
                                   "partial sums over 'model', in float32"),
            (RS, 2, 2 * (b // n_m) * S * f, "the first layer's gate and up products, partial "
                                            "over 'model', reduce-scattered by batch rows"),
            (RS, 1, 2 * (b // n_m) * S * d, "the first block's output, likewise")]
    return ref, port


def train_terms():
    """As prefill, and the train step's backward and Adam: XLA gathers each
    weight and both Adam moments whole (stacked, float32) and the backward
    scan body's weights and one FFN activation once; the port's backward
    runs every layer, reduce-scatters its weight gradients by rows over
    'model' and its activations' by batch rows, and ``Adam.apply``'s rule
    lays each gradient out as its weight."""
    w = gemma_widths("train_4k")
    L, d, f, q, v, B, S, n_m = (w[k] for k in ("L", "d", "f", "q", "v", "B", "S", "n_m"))
    b = B // w["n_dp"]
    h = b // n_m
    ref = [(AG, 2, 4 * B * S, "the token ids and labels (int32) gathered whole"),
           (AG, 3, 4 * v * d, "the embedding and its two Adam moments made whole, float32"),
           (AG, 1, 4 * d * v, "the tied head's table, transposed, whole"),
           (AG, 12, 4 * L * d * q, "the four stacked attention weights and their two "
                                   "moments, whole, float32"),
           (AG, 9, 4 * L * d * f, "the three stacked FFN weights and their moments, likewise"),
           (AG, 8, 4 * d * q, "the forward and backward scan bodies' attention weights, "
                              "held once"),
           (AG, 6, 4 * d * f, "and their FFN weights"),
           (AG, 1, 4 * B * S * f, "one FFN activation of the whole batch in the backward body"),
           (AR, 1, 4 * B * S * d, "the embedding rows of the whole batch, float32"),
           (AR, 1, 4 * B * S * d, "their gradient in the backward body, held once")]
    port = [(AG, 8 * L, 2 * d * f, "each layer's FFN weights made whole in the forward, the "
                                   "checkpointed recompute and the backward, bfloat16"),
            (AG, 11 * (L - 1) + L, 2 * d * q, "each layer's attention weights, likewise "
                                              "(none in the first layer's forward)"),
            (AG, 1, 2 * b * S * d, "the first layer's input rows, gathered over 'model' in "
                                   "the backward"),
            (AG, 2, 2 * v * d, "the tied head's table made whole, forward and backward"),
            (AR, 4, 4 * b * S * d, "the first layer's two norms sum the residual stream's "
                                   "partial sums in float32, forward and recompute"),
            (AR, 1, 2 * b * S * d, "the embedding rows of this data shard, bfloat16"),
            (AR, 3, 2 * L * d * f, "Adam lays the stacked FFN weights' gradients out as the "
                                   "weights: their partial sums, whole"),
            (AR, 3, 2 * L * d * q // n_m, "the stacked query, key and value gradients' "
                                          "partial sums over the data ranks"),
            (AR, 1, 2 * L * q * d, "the attention output weight's gradient, whole"),
            (AR, 4, 2 * L * d, "the two stacked norms' gradients, over each mesh dim"),
            (AR, 2, 2 * d, "the final norm's gradient, over each mesh dim"),
            (AR, 2, 2 * (v // n_m) * d, "the tied table's gradient block, in the backward "
                                        "and in Adam"),
            (AR, 1, 4, "the loss"),
            (RS, 6, 2 * h * S * f, "the first layer's gate and up products and their "
                                   "gradients, reduce-scattered by batch rows over 'model'"),
            (RS, 4, 2 * h * S * d, "the first layer's block output and the residual stream's "
                                   "gradients, likewise"),
            (RS, 4, 4 * h * S * d, "the residual stream's gradients through the first "
                                   "layer's norms, in float32"),
            (RS, 3, 2 * L * d * f // n_m, "the stacked FFN gradients reduce-scattered over "
                                          "'model' as Adam lays them out"),
            (RS, 3 * (L - 1), 2 * d * q // n_m, "each later layer's query, key and value "
                                                "weight gradients, by rows over 'model'"),
            (RS, 1, 2 * (v // n_m) * d, "the tied table's gradient, by rows"),
            (RS, 1, 2 * L * q * d // n_m, "the stacked attention output weights' gradient, "
                                          "as Adam lays it out")]
    return ref, port


def _terms(arch, shape_id, multi_pod):
    if arch == "fm":
        return fm_terms(4 if multi_pod else 2)
    return prefill_terms() if shape_id == "prefill_32k" else train_terms()


def _output_bytes(arch, shape_id, multi_pod, record, ref_memory):
    """The port's output bytes for one device from the reference's."""
    if arch == "fm":
        # the port leaves the scores split as the candidates lie; XLA
        # replicates them
        return ref_memory["output_size_bytes"] / (4 if multi_pod else 2)
    w = gemma_widths(shape_id)
    if shape_id == "prefill_32k":
        # the last position's logits, split over the data ranks' rows and
        # the vocabulary's 'model' blocks; XLA's are whole
        assert ref_memory["output_size_bytes"] == 4 * w["B"] * w["v"]
        return 4 * w["B"] * w["v"] / (w["n_dp"] * w["n_m"])
    # XLA's outputs are replicated, plus its output tuple's table of 8-byte
    # pointers (35 leaves: 11 weights, their two moments, the step count and
    # the loss); the port returns its arguments' blocks less the batch's,
    # and the loss
    assert ref_memory["output_size_bytes"] == record["memory"]["global_output_size_bytes"] \
        + 8 * (3 * 11 + 2)
    return record["memory"]["argument_size_bytes"] - 2 * 4 * (w["B"] // w["n_dp"]) * w["S"] + 4


@pytest.mark.parametrize("arch,shape_id,multi_pod", CELLS, ids=IDS)
def test_the_cell_is_held_to_xlas_record(no_group, reference, arch, shape_id, multi_pod):
    ref = reference[f"{arch}::{shape_id}/{multi_pod}"]
    record = dryrun.run_cell(arch, shape_id, multi_pod=multi_pod, debug=True)
    assert record["status"] == "ok" and record["partition"].startswith("dtensor")
    ref_terms, port_terms = _terms(arch, shape_id, multi_pod)
    assert record["collectives"] == held(ref["collectives"], ref_terms, port_terms)
    memory = record["memory"]
    assert memory["argument_size_bytes"] == ref["memory"]["argument_size_bytes"]
    assert memory["output_size_bytes"] == _output_bytes(arch, shape_id, multi_pod, record,
                                                         ref["memory"])


def test_fm_no_longer_gathers_its_tables(no_group, reference):
    """The FM tables are read through ``gather_rows``: the 2x2 count stays
    within twice XLA's (no table is gathered whole)."""
    ref = reference["fm::retrieval_cand/False"]["collectives"]["total_bytes"]
    got = dryrun.run_cell("fm", "retrieval_cand", multi_pod=False, debug=True)
    assert got["collectives"]["total_bytes"] <= 2 * ref
    assert set(got["redistributions"]) == {"gather_rows"}
