"""The sharded dry run: a cell's step partitioned on a mesh over torch's
fake process group (``launch.mesh.fake_mesh``) and counted per device
(``roofline.analysis.count``), on the CPU.

* (a) An analytic model: a two-layer MLP, column- then row-parallel, on the
  (2, 2) and (2, 2, 2) fake meshes: the per-device FLOPs, collective bytes
  by kind and ``temp`` equal the hand-computed values exactly.
* (b) dpmf's owner-compute cells against the reference's compiled program
  (``repro.launch.dryrun.run_cell(..., debug=True)`` in a subprocess with
  8 forced host devices): collective bytes and counts by kind, exactly,
  with the difference the port's design makes written as a formula (over
  up to 4 "model" ranks the int8 exchange gathers int8 payloads where the
  reference all-reduces int32; over 8 it all-reduces int32 too).
* (c) The partitioned program against the unsharded step: a qwen3-shaped
  two-layer float32 train step and dpmf's ``train_1m`` at its smoke config
  run as DTensors with real values on 4 gloo ranks match the single-device
  step within 1e-5, and their collectives by kind equal the fake-mesh meta
  count of the same step; ``spmd.all_gather`` over ("pod", "data") is one
  collective on the flattened group, bitwise the nested gathers.
* (d) The reference's representative cells and the four that the one-card
  dry run deferred count ``ok`` on the debug multi-pod mesh.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

import test_torch_multirank_cases as cases
from repro_torch import tree
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import LayoutMesh, fake_mesh, make_debug_mesh
from repro_torch.roofline import analysis
from repro_torch.testing.ranks import RankPool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


@pytest.fixture
def no_group():
    """The fake group is process-global: none before, none after."""
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (a) the analytic MLP
# ---------------------------------------------------------------------------

B, D, H = 64, 32, 128


@pytest.mark.parametrize("multi_pod", [False, True], ids=["2x2", "2x2x2"])
def test_mlp_counts_the_hand_computed_values(no_group, multi_pod):
    """``y = relu(x @ w1) @ w2``: ``x`` rows over the data axes, ``w1``'s
    columns and ``w2``'s rows over "model", ``y`` all-reduced over "model".
    A device holds ``b = B / n_dp`` rows and ``h = H / n_model`` hidden
    units: ``2 b D h`` FLOPs a product, one all-reduce of ``b D`` float32,
    and at its peak the hidden block and its relu (``2 b h`` float32)."""
    layout = make_debug_mesh(multi_pod=multi_pod)
    with fake_mesh(layout) as mesh:
        dp = shd.data_axes(mesh)
        out = shd.placements(shd.P(dp, None), mesh)

        def step(w1, w2, x):
            y = torch.relu(x @ w1) @ w2
            with analysis.caused_by("output"):
                return y.redistribute(mesh, out)

        meta = (torch.empty(D, H, device="meta"), torch.empty(H, D, device="meta"),
                torch.empty(B, D, device="meta"))
        args = shd.distribute_tree(meta, (shd.P(None, "model"), shd.P("model", None),
                                          shd.P(dp, None)), mesh)
        with implicit_replication():
            c = analysis.count(step, *args)
    n_dp = 4 if multi_pod else 2
    b, h = B // n_dp, H // 2
    assert c.flops == 2 * (2 * b * D * h)
    want = {f"{k}_bytes": 0.0 for k in KINDS}
    want.update({f"{k}_count": 0 for k in KINDS})
    want.update({"all-reduce_bytes": 4.0 * b * D, "all-reduce_count": 1,
                 "total_bytes": 4.0 * b * D})
    assert c.collectives.record() == want
    assert c.redistributions == {"output": {"bytes": 4.0 * b * D, "count": 1}}
    assert c.temp == 2 * 4.0 * b * h
    assert c.argument_bytes == 4.0 * (D * h + h * D + b * D)
    assert c.output_bytes == 4.0 * b * D


def test_placements_refuse_an_axis_order_the_mesh_does_not_have(no_group):
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_debug_mesh(multi_pod=True)
    assert shd.placements(shd.P(("pod", "data"), "model"), mesh) == [Shard(0), Shard(0),
                                                                      Shard(1)]
    assert shd.placements(shd.P(None, "model"), mesh) == [Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError, match=r"spec \(\('data', 'pod'\),\)"):
        shd.placements(shd.P(("data", "pod")), mesh)


def test_every_cell_lays_out_with_plain_shards():
    """No layout of any cell names its axes out of the mesh's order, on
    either production mesh, and the multi-pod layouts name "pod" and "data"
    only together (so the dry run may partition a DTensor step on the two
    folded into one dim)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_production_mesh

    for multi_pod in (False, True):
        layout = make_production_mesh(multi_pod=multi_pod)
        for arch, sid in configs.all_cells():
            cell = configs.build_cell(arch, sid)
            specs = []
            tree.map_leaves(lambda leaf, spec: specs.append(spec), cell.abstract_args,
                            shd.sanitize_shardings(cell.in_shardings(layout),
                                                   cell.abstract_args, layout))
            for spec in specs:
                shd.placements(spec, layout)
                for entry in spec:
                    assert not multi_pod or entry is None or \
                        ("pod" in entry) == ("data" in entry), (arch, sid)


# ---------------------------------------------------------------------------
# (b) the owner-compute cells against the reference
# ---------------------------------------------------------------------------

REFERENCE = r'''
import json, sys
from repro.launch import dryrun
out = {}
for multi in (False, True):
    for sid in ("train_1m_sm", "train_1m_smc"):
        out[f"{sid}/{multi}"] = dryrun.run_cell("dpmf", sid, multi_pod=multi, debug=True)["collectives"]
print("REFERENCE " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference_collectives():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE)], env=env,
                          capture_output=True, text=True, timeout=600)
    line = [x for x in proc.stdout.splitlines() if x.startswith("REFERENCE ")]
    assert proc.returncode == 0 and line, proc.stdout + proc.stderr
    return json.loads(line[0][len("REFERENCE "):])


@pytest.mark.parametrize("shape_id", ["train_1m_sm", "train_1m_smc"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["2x2", "2x2x2"])
def test_owner_compute_collectives_equal_the_reference(no_group, reference_collectives,
                                                       shape_id, multi_pod):
    """Result bytes per device and calls by kind.  A psum over both data
    axes is one all-reduce on their flattened group, as XLA's.  The one
    difference, by formula over the batch rows of a data shard ``b``, the
    width ``k`` and the mesh: the int8 ``g_p`` exchange (``_smc``) over
    ``n_model`` <= 4 ranks gathers the int8 payloads (``n_model b k``
    result bytes, one all-gather) where the reference all-reduces them as
    int32 (``4 b k`` bytes in an all-reduce it counts anyway with the
    scale's max); over more ranks the port all-reduces int32 too
    (:func:`test_the_int8_sum_over_eight_ranks_is_an_int32_all_reduce`)."""
    want = dict(reference_collectives[f"{shape_id}/{multi_pod}"])
    record = dryrun.run_cell("dpmf", shape_id, multi_pod=multi_pod, debug=True)
    assert record["status"] == "ok" and record["partition"].startswith("blocks")
    got = record["collectives"]
    n_dp, n_model, k = (4 if multi_pod else 2), 2, 128
    b = 1_048_576 // n_dp
    if shape_id.endswith("c"):
        want["all-reduce_bytes"] -= 4 * b * k
        want["all-gather_bytes"] += n_model * b * k
        want["all-gather_count"] += 1
    want["total_bytes"] = sum(want[f"{kind}_bytes"] for kind in KINDS)
    assert got == want
    # every collective the step ran is one of its named ones
    assert sum(record["collective_names"]["calls"].values()) == sum(
        got[f"{kind}_count"] for kind in KINDS)
    assert record["memory"]["temp_size_bytes"] > 0


@pytest.mark.parametrize("n_model", [4, 8])
def test_the_int8_sum_over_eight_ranks_is_an_int32_all_reduce(no_group, n_model):
    """``compressed_psum`` over ``n_model`` "model" ranks of the fake mesh:
    up to 4 ranks one all-gather of the int8 payloads (``n_model`` bytes an
    element), above one all-reduce of them as int32 (4 bytes an element),
    beside the scale's one-float max."""
    from repro_torch.distributed import compression

    rows, k = 512, 128
    with fake_mesh(LayoutMesh((1, n_model), ("data", "model"))) as mesh:
        g = torch.empty(rows, k, device="meta")
        c = analysis.count(compression.compressed_psum, g, mesh.get_group("model"))
    got = c.collectives.record()
    if n_model <= compression.INT8_GATHER_MAX_RANKS:
        assert (got["all-gather_bytes"], got["all-gather_count"]) == (n_model * rows * k, 1)
        assert (got["all-reduce_bytes"], got["all-reduce_count"]) == (4, 1)
    else:
        assert (got["all-gather_bytes"], got["all-gather_count"]) == (0, 0)
        assert (got["all-reduce_bytes"], got["all-reduce_count"]) == (4 * rows * k + 4, 2)


def test_the_index_gather_moves_int32(no_group):
    record = dryrun.run_cell("dpmf", "train_1m_sm", multi_pod=False, debug=True)
    assert record["collective_names"]["bytes_sent"]["dq index gather"] == 4 * 1_048_576 // 2


# ---------------------------------------------------------------------------
# (c) the partitioned program on 4 gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks():
    with RankPool(4) as pool:
        yield pool


def _numpy(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("name", ["lm", "dpmf"])
def test_the_partitioned_step_is_the_unsharded_step(no_group, ranks, name, monkeypatch):
    from repro_torch.configs import dpmf

    # small_cell sets dpmf's CONFIG to its smoke config: restored after
    monkeypatch.setattr(dpmf, "CONFIG", dpmf.CONFIG)
    shape, names = (2, 2), ("data", "model")
    got = ranks.run(cases.partitioned_step_case, shape, names, name)
    (out, args), collectives = got[0]
    assert all(r[1] == collectives for r in got), "every rank runs the same collectives"
    cell = cases.small_cell(name)
    single = cases.small_cell_args(name)
    want = cell.step_fn(*single)
    got_leaves = tree.leaves((out, args))
    want_leaves = [_numpy(t) for t in tree.leaves((want, single))]
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        if g.size:
            assert np.max(np.abs(g - w)) <= 1e-5 * max(1.0, np.max(np.abs(w)))
    with fake_mesh(LayoutMesh(shape, names), device_type="cpu") as mesh:
        step, dargs = dryrun.partitioned(cell, mesh, cases.small_cell_args(name))
        counted = analysis.count(step, *dargs)
    assert counted.collectives.record() == collectives
    assert collectives["total_bytes"] > 0


def test_a_gather_over_both_data_axes_is_one_collective(ranks):
    for flat, nested, sent, calls in ranks.run(cases.flat_gather_case):
        np.testing.assert_array_equal(flat, nested)
        assert sent == {"g": 24} and calls == {"g": 1}


# ---------------------------------------------------------------------------
# (d) the cells on the debug multi-pod mesh
# ---------------------------------------------------------------------------

CELLS = [("dpmf", "train_1m", ""), ("fm", "retrieval_cand", ""),
         ("granite-moe-1b-a400m", "decode_32k", ""),
         ("dpmf", "train_1m_sm", ""), ("dpmf", "train_1m_smc", ""),
         ("deepseek-v2-lite-16b", "decode_32k", "moe_sm"),
         ("granite-moe-1b-a400m", "train_4k", "moe_sm2")]


@pytest.mark.parametrize("arch,shape_id,variant", CELLS,
                         ids=["::".join(c).rstrip(":") for c in CELLS])
def test_the_cell_counts_on_the_debug_multi_pod_mesh(no_group, arch, shape_id, variant):
    lm = dryrun.is_lm_arch(arch)
    record = dryrun.run_cell(arch, shape_id, multi_pod=True, debug=True,
                             calib_depth=1 if lm else 0, variant=variant)
    assert record["status"] == "ok" and record["mesh"] == "2x2x2"
    mem, coll = record["memory"], record["collectives"]
    assert coll["total_bytes"] > 0 and mem["temp_size_bytes"] > 0
    if record["partition"].startswith("dtensor"):
        assert mem["argument_size_bytes"] == mem["argument_size_per_device_bytes"]
    assert record["roofline"]["collective_s"] == coll["total_bytes"] / analysis.hw.LINK_BANDWIDTH
