"""The port's cell registry, abstract arguments, layouts, dense optimizers
and microbatched gradients held against the JAX reference on the CPU.

* Registry: ``ALL_ARCHS`` and ``ASSIGNED_ARCHS`` equal the reference's, and
  every arch is ported (the transformers gemma-7b, qwen1.5-4b, qwen3-4b,
  deepseek-v2-lite-16b and granite-moe-1b-a400m among them) with the
  reference's shape ids.
* Abstract arguments: for every ported cell at its full size, the port's
  meta tensors equal ``jax.eval_shape``'s leaves in path, shape and dtype
  (the LM decode cells' states and caches included).
* Layouts: ``in_shardings`` after ``sanitize_shardings`` spec for spec the
  reference's on ``jax.sharding.AbstractMesh`` shapes (2, 2), (2, 2, 2),
  (16, 16) and (2, 16, 16), the GAT's layout helpers too; the port reads a
  layout-only stand-in mesh.  On (16, 16) qwen1.5-4b's 20 KV heads do not
  divide over "model": its caches take the split-S layout.  The bytes of
  one device's blocks of each cell's arguments (``dryrun.
  device_argument_bytes``) equal the reference's shard shapes.
* ``Adam`` (with and without weight decay) and ``Sgd`` (momentum 0 and 0.9)
  over 3 steps in float32 and bfloat16: within 1e-6 relative (the
  reference called op by op, each op rounded as the port's).
* ``microbatch_grads`` with 1 and 4 microbatches: within 1e-6 of the
  reference and of the full-batch gradient.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import collectives as jcollectives
from repro.distributed import sharding as jsharding
from repro.models import recsys as jrecsys
from repro.optim import optimizers as joptim
from repro_torch import configs, tree
from repro_torch.configs import base
from repro_torch.distributed import collectives, sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import LayoutMesh
from repro_torch.models import recsys
from repro_torch.optim import optimizers

PORTED = ("gemma-7b", "qwen1.5-4b", "qwen3-4b", "deepseek-v2-lite-16b", "granite-moe-1b-a400m",
          "gat-cora", "fm", "sasrec", "bst", "dlrm-mlperf", "dpmf")
MESHES = [((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
CELLS = [(arch, sid) for arch in PORTED for sid in jconfigs.shape_ids(arch)]


@pytest.fixture(scope="module")
def built():
    """Every ported cell of both packages, built once."""
    return {cell: (jconfigs.build_cell(*cell), configs.build_cell(*cell)) for cell in CELLS}


def _ref_leaves(t):
    flat, _ = jax.tree_util.tree_flatten_with_path(t)
    return {tuple(jsharding._path_parts(path)): leaf for path, leaf in flat}


def _port_leaves(t):
    out = {}
    tree.map_with_path(t, lambda parts, leaf: out.__setitem__(tuple(parts), leaf))
    return out


def _at(t, parts):
    for part in parts:
        if isinstance(t, dict):
            t = t[part]
        elif hasattr(t, "_fields"):
            t = getattr(t, part)
        else:
            t = t[int(part)]
    return t


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_names_are_the_reference():
    assert configs.ALL_ARCHS == jconfigs.ALL_ARCHS and len(configs.ALL_ARCHS) == 11
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS and len(configs.ASSIGNED_ARCHS) == 10
    assert configs.PORTED_ARCHS == PORTED == configs.ALL_ARCHS


@pytest.mark.parametrize("arch", PORTED)
def test_ported_archs_have_the_reference_cells(arch):
    assert configs.shape_ids(arch) == jconfigs.shape_ids(arch)
    assert configs.get_config(arch).name == jconfigs.get_config(arch).name
    assert configs.get_smoke_config(arch).name == jconfigs.get_smoke_config(arch).name
    for sid in configs.shape_ids(arch):
        cell = configs.build_cell(arch, sid)
        want = jconfigs.build_cell(arch, sid)
        assert (cell.cell_id, cell.kind, cell.donate_argnums) == (
            want.cell_id, want.kind, want.donate_argnums)


def test_unknown_names_raise_as_the_reference():
    with pytest.raises(KeyError):
        configs.get_module("nope")
    with pytest.raises(KeyError):
        configs.build_cell("fm", "nope")
    assert configs.all_cells() == [cell for cell in jconfigs.all_cells() if cell[0] in PORTED]
    assert configs.all_cells(include_dpmf=False) == [
        cell for cell in jconfigs.all_cells(include_dpmf=False) if cell[0] in PORTED]


def test_shapes_are_the_reference():
    assert base.RECSYS_SHAPES == jconfigs.base.RECSYS_SHAPES
    assert base.LM_SHAPES == jconfigs.base.LM_SHAPES


# ---------------------------------------------------------------------------
# abstract arguments and layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS, ids=["::".join(c) for c in CELLS])
def test_abstract_args_are_the_reference_leaves(built, cell):
    want_cell, got_cell = built[cell]
    want, got = _ref_leaves(want_cell.abstract_args), _port_leaves(got_cell.abstract_args)
    assert list(got) and set(got) == set(want)
    for path, leaf in got.items():
        assert isinstance(leaf, torch.Tensor) and leaf.is_meta, path
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert str(leaf.dtype) == f"torch.{want[path].dtype}", path


def test_full_dlrm_cell_builds_without_allocating():
    t0 = time.perf_counter()
    cell = configs.build_cell("dlrm-mlperf", "train_batch")
    took = time.perf_counter() - t0
    tables = cell.abstract_args[0]["tables"]
    rows = sum(t.shape[0] for t in tables)
    assert rows == 187_770_572 and 4 * 128 * rows / 1e9 > 96.1
    assert all(t.is_meta for t in tree.leaves(cell.abstract_args))
    assert took < 1.0, took


@pytest.mark.parametrize("shape,names", MESHES)
def test_layouts_are_the_reference_specs(built, shape, names):
    amesh = jax.sharding.AbstractMesh(shape, names)
    stand_in = LayoutMesh(shape, names)
    for cell, (want_cell, got_cell) in built.items():
        want = jsharding.sanitize_shardings(want_cell.in_shardings(amesh), want_cell.abstract_args)
        got = sharding.sanitize_shardings(got_cell.in_shardings(stand_in),
                                          got_cell.abstract_args, stand_in)
        want_specs = {path: sharding.P(*sh.spec) for path, sh in _ref_leaves(want).items()}
        got_specs = {path: _at(got, path) for path in _port_leaves(got_cell.abstract_args)}
        assert set(got_specs) == set(want_specs), cell
        for path, spec in got_specs.items():
            assert spec == want_specs[path], (cell, path, spec, want_specs[path])


@pytest.mark.parametrize("shape,names", MESHES)
def test_device_argument_bytes_are_the_reference_shards(built, shape, names):
    """The dry run's bytes of one device's blocks equal the reference's shard
    shapes under ``sanitize_shardings``, cell by cell."""
    amesh = jax.sharding.AbstractMesh(shape, names)
    stand_in = LayoutMesh(shape, names)
    for cell, (want_cell, got_cell) in built.items():
        want = jsharding.sanitize_shardings(want_cell.in_shardings(amesh), want_cell.abstract_args)
        shardings = _ref_leaves(want)
        want_bytes = sum(int(np.prod(shardings[path].shard_shape(leaf.shape))) * leaf.dtype.itemsize
                         for path, leaf in _ref_leaves(want_cell.abstract_args).items())
        assert dryrun.device_argument_bytes(got_cell, stand_in) == want_bytes, cell


@pytest.mark.parametrize("shape,names", MESHES)
def test_layout_helpers_are_the_reference(shape, names):
    amesh = jax.sharding.AbstractMesh(shape, names)
    stand_in = LayoutMesh(shape, names)
    assert sharding.all_axes(stand_in) == jsharding.all_axes(amesh)
    assert sharding.replicated(stand_in) == sharding.P(*jsharding.replicated(amesh).spec)
    assert sharding.ns(stand_in, "model", None) == sharding.P(
        *jsharding.ns(amesh, "model", None).spec)
    spec_fn, want_fn = sharding.recsys_spec_fn(stand_in), jsharding.recsys_spec_fn(amesh)
    for parts, shp in ((["tables", "3"], (8192, 4)), (["tables", "0"], (8191, 4)),
                       (["v"], (9000, 2)), (["w"], (9000,)), (["w"], (10,)),
                       (["mlp", "0", "w"], (9000, 2)), (["item_embed"], (8192, 3)),
                       (["w0"], ())):
        leaf = np.zeros(shp, np.float32)
        assert spec_fn(parts, leaf) == sharding.P(*want_fn(parts, leaf)), parts


@pytest.mark.parametrize("shape,names", MESHES)
def test_gnn_layout_helpers_are_the_reference(shape, names):
    amesh = jax.sharding.AbstractMesh(shape, names)
    stand_in = LayoutMesh(shape, names)
    want = jsharding.gnn_batch_shardings(amesh)
    got = sharding.gnn_batch_shardings(stand_in)
    assert list(got) == list(want)
    for key, sh in want.items():
        assert got[key] == sharding.P(*sh.spec), key
    spec_fn, want_fn = sharding.gnn_spec_fn(stand_in), jsharding.gnn_spec_fn(amesh)
    for parts, shp in ((["layers", "0", "w"], (1433, 64)), (["layers", "1", "a_src"], (1, 7)),
                       (["layers", "0", "bias"], (64,))):
        leaf = np.zeros(shp, np.float32)
        assert spec_fn(parts, leaf) == sharding.P(*want_fn(parts, leaf)) == (None,) * len(shp)


# ---------------------------------------------------------------------------
# dense optimizers
# ---------------------------------------------------------------------------


def _tree_np(rng):
    def draw(*shape):
        return rng.normal(0, 0.5, shape).astype(np.float32)
    return {"emb": draw(6, 4), "mlp": [{"w": draw(4, 3), "b": draw(3)}, {"w": draw(3, 1)}],
            "scale": draw()}


def _to_port(t, dtype):
    return jax.tree_util.tree_map(lambda a: torch.tensor(a).to(dtype), t)


def _to_ref(t, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype), t)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _hold_trees(got, want, rtol):
    got, want = _port_leaves(got), _ref_leaves(want)
    assert got and set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_allclose(_f32(leaf), _f32(want[path]), rtol=rtol, atol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", ["adam", "adam_wd", "sgd", "sgd_momentum"])
def test_dense_optimizers_match_reference(opt, dtype):
    make = {
        "adam": lambda m: m.Adam(lr=0.01),
        "adam_wd": lambda m: m.Adam(lr=0.01, weight_decay=0.1),
        "sgd": lambda m: m.Sgd(lr=0.05),
        "sgd_momentum": lambda m: m.Sgd(lr=0.05, momentum=0.9),
    }[opt]
    t_dtype, j_dtype = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(3)
    start = _tree_np(rng)
    port_opt, ref_opt = make(optimizers), make(joptim)
    params, ref_params = _to_port(start, t_dtype), _to_ref(start, j_dtype)
    state, ref_state = port_opt.init(params), ref_opt.init(ref_params)
    for leaf in tree.leaves(state):
        assert leaf.dtype in (torch.float32, torch.int32)
    leaves_before = tree.leaves(params)
    for step in range(3):
        grads_np = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 1.0, a.shape).astype(np.float32), start)
        out, state_out = port_opt.apply(params, state, _to_port(grads_np, t_dtype), lr_scale=0.5)
        ref_params, ref_state = ref_opt.apply(ref_params, ref_state,
                                              _to_ref(grads_np, j_dtype), lr_scale=0.5)
        assert out is params and state_out is state
        # in place: the same tensors, new values
        assert all(a is b for a, b in zip(tree.leaves(params), leaves_before))
        _hold_trees(params, ref_params, 1e-6)
        if opt == "sgd":
            assert state == {}
        else:
            for key in ref_state:
                if key == "t":
                    assert int(state["t"]) == int(ref_state["t"]) == step + 1
                else:
                    _hold_trees(state[key], ref_state[key], 1e-6)


# ---------------------------------------------------------------------------
# microbatched gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fm_case():
    jcfg = jrecsys.FMConfig(name="fm-mb", n_fields=5, embed_dim=6, vocab_per_field=40)
    cfg = recsys.FMConfig(name="fm-mb", n_fields=5, embed_dim=6, vocab_per_field=40)
    rng = np.random.default_rng(9)
    jparams = jrecsys.init_fm_params(jax.random.PRNGKey(1), jcfg)
    np_params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(np.float32), jparams)
    batch = {"ids": rng.integers(0, 40, (64, 5)).astype(np.int32),
             "label": (rng.random(64) < 0.3).astype(np.float32)}
    return jcfg, cfg, np_params, batch


@pytest.mark.parametrize("n_micro", [1, 4])
def test_microbatch_grads_match_reference_and_full_batch(fm_case, n_micro):
    jcfg, cfg, np_params, batch = fm_case
    t_v = 0.05
    params = recsys.recsys_params_from_numpy(np_params, device="cpu")
    tb = {key: torch.as_tensor(value) for key, value in batch.items()}
    loss, grads = collectives.microbatch_grads(
        lambda p, b: recsys.fm_loss(p, b, cfg, t_v), params, tb, n_micro)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb = {key: jnp.asarray(value) for key, value in batch.items()}
    want_loss, want = jcollectives.microbatch_grads(
        lambda p, b: jrecsys.fm_loss(p, b, jcfg, t_v), jparams, jb, n_micro)
    full_loss, full = jax.value_and_grad(lambda p: jrecsys.fm_loss(p, jb, jcfg, t_v))(jparams)
    assert loss.dtype == torch.float32 and not loss.requires_grad
    for target_loss, target in ((want_loss, want), (full_loss, full)):
        np.testing.assert_allclose(loss.numpy(), np.asarray(target_loss), rtol=1e-6, atol=1e-6)
        for key in ("w0", "w", "v"):
            np.testing.assert_allclose(grads[key].numpy(), np.asarray(target[key]),
                                       rtol=1e-6, atol=1e-6, err_msg=key)
    # the parameters are untouched and carry no gradient
    for key, value in params.items():
        assert value.grad is None and not value.requires_grad
        np.testing.assert_array_equal(value.numpy(), np_params[key])


def test_microbatch_grads_refuses_a_batch_it_cannot_split(fm_case):
    _, cfg, np_params, batch = fm_case
    params = recsys.recsys_params_from_numpy(np_params, device="cpu")
    tb = {key: torch.as_tensor(value[:63]) for key, value in batch.items()}
    with pytest.raises(ValueError, match="must divide"):
        collectives.microbatch_grads(lambda p, b: recsys.fm_loss(p, b, cfg), params, tb, 4)
