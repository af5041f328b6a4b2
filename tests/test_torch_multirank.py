"""The port's sharded training across ranks held against the JAX reference
on the CPU: the int8 helpers and ``compressed_psum``, the owner router, the
block layouts, the owner-compute step ``mf.train_step_shard_map`` and its
epoch, ``init_error_feedback_state``, ``checkpoint.elastic_load`` and the
refusals; and the mixture of experts' expert-parallel form
``moe.moe_ffn_shard_map``: each data shard's output and aux loss against
the reference's ``moe_ffn_xla`` on that shard (its capacity is the
shard's), with drops and without, and each rank's expert slab's gradients,
summed over the data axes, against the matching slice of the reference's
gradients, within 1e-5.

The port runs SPMD in 4 spawned gloo ranks (one pool per module, a
``file://`` store, so xdist workers never share a port); the reference runs
once per module in a subprocess with 8 forced host devices and writes its
results to an npz.  The reference's epoch scan does not run on the
installed jax (its donated buffers are resharded), so the epoch oracle is a
fold of its jitted per-step calls.

Tolerances: the int8 payloads, ``compressed_psum``, the router and the
block layouts bitwise; the sharded step in mode ``none`` 2e-8 abs (the
reference's own bar, ``tests/test_shard_map_parity.py``) plus 1e-6
relative, and 1e-6 in the int8 modes; sgd on 1/8-grid factors bitwise in
modes none and int8.  The relative term and adagrad's allowance are for XLA's CPU
arithmetic, which differs from PyTorch's by float32 ulps: it compiles
``g / sqrt(a)`` to a multiply by its own reciprocal square root, and its
``sqrt`` is not correctly rounded in about 0.7% of cases.  Under int8 such
an ulp can move an adagrad payload element across a rounding boundary, so
there at most one element in 64 (and at least 2) may differ by up to one
int8 step, which adagrad bounds by ``lr``.  The epoch fold is held as the
step.  The port's sharded step against its own single-device
``train_step``: bitwise.  ``elastic_load``: bitwise.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import test_torch_multirank_cases as cases
from repro.checkpoint import checkpoint as jcheckpoint
from repro.distributed import sharding as jsharding
from repro_torch.checkpoint import checkpoint
from repro_torch.core import mf
from repro_torch.distributed import compression, sharding
from repro_torch.kernels import scatter
from repro_torch.optim.optimizers import RowOptimizer
from repro_torch.testing.ranks import RankPool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N, K, B = 16, 8, 12, 16
MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((4, 1), ("data", "model")), ((2, 1, 2), ("pod", "data", "model"))]
MODES = ("none", "int8", "int8_ef")
EPOCH_STEPS = 3

REFERENCE = r'''
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import mf
from repro.distributed import compression as C, sharding as S
from repro.distributed.mesh_compat import use_mesh
from repro.online import EventBatch, OnlineUpdater
from repro.optim.optimizers import RowOptimizer

M, N, K, B = 16, 8, 12, 16
MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((4, 1), ("data", "model")), ((2, 1, 2), ("pod", "data", "model"))]
out = {}

def mesh_of(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)

def n_dp(shape, names):
    return int(np.prod([s for s, a in zip(shape, names) if a != "model"]))

def tables(grid, seed):
    rng = np.random.default_rng(seed)
    if grid:
        g = lambda *s: (rng.integers(-8, 9, s) / 8.0).astype(np.float32)
        return {"p": g(M, K), "q": g(N, K)}
    return {"p": rng.normal(0, 0.1, (M, K)).astype(np.float32),
            "q": rng.normal(0, 0.1, (N, K)).astype(np.float32)}

def owned_batch(rng, dp, grid, steps=None):
    lead = () if steps is None else (steps,)
    m_loc, b_loc = M // dp, B // dp
    users = np.concatenate([rng.integers(s * m_loc, (s + 1) * m_loc, lead + (b_loc,))
                            for s in range(dp)], axis=-1).astype(np.int32)
    rating = (rng.integers(1, 6, lead + (B,)) if grid else rng.uniform(1, 5, lead + (B,)))
    # a fifth of the rows inert (weight 0), the rest fractional.  Not 0.5:
    # adagrad's first step is about -lr * w * sign(g), which at w = 0.5
    # puts int8 payloads exactly on a rounding tie (63.5)
    weight = np.where(rng.random(lead + (B,)) < 0.2, 0.0, rng.uniform(0.3, 1.0, lead + (B,)))
    return {"user": users, "item": rng.integers(0, N, lead + (B,)).astype(np.int32),
            "rating": rating.astype(np.float32), "weight": weight.astype(np.float32)}

def to_params(full):
    return mf.MFParams(p=jnp.asarray(full["p"]), q=jnp.asarray(full["q"]), user_bias=None,
                       item_bias=None, global_mean=None, implicit=None)

def step_fn(mesh, opt_name, gc):
    return jax.jit(lambda p, s, b, t: mf.train_step_shard_map(
        p, s, b, t, t, lr=0.05, lam=0.02, opt_name=opt_name, grad_compression=gc,
        mesh=mesh.abstract_mesh))

def record(prefix, params, state, metrics):
    out[prefix + "/p"] = np.asarray(params.p)
    out[prefix + "/q"] = np.asarray(params.q)
    for side in ("p", "q"):
        for key, value in getattr(state, side).items():
            out[f"{prefix}/{side}_{key}"] = np.asarray(value)
    for key, value in metrics.items():
        out[f"{prefix}/m_{key}"] = np.float32(value)

# -- int8 helpers ---------------------------------------------------------
rng = np.random.default_rng(1)
ties = np.float32([127.0, 63.5, 0.5, -2.5, 1.5, -0.5, 3.5, -126.5])
x = rng.normal(0, 1, (5, 7)).astype(np.float32)
for name, arr in (("ties", ties), ("normal", x)):
    q8, scale = C.quantize_int8(jnp.asarray(arr))
    out[f"int8/{name}/x"] = arr
    out[f"int8/{name}/q"] = np.asarray(q8)
    out[f"int8/{name}/scale"] = np.float32(scale)
    out[f"int8/{name}/deq"] = np.asarray(C.dequantize_int8(q8, scale))
resid = rng.normal(0, 0.01, (5, 7)).astype(np.float32)
recon, new_resid = C.compress_with_feedback({"g": jnp.asarray(x)}, {"g": jnp.asarray(resid)})
out["int8/ef/resid"] = resid
out["int8/ef/recon"] = np.asarray(recon["g"])
out["int8/ef/new_resid"] = np.asarray(new_resid["g"])
out["int8/ef/zeros"] = np.asarray(C.init_error_feedback({"g": jnp.asarray(x)})["g"])
psum_x = rng.normal(0, 1, (4, 6, 5)).astype(np.float32)
psum_x[1] *= 0.0
mesh4 = mesh_of((4,), ("model",))
with use_mesh(mesh4):
    from repro.distributed import mesh_compat
    from jax.sharding import PartitionSpec as P
    got = jax.jit(mesh_compat.shard_map(lambda g: C.compressed_psum(g, "model"), mesh=mesh4,
                                        in_specs=P("model"), out_specs=P("model"),
                                        check_vma=False))(jnp.asarray(psum_x))
out["psum/x"] = psum_x
out["psum/out"] = np.asarray(got)[0]

# -- the owner router -------------------------------------------------------
for case, (num_users, n_dp_, size, pow2, weighted) in enumerate(
        [(16, 4, 37, False, False), (16, 4, 37, True, True), (12, 3, 5, True, False),
         (8, 1, 9, False, True), (20, 2, 1, True, True)]):
    users = rng.integers(0, num_users, size).astype(np.int32)
    items = rng.integers(0, 50, size).astype(np.int32)
    ratings = rng.uniform(1, 5, size).astype(np.float32)
    weight = rng.uniform(0, 1, size).astype(np.float32) if weighted else None
    routed = S.route_batch_to_owner_shards(users, items, ratings, num_users=num_users,
                                           n_dp=n_dp_, weight=weight, pad_to_pow2=pow2)
    out[f"route/{case}/in"] = np.stack([users, items]).astype(np.int64)
    out[f"route/{case}/ratings"] = ratings
    out[f"route/{case}/weight_in"] = np.zeros(0, np.float32) if weight is None else weight
    out[f"route/{case}/args"] = np.int64([num_users, n_dp_, pow2, weighted])
    for key, value in routed.items():
        out[f"route/{case}/{key}"] = value

# -- the sharded step on every mesh, opt, mode and threshold ---------------
for mi, (shape, names) in enumerate(MESHES):
    mesh = mesh_of(shape, names)
    dp = n_dp(shape, names)
    for grid in (False, True):
        if grid and mi:
            continue
        full = tables(grid, 10 + mi)
        batch = owned_batch(np.random.default_rng(20 + mi), dp, grid)
        out[f"step/{mi}/{int(grid)}/full_p"] = full["p"]
        out[f"step/{mi}/{int(grid)}/full_q"] = full["q"]
        for key, value in batch.items():
            out[f"step/{mi}/{int(grid)}/batch_{key}"] = value
        for opt_name in ("sgd", "adagrad"):
            opt = RowOptimizer(name=opt_name)
            for gc in ("none", "int8", "int8_ef"):
                fn = step_fn(mesh, opt_name, gc)
                for t in ((0.0,) if grid else (0.0, 0.05)):
                    with use_mesh(mesh):
                        params = to_params(full)
                        state = mf.init_opt_state(params, opt)
                        if gc == "int8_ef":
                            state = mf.init_error_feedback_state(params, state, mesh)
                        p2, s2, m2 = fn(params, state, {k: jnp.asarray(v) for k, v in batch.items()},
                                        jnp.float32(t))
                    record(f"step/{mi}/{int(grid)}/{opt_name}/{gc}/{t}", p2, s2, m2)

# -- the epoch as a fold of per-step calls (the epoch scan does not run) ---
mesh = mesh_of((2, 2), ("data", "model"))
full = tables(False, 30)
batches = owned_batch(np.random.default_rng(31), 2, False, steps=3)
out["epoch/full_p"], out["epoch/full_q"] = full["p"], full["q"]
for key, value in batches.items():
    out[f"epoch/batch_{key}"] = value
for gc in ("none", "int8", "int8_ef"):
    fn = step_fn(mesh, "adagrad", gc)
    with use_mesh(mesh):
        params = to_params(full)
        state = mf.init_opt_state(params, RowOptimizer(name="adagrad"))
        if gc == "int8_ef":
            state = mf.init_error_feedback_state(params, state, mesh)
        err_sum = work_sum = jnp.float32(0.0)
        for s in range(3):
            params, state, m = fn(params, state,
                                  {k: jnp.asarray(v[s]) for k, v in batches.items()},
                                  jnp.float32(0.05))
            err_sum = err_sum + m["abs_err"]
            work_sum = work_sum + m["work_fraction"]
    record(f"epoch/{gc}", params, state, {"abs_err": err_sum / jnp.float32(3),
                                          "work_fraction": work_sum / jnp.float32(3)})

# -- refusals ----------------------------------------------------------------
mesh = mesh_of((2, 2), ("data", "model"))
def refusal(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""
base = mf.init_params(jax.random.PRNGKey(0), 16, 8, 12)
odd = mf.init_params(jax.random.PRNGKey(0), 15, 8, 12)
bias = mf.init_params(jax.random.PRNGKey(0), 16, 8, 12, variant="bias")
with use_mesh(mesh):
    out["refuse/momentum"] = refusal(lambda: OnlineUpdater(base, optimizer="momentum", mesh=mesh))
    out["refuse/bias"] = refusal(lambda: OnlineUpdater(bias, optimizer="sgd", mesh=mesh))
    out["refuse/odd"] = refusal(lambda: OnlineUpdater(odd, optimizer="sgd", mesh=mesh))
out["refuse/opt"] = refusal(lambda: mf._check_owner_compute_opt("adam"))
out["refuse/gc"] = refusal(lambda: mf._resolve_grad_compression("fp8", False))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("multirank_ref") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE), path], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, proc.stdout + proc.stderr
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


@pytest.fixture(scope="module")
def pools():
    held = [RankPool(4)]
    yield held
    held[0].close()


@pytest.fixture
def pool(pools):
    """The module's 4 ranks, respawned if a failed test closed them."""
    if pools[0].closed:
        pools[0] = RankPool(4)
    return pools[0]


def _same(results):
    """Every rank returned the same arrays; rank 0's."""
    first = results[0]
    for other in results[1:]:
        for key in first:
            np.testing.assert_array_equal(np.asarray(other[key]), np.asarray(first[key]),
                                          err_msg=key)
    return first


# ---------------------------------------------------------------------------
# int8 helpers, the router, the mesh and the layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ties", "normal"])
def test_quantize_int8_bitwise(ref, name):
    x = torch.as_tensor(ref[f"int8/{name}/x"])
    q8, scale = compression.quantize_int8(x)
    assert q8.dtype == torch.int8
    np.testing.assert_array_equal(q8.numpy(), ref[f"int8/{name}/q"])
    assert np.float32(scale.item()).tobytes() == ref[f"int8/{name}/scale"].tobytes()
    np.testing.assert_array_equal(compression.dequantize_int8(q8, scale).numpy(),
                                  ref[f"int8/{name}/deq"])


def test_compress_with_feedback_bitwise(ref):
    grads = {"g": torch.as_tensor(ref["int8/normal/x"])}
    recon, resid = compression.compress_with_feedback(
        grads, {"g": torch.as_tensor(ref["int8/ef/resid"])})
    np.testing.assert_array_equal(recon["g"].numpy(), ref["int8/ef/recon"])
    np.testing.assert_array_equal(resid["g"].numpy(), ref["int8/ef/new_resid"])
    np.testing.assert_array_equal(compression.init_error_feedback(grads)["g"].numpy(),
                                  ref["int8/ef/zeros"])


def test_compressed_psum_bitwise(ref, pool):
    got = pool.run(cases.compressed_psum_case, ref["psum/x"])
    for out in got:
        np.testing.assert_array_equal(out, ref["psum/out"])


@pytest.mark.parametrize("case", range(5))
def test_route_batch_to_owner_shards_bitwise(ref, case):
    pre = f"route/{case}/"
    num_users, n_dp, pow2, weighted = (int(v) for v in ref[pre + "args"])
    users, items = ref[pre + "in"]
    got = sharding.route_batch_to_owner_shards(
        users, items, ref[pre + "ratings"], num_users=num_users, n_dp=n_dp,
        weight=ref[pre + "weight_in"] if weighted else None, pad_to_pow2=bool(pow2))
    assert set(got) == {"user", "item", "rating", "weight"}
    for key, value in got.items():
        assert value.dtype == ref[pre + key].dtype
        np.testing.assert_array_equal(value, ref[pre + key])


def test_route_batch_refusals_match_reference():
    for kwargs in ({"num_users": 10, "n_dp": 4}, {"num_users": 8, "n_dp": 2}):
        args = (np.int32([0, 9]), np.int32([0, 1]), np.float32([1, 2]))
        with pytest.raises(ValueError) as want:
            jsharding.route_batch_to_owner_shards(*args, **kwargs)
        with pytest.raises(ValueError) as got:
            sharding.route_batch_to_owner_shards(*args, **kwargs)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape,names", MESHES)
def test_named_axis_collectives(pool, shape, names):
    """Coordinates, psum, pmax and all-gather over each axis and over the
    data axes together follow shard_map's row-major rank order."""
    got = pool.run(cases.collectives_case, shape, names)
    coords = np.arange(4).reshape(shape)
    for rank, per_axes in enumerate(got):
        where = np.argwhere(coords == rank)[0]
        for axes, (index, total, peak, gathered) in per_axes.items():
            dims = [names.index(a) for a in axes]
            sl = tuple(slice(None) if d in dims else int(where[d]) for d in range(len(shape)))
            group = coords[sl]
            # keep the named dims in mesh order, flattened row-major
            members = group.reshape(-1).tolist()
            assert gathered == [float(r) for r in members], (axes, rank)
            assert total == float(sum(members)) and peak == float(max(members))
            assert members[index] == rank


def test_block_layouts_match_mf_spec_fn(pool):
    """shard_tree cuts each rank's block as mf_spec_fn lays it out (users
    over the data axes, items over model, the residuals as the step's
    operands), and assemble_tree inverts it bitwise."""
    rng = np.random.default_rng(5)
    tree = {"params": {"p": rng.normal(size=(8, 3)).astype(np.float32),
                       "q": rng.normal(size=(4, 3)).astype(np.float32)},
            "opt_state": {"p": {"acc": rng.normal(size=(8, 3)).astype(np.float32),
                                "ef_psum": rng.normal(size=(8, 6)).astype(np.float32)},
                          "q": {"ef_gather": rng.normal(size=(4, 6)).astype(np.float32)}},
            "t_p": np.float32(0.5)}
    got = pool.run(cases.blocks_case, (2, 2), ("data", "model"), tree)
    for rank, (blocks, whole) in enumerate(got):
        d, m = divmod(rank, 2)
        p = tree["params"]
        np.testing.assert_array_equal(blocks["params"]["p"], p["p"][4 * d:4 * d + 4])
        np.testing.assert_array_equal(blocks["params"]["q"], p["q"][2 * m:2 * m + 2])
        np.testing.assert_array_equal(blocks["opt_state"]["p"]["acc"],
                                      tree["opt_state"]["p"]["acc"][4 * d:4 * d + 4])
        np.testing.assert_array_equal(blocks["opt_state"]["p"]["ef_psum"],
                                      tree["opt_state"]["p"]["ef_psum"][4 * d:4 * d + 4,
                                                                        3 * m:3 * m + 3])
        np.testing.assert_array_equal(blocks["opt_state"]["q"]["ef_gather"],
                                      tree["opt_state"]["q"]["ef_gather"][2 * m:2 * m + 2,
                                                                          3 * d:3 * d + 3])
        assert blocks["t_p"] == tree["t_p"]
        for (path, leaf) in checkpoint.flatten_with_paths(tree):
            np.testing.assert_array_equal(dict(checkpoint.flatten_with_paths(whole))[path], leaf)


# ---------------------------------------------------------------------------
# the owner-compute step and its epoch
# ---------------------------------------------------------------------------


def _step_inputs(ref, mi, grid):
    pre = f"step/{mi}/{int(grid)}/"
    full = {"p": ref[pre + "full_p"], "q": ref[pre + "full_q"]}
    batch = {key: ref[pre + "batch_" + key] for key in ("user", "item", "rating", "weight")}
    return full, batch


LR = 0.05


def _hold(got, ref, prefix, opt_name, gc, exact=False):
    """The port's result against the reference's at the tolerances of the
    module docstring."""
    keys = [key[len(prefix) + 1:] for key in ref if key.startswith(prefix + "/")]
    assert keys and set(keys) == set(k for k in got if k != "history"), (keys, list(got))
    for key in keys:
        have, want = np.asarray(got[key]), ref[prefix + "/" + key]
        if exact:
            np.testing.assert_array_equal(have, want, err_msg=key)
        elif gc == "none":
            np.testing.assert_allclose(have, want, atol=2e-8, rtol=1e-6, err_msg=key)
        elif opt_name == "sgd" or key.startswith("m_"):
            np.testing.assert_allclose(have, want, atol=1e-6, rtol=1e-6, err_msg=key)
        else:
            diff = np.abs(have.astype(np.float64) - want)
            off = diff > 1e-6 + 1e-6 * np.abs(want)
            assert off.sum() <= max(2, want.size // 64), (key, off.sum(), diff.max())
            assert diff.max() <= LR, (key, diff.max())


@pytest.mark.parametrize("mi", range(len(MESHES)))
@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
@pytest.mark.parametrize("gc", MODES)
def test_sharded_step_matches_reference(ref, pool, mi, opt_name, gc):
    shape, names = MESHES[mi]
    full, batch = _step_inputs(ref, mi, False)
    for t in (0.0, 0.05):
        got = _same(pool.run(cases.step_case, shape, names, full, batch, t, opt_name, gc))
        _hold(got, ref, f"step/{mi}/0/{opt_name}/{gc}/{t}", opt_name, gc)


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
@pytest.mark.parametrize("gc", MODES)
def test_sharded_step_on_grid(ref, pool, opt_name, gc):
    """1/8-grid factors: sgd bitwise in modes none and int8.  Adagrad goes
    through XLA's square root, and int8_ef's residual ``g - q8 * scale``
    through a fused multiply-add in XLA's code, so those are held as on
    random factors."""
    full, batch = _step_inputs(ref, 0, True)
    got = _same(pool.run(cases.step_case, (2, 2), ("data", "model"), full, batch, 0.0,
                         opt_name, gc))
    _hold(got, ref, f"step/0/1/{opt_name}/{gc}/0.0", opt_name, gc,
          exact=opt_name == "sgd" and gc != "int8_ef")


@pytest.mark.parametrize("mi", range(len(MESHES)))
@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
def test_sharded_step_matches_single_device_step(ref, pool, mi, opt_name):
    """Mode ``none`` against the port's own single-device ``train_step``:
    the same float32 operations in the same order, so the tables are
    bitwise; the metrics are summed over the data shards in another order
    (1e-6 relative)."""
    shape, names = MESHES[mi]
    full, batch = _step_inputs(ref, mi, False)
    opt = RowOptimizer(name=opt_name)
    for t in (0.0, 0.05):
        got = _same(pool.run(cases.step_case, shape, names, full, batch, t, opt_name, "none"))
        params = mf.params_from_numpy(full, device="cpu")
        state = mf.init_opt_state(params, opt)
        tb = {key: torch.as_tensor(value) for key, value in batch.items()}
        tb["user"], tb["item"] = tb["user"].long(), tb["item"].long()
        params, state, metrics = mf.train_step(params, state, tb, torch.tensor(t),
                                               torch.tensor(t), 0.05, torch.ones(K),
                                               opt=opt, lam=0.02)
        np.testing.assert_array_equal(got["p"], params.p.numpy())
        np.testing.assert_array_equal(got["q"], params.q.numpy())
        if opt_name == "adagrad":
            np.testing.assert_array_equal(got["p_acc"], state.p["acc"].numpy())
            np.testing.assert_array_equal(got["q_acc"], state.q["acc"].numpy())
        for key, value in metrics.items():
            assert got["m_" + key] == pytest.approx(value.item(), rel=1e-6), key


@pytest.mark.parametrize("gc", MODES)
def test_epoch_matches_fold_of_reference_steps(ref, pool, gc):
    full = {"p": ref["epoch/full_p"], "q": ref["epoch/full_q"]}
    batches = {key: ref["epoch/batch_" + key] for key in ("user", "item", "rating", "weight")}
    got = _same(pool.run(cases.epoch_case, (2, 2), ("data", "model"), full, batches, 0.05,
                         "adagrad", gc))
    _hold(got, ref, f"epoch/{gc}", "adagrad", gc)


def test_int8_error_feedback_tracks_fp32_on_the_port(pool):
    """The property of the reference's
    ``test_int8_error_feedback_tracks_fp32`` at its sizes, on the port:
    error feedback keeps the final-epoch training error within 1% of the
    fp32 exchange and no worse than plain int8 (plus 5e-4 of noise)."""
    m, n, k, b, steps, epochs = 16, 8, 12, 16, 40, 3
    rng = np.random.default_rng(0)
    full = {"p": rng.normal(0, 0.1, (m, k)).astype(np.float32),
            "q": rng.normal(0, 0.1, (n, k)).astype(np.float32)}
    users = np.stack([np.concatenate([rng.integers(s * 8, (s + 1) * 8, b // 2) for s in range(2)])
                      for _ in range(steps)]).astype(np.int32)
    batches = {"user": users, "item": rng.integers(0, n, (steps, b)).astype(np.int32),
               "rating": rng.uniform(1, 5, (steps, b)).astype(np.float32)}
    final = {}
    for gc in MODES:
        got = _same(pool.run(cases.epoch_case, (2, 2), ("data", "model"), full, batches, 0.0,
                             "adagrad", gc, epochs=epochs))
        final[gc] = float(got["history"][-1])
    gap_int8 = abs(final["int8"] - final["none"]) / final["none"]
    gap_ef = abs(final["int8_ef"] - final["none"]) / final["none"]
    assert gap_ef < 0.01, (gap_ef, final)
    assert gap_ef <= gap_int8 + 5e-4, (gap_ef, gap_int8)


def test_error_feedback_state_layout(pool):
    """init_error_feedback_state gives each rank (m_loc, k) and (n_loc, k)
    zero blocks: the reference's (m, n_model k) and (n, n_dp k) tables."""
    rng = np.random.default_rng(2)
    full = {"p": rng.normal(0, 0.1, (M, K)).astype(np.float32),
            "q": rng.normal(0, 0.1, (N, K)).astype(np.float32)}
    batch = {"user": np.int32([0] * 8 + [8] * 8), "item": np.zeros(B, np.int32),
             "rating": np.zeros(B, np.float32), "weight": np.zeros(B, np.float32)}
    got = _same(pool.run(cases.step_case, (2, 2), ("data", "model"), full, batch, 0.0, "sgd",
                         "int8_ef"))
    assert got["p_ef_psum"].shape == (M, 2 * K) and got["q_ef_gather"].shape == (N, 2 * K)
    assert not got["p_ef_psum"].any() and not got["q_ef_gather"].any()
    np.testing.assert_array_equal(got["p"], full["p"])   # weight 0: inert


@pytest.mark.parametrize("rows,span", [(0, 5), (1, 5), (64, 5), (500, 37), (300, 1000)])
def test_add_rows_in_passes_equals_sequential_index_add(rows, span):
    """The card's update of replicated blocks (passes of distinct indices)
    adds each index's rows in batch order: bitwise the sequential
    ``index_add_`` of the CPU."""
    rng = np.random.default_rng(rows)
    table = torch.as_tensor(rng.normal(size=(span, 7)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, span, rows))
    upd = torch.as_tensor(rng.normal(size=(rows, 7)).astype(np.float32) * 1e3)
    want, got = table.clone(), table.clone()
    scatter.add_rows(want, idx, upd)
    scatter.add_rows_in_passes(got, idx, upd)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_step_refusals_match_reference(ref):
    with pytest.raises(ValueError) as exc:
        mf._check_owner_compute_opt("adam")
    assert str(exc.value) == str(ref["refuse/opt"])
    with pytest.raises(ValueError) as exc:
        mf._resolve_grad_compression("fp8", False)
    assert str(exc.value) == str(ref["refuse/gc"])
    assert mf._resolve_grad_compression("none", True) == "int8"
    with pytest.raises(ValueError, match="needs a mesh"):
        mf.train_step_shard_map(None, None, {}, 0.0, 0.0, lr=0.1, lam=0.0)


@pytest.mark.parametrize("kind,kwargs,shape", [
    ("momentum", {"optimizer": "momentum"}, (M, K)),
    ("bias", {"optimizer": "sgd"}, (M, K)),
    ("odd", {"optimizer": "sgd"}, (M - 1, K)),
])
def test_updater_refusals_match_reference(ref, pool, kind, kwargs, shape):
    rng = np.random.default_rng(0)
    full = {"p": rng.normal(size=shape).astype(np.float32),
            "q": rng.normal(size=(N, K)).astype(np.float32)}
    if kind == "bias":
        full.update(user_bias=np.zeros((M, 1), np.float32), item_bias=np.zeros((N, 1), np.float32),
                    global_mean=np.float32(0.0))
    got = pool.run(cases.refusal_case, (2, 2), ("data", "model"), full, kwargs)
    assert got == [str(ref[f"refuse/{kind}"])] * 4


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------


def test_elastic_load_across_meshes(ref, pool, tmp_path):
    """A checkpoint written under (2, 2) (assembled on rank 0) restores onto
    (1, 4) and onto one device bitwise; the reference restores it too."""
    full, batch = _step_inputs(ref, 0, False)
    directory = str(tmp_path / "ck")
    written = _same([dict(checkpoint.flatten_with_paths(tree))
                     for tree in pool.run(cases.elastic_case, directory, (2, 2),
                                          ("data", "model"), full, batch, True)])
    for blocks, whole in pool.run(cases.elastic_case, directory, (1, 4), ("data", "model"),
                                  full, batch, False):
        flat = dict(checkpoint.flatten_with_paths(whole))
        assert set(flat) == set(written)
        for key, value in written.items():
            np.testing.assert_array_equal(flat[key], value, err_msg=key)
    # (1, 4): every rank holds all users and a quarter of the items
    assert blocks["params"].q.shape == (N // 4, K) and blocks["params"].p.shape == (M, K)
    # onto one device: the identity shard_fn
    like = {"params": mf.params_from_numpy(full, device="cpu"),
            "opt_state": mf.init_opt_state(mf.params_from_numpy(full, device="cpu"),
                                           RowOptimizer(name="adagrad"))}
    one, _ = checkpoint.elastic_load(directory, like, lambda tree: tree)
    for key, value in checkpoint.flatten_with_paths(one):
        np.testing.assert_array_equal(value, written[key], err_msg=key)
    jlike = {key: np.zeros_like(value) for key, value in written.items()}
    jtree, _ = jcheckpoint.elastic_load(directory, jlike, lambda tree: tree)
    for key, value in jtree.items():
        np.testing.assert_array_equal(np.asarray(value), written[key], err_msg=key)


MOE_MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model"))]


@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["dropless", "drops"])
@pytest.mark.parametrize("shape,names", MOE_MESHES)
def test_moe_shard_map_matches_reference(pool, shape, names, cf):
    """Experts over ``"model"``, 32 tokens over ``"data"``: every rank routes
    its data shard over all 8 experts and runs its slab; the psum over
    ``"model"`` gives the reference's ``moe_ffn_xla`` on that shard (2 shared
    experts included), the aux loss the shards' mean; under the loss
    ``sum(out * cot) + aux``, the slab's gradients (summed over the data
    axes) the reference's slice, the router's and the shared experts' (so
    summed) the reference's whole, and each rank's tokens' the reference's
    on its shard, the same on every rank of ``"model"``."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe

    rng = np.random.default_rng(31)
    t, d, e, f = 32, 16, 8, 12
    cfg = jmoe.MoEConfig(num_experts=e, top_k=2, d_ff=f, num_shared=2, capacity_factor=cf)
    p = {"router": rng.normal(0, 0.3, (d, e)).astype(np.float32),
         "wg": rng.normal(0, 0.2, (e, d, f)).astype(np.float32),
         "wi": rng.normal(0, 0.2, (e, d, f)).astype(np.float32),
         "wo": rng.normal(0, 0.2, (e, f, d)).astype(np.float32),
         "shared": {"wg": rng.normal(0, 0.2, (d, 2 * f)).astype(np.float32),
                    "wi": rng.normal(0, 0.2, (d, 2 * f)).astype(np.float32),
                    "wo": rng.normal(0, 0.2, (2 * f, d)).astype(np.float32)}}
    x = rng.normal(0, 1, (t, d)).astype(np.float32)
    cot = rng.normal(0, 1, (t, d)).astype(np.float32)
    n_dp = shape[0]
    rows = t // n_dp

    def ref_loss(params, xb, cb):
        out, aux = jmoe.moe_ffn_xla(xb, params, cfg)
        return jnp.sum(out * cb) + aux / n_dp, (out, aux)

    want_out, want_aux, want_x, want_grads = [], [], [], None
    for i in range(n_dp):
        blk = slice(i * rows, (i + 1) * rows)
        (_, (out, aux)), (g, gx) = jax.value_and_grad(ref_loss, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x[blk]), jnp.asarray(cot[blk]))
        want_out.append(np.asarray(out))
        want_aux.append(float(aux))
        want_x.append(np.asarray(gx))
        want_grads = g if want_grads is None else jax.tree_util.tree_map(
            lambda a, b: a + b, want_grads, g)
    results = pool.run(cases.moe_shard_map_case, shape, names, p, x, cot, tuple(cfg))
    e_loc = e // shape[1]
    for res in results:
        np.testing.assert_allclose(res["out"], want_out[res["data"]], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["aux"], np.mean(want_aux), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(res["x"], want_x[res["data"]], rtol=1e-5, atol=1e-5,
                                   err_msg="x")
        slab = slice(res["model"] * e_loc, (res["model"] + 1) * e_loc)
        assert set(res["grads"]) == {"wg", "wi", "wo", "router", "shared/wg", "shared/wi",
                                     "shared/wo"}
        for key, value in res["grads"].items():
            path = key.split("/")
            want = np.asarray(want_grads[path[0]] if len(path) == 1
                              else want_grads[path[0]][path[1]])
            np.testing.assert_allclose(value, want[slab] if key in ("wg", "wi", "wo") else want,
                                       rtol=1e-5, atol=1e-5, err_msg=key)
    if cf == 1.0:  # some shard drops tokens: the shard's capacity is what the test holds
        jcount = [np.bincount(np.asarray(jax.lax.top_k(jax.nn.softmax(
            x[i * rows:(i + 1) * rows] @ p["router"], -1), 2)[1]).reshape(-1), minlength=e).max()
            for i in range(n_dp)]
        assert max(jcount) > jmoe._capacity(rows, cfg)
