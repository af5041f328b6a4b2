"""The port's serving and online updates across ranks held against the JAX
reference on the CPU: ``ServingEngine.topk_sharded`` (and ``start(mesh=)``),
``evaluate_engine(mesh=)`` and ``OnlineUpdater(mesh=)``; and the chip
smoke's multirank phase rehearsed at a tiny size.

The port runs SPMD in 4 spawned gloo ranks (one pool per module, a
``file://`` store); the reference runs once per module in a subprocess
with 8 forced host devices.  Its oracles are the single-device paths, as
in its own sharded tests (``tests/test_serving.py:392``,
``tests/test_eval_ranking.py:390``, ``tests/test_online_updater.py:375``),
which need 4 devices and skip in a default run.

Tolerances: ``topk_sharded`` ids identical to the reference's
``engine.topk`` and scores within 1e-5 (the reference's bar), and
bitwise the port's own local ``topk``; ``evaluate_engine(mesh=)`` reports
equal to the port's local evaluation and to the reference's within 1e-6
(``tests/test_torch_eval.py``); the sharded updater's tables within 2e-7
of the reference's single-device updater (the reference's bar).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import test_torch_multirank_cases as cases
from repro.data import ratings as jratings
from repro_torch.testing.ranks import RankPool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPK_MESHES = [((4,), ("model",)), ((2, 2), ("data", "model")),
               ((4, 1), ("data", "model")), ((1, 4), ("data", "model"))]

REFERENCE = r'''
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import mf
from repro.data import synthetic_ratings
from repro.distributed.mesh_compat import use_mesh
from repro.eval import ranking as R
from repro.online import EventBatch, OnlineUpdater
from repro.serving import ServingEngine

out = {}
def save_params(prefix, params):
    for key, value in params._asdict().items():
        if value is not None:
            out[f"{prefix}/{key}"] = np.asarray(value)

# topk_sharded's oracle: the setup of tests/test_serving.py:392
params = mf.init_params(jax.random.PRNGKey(0), 48, 2100, 24, variant="bias", global_mean=3.0)
engine = ServingEngine(params, 0.04, 0.04, use_kernel=False, block_n=128)
want_s, want_i = engine.topk(np.arange(17, dtype=np.int32), 9)
save_params("topk", params)
out["topk/scores"], out["topk/ids"] = want_s, want_i

# evaluate_engine's oracles: the setup of tests/test_eval_ranking.py:390
params = mf.init_params(jax.random.PRNGKey(0), 33, 640, 16, variant="funk", global_mean=3.0)
ds = synthetic_ratings(num_users=33, num_items=640, num_ratings=1500, seed=0)
save_params("eval", params)
def report(prefix, rep):
    out[prefix] = np.float64([rep.hr, rep.ndcg, rep.recall, rep.users, rep.topk])
report("eval/oracle", R.evaluate_oracle(params, ds, topk=8))
pruned = ServingEngine(params, 0.05, 0.05, use_kernel=False, max_batch=16)
report("eval/pruned", R.evaluate_engine(pruned, ds, topk=8))

# OnlineUpdater's oracle: the setup of tests/test_online_updater.py:375
m, n, k = 16, 8, 12
params = mf.init_params(jax.random.PRNGKey(0), m, n, k)
save_params("upd", params)
rng = np.random.default_rng(3)
batches = [dict(user=rng.integers(0, m, 32).astype(np.int32),
                item=rng.integers(0, n, 32).astype(np.int32),
                rating=rng.uniform(1, 5, 32).astype(np.float32),
                weight=rng.uniform(0.25, 1.0, 32).astype(np.float32)) for _ in range(3)]
batches.append(dict(user=np.int32([m + 1]), item=np.int32([n + 2]),
                    rating=np.float32([4.5]), weight=np.float32([0.5])))
for b, fields in enumerate(batches):
    for key, value in fields.items():
        out[f"upd/batch{b}/{key}"] = value
single = OnlineUpdater(params, None, 0.05, 0.05, optimizer="adagrad", lr=0.03, batch_size=64,
                       seed=9)
for b in range(3):
    single.apply(EventBatch(**batches[b]))
    out[f"upd/single{b}/p"] = np.asarray(single.params.p)
    out[f"upd/single{b}/q"] = np.asarray(single.params.q)
    out[f"upd/single{b}/q_acc"] = np.asarray(single.opt_state.q["acc"])
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("multirank_serving_ref") / "ref.npz")
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


def _params(ref, prefix):
    fields = ("p", "q", "user_bias", "item_bias", "global_mean", "implicit")
    return {key: ref.get(f"{prefix}/{key}") for key in fields}


# ---------------------------------------------------------------------------
# topk_sharded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,names", TOPK_MESHES)
def test_topk_sharded_matches_reference_topk(ref, pool, shape, names):
    """Every rank returns the whole answer: the reference's ids, its scores
    within 1e-5, and the port's local ``topk`` bitwise; the one-user
    request is padded to the user-slab multiple."""
    users = np.arange(17, dtype=np.int32)
    requests = [users, users[3:4]]
    got = pool.run(cases.topk_case, shape, names, _params(ref, "topk"), 0.04, requests, 9)
    for sharded, local in got:
        for (s, i), (ls, li), want in zip(sharded, local, (slice(None), slice(3, 4))):
            np.testing.assert_array_equal(i, ref["topk/ids"][want])
            np.testing.assert_allclose(s, ref["topk/scores"][want], rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(i, li)
            np.testing.assert_array_equal(s, ls)


def test_topk_sharded_chunks_and_evicted_users(ref, pool):
    """Requests larger than ``max_batch`` are chunked, and evicted users get
    the fallback ranking, as in ``topk``."""
    full = _params(ref, "topk")
    remap = np.arange(48, dtype=np.int32)
    remap[[2, 7, 30]] = -1
    users = np.random.default_rng(4).integers(0, 48, 21).astype(np.int32)
    users[:3] = [2, 7, 30]
    got = pool.run(cases.topk_case, (2, 2), ("data", "model"), full, 0.04, [users], 5,
                   max_batch=8, remap=remap)
    for sharded, local in got:
        np.testing.assert_array_equal(sharded[0][1], local[0][1])
        np.testing.assert_array_equal(sharded[0][0], local[0][0])
        assert (sharded[0][1][:3] == sharded[0][1][0]).all()   # the one fallback row


def test_start_with_mesh_serves_through_topk_sharded(ref, pool):
    """``start(mesh=)``: the first rank's queue broadcasts each batch and
    every rank scores it; the answers equal the reference's ``topk``."""
    users = np.arange(17, dtype=np.int32)
    got = pool.run(cases.queue_case, (2, 2), ("data", "model"), _params(ref, "topk"), 0.04,
                   users, 9)
    assert got[1:] == [None, None, None]
    for u, (s, i) in zip(users, got[0]):
        np.testing.assert_array_equal(i, ref["topk/ids"][u])
        np.testing.assert_allclose(s, ref["topk/scores"][u], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# evaluate_engine(mesh=)
# ---------------------------------------------------------------------------


def _ds_arrays():
    ds = jratings.synthetic_ratings(num_users=33, num_items=640, num_ratings=1500, seed=0)
    return ds.user, ds.item, ds.rating, ds.num_users, ds.num_items


@pytest.mark.parametrize("shape,names", [((4,), ("model",)), ((2, 2), ("data", "model"))])
@pytest.mark.parametrize("t,oracle", [(0.0, "oracle"), (0.05, "pruned")])
def test_evaluate_engine_sharded(ref, pool, shape, names, t, oracle):
    """Through ``topk_sharded``: at t = 0 the dense oracle's report, at
    0.05 the local pruned engine's."""
    got = pool.run(cases.eval_case, shape, names, _params(ref, "eval"), _ds_arrays(), t, 8)
    want = ref[f"eval/{oracle}"]
    for sharded, local in got:
        assert sharded == local
        assert (sharded.users, sharded.topk) == (int(want[3]), int(want[4]))
        for value, expect in zip((sharded.hr, sharded.ndcg, sharded.recall), want[:3]):
            assert abs(value - expect) <= 1e-6


# ---------------------------------------------------------------------------
# OnlineUpdater(mesh=)
# ---------------------------------------------------------------------------


def _batches(ref):
    return [{key: ref[f"upd/batch{b}/{key}"] for key in ("user", "item", "rating", "weight")}
            for b in range(4)]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_mesh_updater_matches_single_device(ref, pool, shape):
    """Owner routing, fractional weights and growth to mesh multiples: the
    routed sharded updates within 2e-7 of the reference's single-device
    updater; the cold-start batch grows the tables to the mesh multiples
    and leaves the pre-growth rows as they were."""
    m, n = 16, 8
    got = pool.run(cases.updater_case, shape, ("data", "model"), _params(ref, "upd"),
                   _batches(ref), optimizer="adagrad", lr=0.03, batch_size=64, seed=9)
    for per_rank in got:
        for b in range(3):
            for key in ("p", "q", "q_acc"):
                np.testing.assert_allclose(per_rank[b][key], ref[f"upd/single{b}/{key}"],
                                           atol=2e-7, rtol=0, err_msg=f"batch {b} {key}")
        grown = per_rank[3]
        assert grown["num_users"] % shape[0] == 0 and grown["num_users"] >= m + 2
        assert grown["num_items"] % shape[1] == 0 and grown["num_items"] >= n + 3
        assert grown["p"].shape == (grown["num_users"], 12)
        np.testing.assert_allclose(grown["p"][:m], per_rank[2]["p"][:m], atol=2e-7, rtol=0)
        np.testing.assert_allclose(grown["q"][:n], per_rank[2]["q"][:n], atol=2e-7, rtol=0)
        assert np.isfinite(grown["p"]).all()
        assert np.isfinite(float(grown["p"][m + 1] @ grown["q"][n + 2]))
        # the fresh rows are the reference's numpy draws (q first, then p,
        # 0.1 N(0, 1) from the seed); those the event did not touch are bitwise
        add_n, add_m = grown["num_items"] - n, grown["num_users"] - m
        draws = np.random.default_rng(9)
        fresh_q = (0.1 * draws.standard_normal((add_n, 12))).astype(np.float32)
        fresh_p = (0.1 * draws.standard_normal((add_m, 12))).astype(np.float32)
        for row in range(add_n):
            if n + row != n + 2:
                np.testing.assert_array_equal(grown["q"][n + row], fresh_q[row])
        for row in range(add_m):
            if m + row != m + 1:
                np.testing.assert_array_equal(grown["p"][m + row], fresh_p[row])
        np.testing.assert_array_equal(per_rank[4]["snapshot_p"], grown["p"])
    for per_rank in got[1:]:   # every rank drew the same fresh rows
        np.testing.assert_array_equal(per_rank[3]["p"], got[0][3]["p"])
        np.testing.assert_array_equal(per_rank[3]["q"], got[0][3]["q"])


@pytest.mark.parametrize("gc", ["int8", "int8_ef"])
def test_mesh_updater_with_compressed_exchange(ref, pool, gc):
    """``grad_compression`` reaches the sharded step: int8 modes stay within
    one int8 step (adagrad's bound, lr) of the exact exchange."""
    got = pool.run(cases.updater_case, (2, 2), ("data", "model"), _params(ref, "upd"),
                   _batches(ref)[:3], grad_compression=gc, optimizer="adagrad", lr=0.03,
                   batch_size=64, seed=9)
    for b in range(3):
        diff = np.abs(got[0][b]["p"] - ref[f"upd/single{b}/p"])
        assert diff.max() <= 3 * 0.03 and np.isfinite(got[0][b]["p"]).all()


# ---------------------------------------------------------------------------
# the chip smoke's multirank phase, rehearsed at a tiny size
# ---------------------------------------------------------------------------


def test_chip_smoke_multirank_phase_rehearses_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s multirank-dpmf phase end to end on 4 CPU ranks at
    a tiny size: every check holds except the card-only one (the CPU path
    launches no ``pruned_topk`` kernel)."""
    import torch

    sys.path.insert(0, REPO)   # the spawned ranks import chip_smoke too
    try:
        import chip_smoke

        chip_smoke.failures.clear()
        out = chip_smoke.multirank_phase(torch.device("cpu"), str(tmp_path), dict(
            small=(256, 128), users=512, items=1024, batch=256, topk_users=16, slab_rows=256,
            online=(256, 512), online_batch=64))
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.failures == [
        "multirank-dpmf: pruned_topk launched on every rank ([0, 0, 0, 0])"]
    assert chip_smoke.PATH_LAUNCHES["multirank"] == {"pruned_topk": 0}
    for mode in ("none", "int8", "int8_ef"):
        sent = out["train"][mode]["collective_bytes"]
        g_p = sent["g_p psum"] if mode == "none" else sent.get("int8 payload", sent.get("g_p int8"))
        assert g_p == 256 // 2 * 128 * (4 if mode == "none" else 1)
    assert out["online"]["num_users"] % 2 == 0 and out["online"]["finite"]
