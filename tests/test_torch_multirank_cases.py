"""Rank-side halves of the multi-rank parity tests
(``tests/test_torch_multirank*.py``): module-level functions that a
:class:`repro_torch.testing.ranks.RankPool` runs on every rank, each
``fn(ctx, ...)`` building its mesh with ``ctx.mesh(shape, names)``, taking
full numpy tables, keeping this rank's blocks, and returning numpy results
(assembled tables, so every rank returns the same thing).  Torch only: the
spawned ranks never import jax."""
import numpy as np
import torch

from repro_torch.core import mf
from repro_torch.distributed import compression, sharding, spmd
from repro_torch.optim.optimizers import RowOptimizer


def _np_tree(tree):
    return sharding._map_tree(tree, lambda parts, leaf: leaf.cpu().numpy()
                              if isinstance(leaf, torch.Tensor) else leaf)


def _blocks(ctx, mesh, full, opt_name, gc):
    params = mf.params_from_numpy(full, device=ctx.device)
    state = mf.init_opt_state(params, RowOptimizer(name=opt_name))
    tree = sharding.shard_tree({"params": params, "opt_state": state}, mesh)
    params, state = tree["params"], tree["opt_state"]
    if gc == "int8_ef":
        state = mf.init_error_feedback_state(params, state, mesh)
    return params, state


def _result(mesh, params, state, metrics):
    full = sharding.assemble_tree({"params": params, "opt_state": state}, mesh)
    out = {"p": full["params"].p, "q": full["params"].q}
    for side in ("p", "q"):
        for key, value in full["opt_state"]._asdict()[side].items():
            out[f"{side}_{key}"] = value
    out = {key: value.cpu().numpy() for key, value in out.items()}
    out.update({f"m_{key}": np.float32(value.item()) for key, value in metrics.items()})
    return out


def step_case(ctx, shape, names, full, batch, t, opt_name, gc):
    """One sharded step from full tables; the assembled result."""
    mesh = ctx.mesh(shape, names)
    params, state = _blocks(ctx, mesh, full, opt_name, gc)
    batch = {key: torch.as_tensor(value) for key, value in batch.items()}
    params, state, metrics = mf.train_step_shard_map(
        params, state, batch, t, t, lr=0.05, lam=0.02, opt_name=opt_name,
        grad_compression=gc, mesh=mesh)
    return _result(mesh, params, state, metrics)


def epoch_case(ctx, shape, names, full, batches, t, opt_name, gc, epochs=1, lr=0.05):
    """``epochs`` sharded epochs over packed ``(steps, B)`` batches; the
    assembled result and each epoch's metrics."""
    mesh = ctx.mesh(shape, names)
    params, state = _blocks(ctx, mesh, full, opt_name, gc)
    batches = {key: torch.as_tensor(value) for key, value in batches.items()}
    history = []
    for _ in range(epochs):
        params, state, metrics = mf.train_epoch_scan_shard_map(
            params, state, batches, t, t, lr=lr, lam=0.02, opt_name=opt_name,
            grad_compression=gc, mesh=mesh)
        history.append(float(metrics["abs_err"]))
    out = _result(mesh, params, state, metrics)
    out["history"] = np.asarray(history)
    return out


def compressed_psum_case(ctx, x):
    """Rank r contributes ``x[r]`` to a compressed psum over a 1-D mesh."""
    mesh = ctx.mesh((ctx.world_size,), ("model",))
    got = compression.compressed_psum({"g": torch.as_tensor(x[ctx.rank])},
                                      mesh.get_group("model"))
    return got["g"].numpy()


def collectives_case(ctx, shape, names):
    """Each rank's coordinate, psum, pmax and all-gather of its rank id over
    every axis and over the data axes together."""
    mesh = ctx.mesh(shape, names)
    x = torch.tensor([float(ctx.rank)])
    out = {}
    for axes in [(name,) for name in names] + [sharding.data_axes(mesh)]:
        out[axes] = (spmd.axis_index(mesh, axes), spmd.psum(x, mesh, axes).item(),
                     spmd.pmax(x, mesh, axes).item(), spmd.all_gather(x, mesh, axes).tolist())
    return out


def blocks_case(ctx, shape, names, tree):
    """This rank's blocks of a numpy tree and the tree assembled back."""
    mesh = ctx.mesh(shape, names)
    blocks = sharding.shard_tree(tree, mesh)
    return _np_tree(blocks), _np_tree(sharding.assemble_tree(blocks, mesh))


def topk_case(ctx, shape, names, full, t, requests, topk, max_batch=256, remap=None):
    """``topk_sharded`` for each request (a list of user-id arrays) on an
    engine over the full tables; also the local ``topk``."""
    from repro_torch.serving import ServingEngine

    mesh = ctx.mesh(shape, names)
    engine = ServingEngine(mf.params_from_numpy(full, device=ctx.device), t, t,
                           device=ctx.device, max_batch=max_batch, user_remap=remap)
    sharded = [engine.topk_sharded(users, topk, mesh=mesh) for users in requests]
    local = [engine.topk(users, topk) for users in requests]
    return sharded, local


def queue_case(ctx, shape, names, full, t, users, topk):
    """``start(mesh=)``: the first rank submits every user through the
    queue, the others follow; rank 0 returns the answers."""
    from repro_torch.serving import ServingEngine

    mesh = ctx.mesh(shape, names)
    engine = ServingEngine(mf.params_from_numpy(full, device=ctx.device), t, t,
                           device=ctx.device)
    queue = engine.start(mesh=mesh, linger_ms=2.0)
    rows = None
    if queue is not None:
        futures = [engine.submit(int(u), topk) for u in users]
        rows = [f.result(60) for f in futures]
    engine.stop()
    return rows


def eval_case(ctx, shape, names, full, ds_arrays, t, topk, max_batch=16):
    """``evaluate_engine`` through ``topk_sharded`` and through ``topk``."""
    from repro_torch.data import ratings
    from repro_torch.eval import ranking
    from repro_torch.serving import ServingEngine

    mesh = ctx.mesh(shape, names)
    ds = ratings.RatingsDataset(*ds_arrays)
    engine = ServingEngine(mf.params_from_numpy(full, device=ctx.device), t, t,
                           device=ctx.device, max_batch=max_batch)
    return (ranking.evaluate_engine(engine, ds, topk=topk, mesh=mesh),
            ranking.evaluate_engine(engine, ds, topk=topk))


def updater_case(ctx, shape, names, full, batches, grad_compression="none", **kwargs):
    """An ``OnlineUpdater(mesh=)`` fed ``batches`` (EventBatch fields as
    dicts); the assembled tables after each batch, and its num_users /
    num_items."""
    from repro_torch.online import EventBatch, OnlineUpdater

    mesh = ctx.mesh(shape, names)
    upd = OnlineUpdater(mf.params_from_numpy(full, device=ctx.device), None, 0.05, 0.05,
                        mesh=mesh, grad_compression=grad_compression, device=ctx.device,
                        **kwargs)
    out = []
    for fields in batches:
        upd.apply(EventBatch(**fields))
        params, state = upd._assembled()
        out.append({"p": params.p.numpy(), "q": params.q.numpy(),
                    "q_acc": state.q["acc"].numpy() if "acc" in state.q else None,
                    "num_users": upd.num_users, "num_items": upd.num_items})
    snap = upd.snapshot()
    out.append({"snapshot_p": snap.params.p.numpy(), "touched": snap.touched_users})
    return out


def refusal_case(ctx, shape, names, full, kwargs):
    """The message an ``OnlineUpdater(mesh=)`` refuses ``kwargs`` with."""
    from repro_torch.online import OnlineUpdater

    mesh = ctx.mesh(shape, names)
    try:
        OnlineUpdater(mf.params_from_numpy(full, device=ctx.device), mesh=mesh,
                      device=ctx.device, **kwargs)
    except ValueError as exc:
        return str(exc)
    return None


def elastic_case(ctx, directory, shape, names, full, batch, write):
    """``write``: train one sharded step on ``shape``, assemble and save on
    rank 0.  Else: ``elastic_load`` the checkpoint onto ``shape``, then
    return this rank's blocks and the assembled tree."""
    from repro_torch.checkpoint import checkpoint

    mesh = ctx.mesh(shape, names)
    if write:
        params, state = _blocks(ctx, mesh, full, "adagrad", "none")
        batch = {key: torch.as_tensor(value) for key, value in batch.items()}
        params, state, _ = mf.train_step_shard_map(params, state, batch, 0.05, 0.05, lr=0.05,
                                                   lam=0.02, opt_name="adagrad", mesh=mesh)
        tree = sharding.assemble_tree({"params": params, "opt_state": state}, mesh)
        if ctx.rank == 0:
            checkpoint.save(directory, 1, tree)
        torch.distributed.barrier()
        return _np_tree(tree)
    like = {"params": mf.params_from_numpy(full, device="cpu"),
            "opt_state": mf.init_opt_state(mf.params_from_numpy(full, device="cpu"),
                                           RowOptimizer(name="adagrad"))}
    blocks, _ = checkpoint.elastic_load(directory, like,
                                        lambda tree: sharding.shard_tree(tree, mesh))
    return _np_tree(blocks), _np_tree(sharding.assemble_tree(blocks, mesh))


def kernel_topk_case(ctx, shape, names, full, t, users, topk):
    """``topk_sharded`` on the card (each rank's slab through the
    ``pruned_topk`` kernel), the kernel launches it made on this rank, and
    the plain version of the whole catalog."""
    from repro_torch.core.ranks import effective_ranks
    from repro_torch.kernels import pruned_topk
    from repro_torch.serving import ServingEngine

    mesh = ctx.mesh(shape, names)
    engine = ServingEngine(mf.params_from_numpy(full, device=ctx.device), t, t,
                           device=ctx.device)
    before = pruned_topk.launches
    scores, ids = engine.topk_sharded(users, topk, mesh=mesh)
    launches = pruned_topk.launches - before
    params = engine.params
    pu = params.p[torch.as_tensor(users, device=params.p.device)]
    want_s, want_i = pruned_topk.pruned_topk_plain(
        pu, params.q, effective_ranks(pu, t), engine.r_i, engine._snap.item_bias_vec, topk)
    return scores, ids, launches, want_s.cpu().numpy(), want_i.cpu().numpy()


def session_case(ctx, shape, names, tree, seqs, cfg, t_p, t_q, sessions, topk):
    """SASRec sessions served through ``serve_sessions(mesh=)`` on this
    rank's catalog slab, and through the rank's local ``engine.topk``."""
    from repro_torch.models import recsys
    from repro_torch.workloads import sequential

    mesh = ctx.mesh(shape, names)
    params = recsys.recsys_params_from_numpy(tree, ctx.device)
    engine = sequential.session_engine(params, seqs, cfg, t_p, t_q, device=ctx.device,
                                       max_batch=8)
    return (sequential.serve_sessions(engine, sessions, topk, mesh=mesh),
            sequential.serve_sessions(engine, sessions, topk))
