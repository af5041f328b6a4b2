"""dpmf: the paper's own architecture at production scale.

Counterpart of ``repro/configs/dpmf.py``: FunkSVD of a 100M-user x
10M-item rating matrix at k = 128, trained with dynamically pruned
minibatch Adagrad, user rows laid out over the data axes and item rows over
``"model"``.

The owner-compute cells (``train_1m_sm``, ``train_1m_smc``) run SPMD on a
``torch.distributed`` mesh, and the port has no ambient mesh: their step
takes it as a keyword, ``step(params, opt_state, batch, t_p, t_q,
mesh=mesh)``, with ``params`` and ``opt_state`` this rank's blocks
(``sharding.shard_tree``) and the batch routed to its owners
(``sharding.route_batch_to_owner_shards``).  ``serve_top100`` ranks the
whole catalog through ``pruned_topk`` (the kernel on CUDA, its plain version
on the CPU), never the (1024, 10M) score matrix the reference's cell builds.
"""
import dataclasses

import torch

from repro_torch.configs import base
from repro_torch.core import mf
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.optim.optimizers import RowOptimizer

ARCH_ID = "dpmf"


@dataclasses.dataclass(frozen=True)
class DPMFConfig:
    name: str = ARCH_ID
    num_users: int = 100_000_000
    num_items: int = 10_000_000
    k: int = 128
    lam: float = 0.02
    lr: float = 0.05
    optimizer: str = "adagrad"
    pruning_rate: float = 0.3


CONFIG = DPMFConfig()
SERVE_TOPK = 100


def smoke_config() -> DPMFConfig:
    return DPMFConfig(name=ARCH_ID + "-smoke", num_users=200, num_items=150, k=16)


def _init(generator, device=None):
    cfg = CONFIG
    return mf.init_params(generator, cfg.num_users, cfg.num_items, cfg.k, device=device)


def _abstract_batch(batch: int):
    return {
        "user": base.abstract((batch,), torch.int32),
        "item": base.abstract((batch,), torch.int32),
        "rating": base.abstract((batch,), torch.float32),
    }


def _long_ids(batch):
    return {**batch, "user": batch["user"].long(), "item": batch["item"].long()}


def _train_layouts(a_params, a_opt):
    def in_shardings(mesh):
        spec_fn = shd.mf_spec_fn(mesh)
        # MFOptState paths start with the table names (p/q/...), so the same
        # spec function lays the accumulators out like their tables
        return (shd.tree_shardings(a_params, spec_fn, mesh),
                shd.tree_shardings(a_opt, spec_fn, mesh),
                shd.mf_batch_shardings(mesh), shd.replicated(mesh), shd.replicated(mesh))

    return in_shardings


def _train_cell(batch: int) -> base.CellSpec:
    cfg = CONFIG
    opt = RowOptimizer(name=cfg.optimizer)

    def step(params, opt_state, batch_d, t_p, t_q):
        dim_mask = torch.ones((cfg.k,), dtype=torch.float32, device=params.p.device)
        return mf.train_step(params, opt_state, _long_ids(batch_d), t_p, t_q, cfg.lr, dim_mask,
                             opt=opt, lam=cfg.lam)

    a_params = base.abstract_like(_init, torch.Generator())
    a_opt = mf.init_opt_state(a_params, opt)
    a_scalar = base.abstract((), torch.float32)
    return base.CellSpec(
        arch=ARCH_ID,
        shape_id=f"train_{batch // 1024}k",
        kind="train",
        step_fn=step,
        abstract_args=(a_params, a_opt, _abstract_batch(batch), a_scalar, a_scalar),
        in_shardings=_train_layouts(a_params, a_opt),
        donate_argnums=(0, 1),
        note="paper's DP-MF minibatch step: gather -> pruned dot -> masked update",
    )


def _serve_cell(batch: int) -> base.CellSpec:
    def step(params, users, t_p, t_q):
        h = params.p[users.long()]
        return kops.pruned_topk(h, params.q, t_p, t_q, SERVE_TOPK, device=h.device)

    a_params = base.abstract_like(_init, torch.Generator())
    a_scalar = base.abstract((), torch.float32)

    def in_shardings(mesh):
        p_sh = shd.tree_shardings(a_params, shd.mf_spec_fn(mesh), mesh)
        return (p_sh, shd.ns(mesh, shd.data_axes(mesh)),
                shd.replicated(mesh), shd.replicated(mesh))

    return base.CellSpec(
        arch=ARCH_ID,
        shape_id=f"serve_top{SERVE_TOPK}_{batch}",
        kind="serve",
        step_fn=step,
        abstract_args=(a_params, base.abstract((batch,), torch.int32), a_scalar, a_scalar),
        in_shardings=in_shardings,
        note="pruned full-catalog top-100 through pruned_topk (paper's 'matrix "
             "multiplication' stage)",
    )


def _train_cell_owner_compute(batch: int, compress: bool = False) -> base.CellSpec:
    """The owner-compute step (``mf.train_step_shard_map``; ``compress``
    int8-quantizes the cross-rank payloads), given its mesh by keyword."""
    cfg = CONFIG
    opt = RowOptimizer(name=cfg.optimizer)

    def step(params, opt_state, batch_d, t_p, t_q, *, mesh):
        return mf.train_step_shard_map(
            params, opt_state, batch_d, t_p, t_q,
            lr=cfg.lr, lam=cfg.lam, opt_name=cfg.optimizer,
            compress_grads=compress, mesh=mesh,
        )

    a_params = base.abstract_like(_init, torch.Generator())
    a_opt = mf.init_opt_state(a_params, opt)
    a_scalar = base.abstract((), torch.float32)
    return base.CellSpec(
        arch=ARCH_ID,
        shape_id=f"train_{batch // 1024}k_sm" + ("c" if compress else ""),
        kind="train",
        step_fn=step,
        abstract_args=(a_params, a_opt, _abstract_batch(batch), a_scalar, a_scalar),
        in_shardings=_train_layouts(a_params, a_opt),
        donate_argnums=(0, 1),
        note="owner-compute DP-MF step across ranks (batch routed by user shard)",
        whole_args=(2, 3, 4),
    )


def cells():
    return {
        "train_1m": lambda: _train_cell(1_048_576),
        "train_1m_sm": lambda: _train_cell_owner_compute(1_048_576),
        "train_1m_smc": lambda: _train_cell_owner_compute(1_048_576, compress=True),
        "serve_top100": lambda: _serve_cell(1024),
    }
