"""MF model family (FunkSVD, BiasSVD, SVD++) with dynamic pruning.

Counterpart of ``repro/core/mf.py``.  ``p`` is (m, k) user-major, ``q`` is (n, k) item-major, biases are
(rows, 1), ``implicit`` is SVD++'s (n + 1, k) table whose row n is the zero
padding row.  Thresholds ``(t_p, t_q)`` of 0 disable pruning numerically, so
the dense baseline and the pruned path share one code path.

Training updates the tables **in place**: :func:`train_step` and
:func:`train_epoch_scan` write into ``params`` and ``opt_state`` and return
them, where the reference returns new arrays (and donates the old ones).  At
the dpmf size (a 51.2 GB user table) there is no room for a second copy.

The owner-compute step across ranks (:func:`train_step_shard_map`) runs
SPMD on a ``torch.distributed`` mesh (``repro_torch.distributed.spmd``):
each rank holds only its blocks of the tables and state
(``repro_torch.distributed.sharding.shard_tree``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ranks import effective_ranks, rank_mask
from repro_torch.device import DeviceLike, check_on, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.scatter import add_rows, add_rows_in_passes
from repro_torch.optim.optimizers import RowOptimizer

Batch = Dict[str, torch.Tensor]


class MFParams(NamedTuple):
    """Factor tables of one model; the optional fields are None for FunkSVD."""

    p: torch.Tensor                       # (m, k)
    q: torch.Tensor                       # (n, k)
    user_bias: Optional[torch.Tensor]     # (m, 1) | None
    item_bias: Optional[torch.Tensor]     # (n, 1) | None
    global_mean: Optional[torch.Tensor]   # ()     | None
    implicit: Optional[torch.Tensor]      # (n + 1, k) | None; row n is padding


def init_params(
    generator: torch.Generator,
    num_users: int,
    num_items: int,
    k: int,
    *,
    variant: str = "funk",          # funk | bias | svdpp
    init_method: str = "normal",    # normal | uniform | libmf  (paper §5.3)
    scale: float = 0.1,
    global_mean: float = 0.0,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> MFParams:
    """Random factors drawn from ``generator`` (which must live on ``device``).

    The draws differ from ``jax.random``'s for the same seed; tests that hold
    the port to the reference carry factors across with
    :func:`params_from_numpy` instead.
    """
    dev = resolve_device(device)

    if init_method not in ("normal", "uniform", "libmf"):
        raise ValueError(f"unknown init {init_method!r}")

    def draw(rows):
        # scaled in place: at the dpmf size a temporary would be another 51 GB
        shape = (rows, k)
        if init_method == "normal":
            return torch.randn(shape, generator=generator, dtype=dtype, device=dev).mul_(scale)
        u = torch.rand(shape, generator=generator, dtype=dtype, device=dev)
        if init_method == "uniform":
            lim = scale * (3.0 ** 0.5)  # same std as the normal init
            return u.mul_(2.0).sub_(1.0).mul_(lim)
        return u.mul_(k ** -0.5)

    p, q = draw(num_users), draw(num_items)
    y = draw(num_items + 1) if variant == "svdpp" else None
    with_bias = variant in ("bias", "svdpp")
    if y is not None:
        y[num_items] = 0.0
    return MFParams(
        p=p,
        q=q,
        user_bias=torch.zeros((num_users, 1), dtype=dtype, device=dev) if with_bias else None,
        item_bias=torch.zeros((num_items, 1), dtype=dtype, device=dev) if with_bias else None,
        global_mean=torch.tensor(global_mean, dtype=dtype, device=dev) if with_bias else None,
        implicit=y,
    )


def params_from_numpy(
    fields: Mapping[str, Optional[np.ndarray]], device: DeviceLike = None
) -> MFParams:
    """Build :class:`MFParams` from ``{field: array or None}`` (e.g. the
    reference's ``params._asdict()`` as numpy), on ``device``.  The tables
    are copies: training updates them in place, and must not write through
    into the caller's arrays."""
    dev = resolve_device(device)

    def conv(name):
        v = fields.get(name)
        if v is None:
            return None
        # read-only arrays (e.g. views of JAX buffers) are made writable
        # first; the one copy happens in .to()
        return torch.as_tensor(np.require(np.asarray(v), requirements="W")).to(dev, copy=True)

    return MFParams(*(conv(name) for name in MFParams._fields))


def params_from_flat(
    arrays: Mapping[str, Any], prefix: str = "params__", device: DeviceLike = None
) -> MFParams:
    """Rebuild :class:`MFParams` from a flat checkpoint payload with the
    ``params__p``-style keys of the reference trainer's checkpoints."""
    return params_from_numpy(
        {name: arrays.get(prefix + name) for name in MFParams._fields}, device
    )


def _user_vector(
    params: MFParams, u: torch.Tensor, hist: Optional[torch.Tensor]
) -> torch.Tensor:
    """p_u, or SVD++'s p_u + |N(u)|^-1/2 * sum_{j in N(u)} y_j."""
    p_rows = params.p[u]
    if params.implicit is None or hist is None:
        return p_rows
    # hist: (B, H) item ids padded with num_items (the zero row of `implicit`)
    n_items = params.implicit.shape[0] - 1
    y_sum = params.implicit[hist].sum(dim=1)
    counts = (hist < n_items).float().sum(dim=1, keepdim=True)
    return p_rows + y_sum * torch.rsqrt(torch.clamp(counts, min=1.0))


def predict_pairs(
    params: MFParams,
    u: torch.Tensor,
    i: torch.Tensor,
    t_p=0.0,
    t_q=0.0,
    hist: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pruned predictions for (u, i) pairs.  Returns (pred, pair_ranks)."""
    pu = _user_vector(params, u, hist)
    qi = params.q[i]
    r_u = effective_ranks(pu, t_p)
    r_i = effective_ranks(qi, t_q)
    mask = rank_mask(torch.minimum(r_u, r_i), pu.shape[-1])
    pred = torch.sum(pu.float() * qi.float() * mask, dim=-1)
    if params.user_bias is not None:
        pred = pred + params.global_mean + params.user_bias[u, 0] + params.item_bias[i, 0]
    return pred, torch.minimum(r_u, r_i)


def predict_all_items(
    params: MFParams,
    u: torch.Tensor,
    t_p=0.0,
    t_q=0.0,
    *,
    hist: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Score a user batch against *all* items: (B, n) float32.

    The paper's "matrix multiplication" stage at recommendation time, through
    :func:`repro_torch.kernels.ops.pruned_matmul` (the hand-written kernel on
    CUDA).  ``params`` must already lie on ``device``.
    """
    dev = resolve_device(device)
    check_on(dev, p=params.p, q=params.q, u=u, hist=hist)
    pu = _user_vector(params, u, hist)
    scores = kops.pruned_matmul(pu, params.q, t_p, t_q, device=dev)
    if params.user_bias is not None:
        scores = (
            scores
            + params.global_mean
            + params.user_bias[u]
            + params.item_bias[:, 0][None, :]
        )
    return scores


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


class MFOptState(NamedTuple):
    """Row-optimizer state per table; None where the table is None."""

    p: Dict[str, torch.Tensor]
    q: Dict[str, torch.Tensor]
    user_bias: Optional[Dict[str, torch.Tensor]]
    item_bias: Optional[Dict[str, torch.Tensor]]
    implicit: Optional[Dict[str, torch.Tensor]]


def init_opt_state(params: MFParams, opt: RowOptimizer) -> MFOptState:
    def init(table):
        return None if table is None else opt.init(table)

    return MFOptState(p=init(params.p), q=init(params.q), user_bias=init(params.user_bias),
                      item_bias=init(params.item_bias), implicit=init(params.implicit))


def _metrics(err, pair_ranks, w, k) -> Dict[str, torch.Tensor]:
    """Weighted mean |err| and work fraction of one batch, as device scalars."""
    denom = torch.clamp(torch.sum(w), min=1e-9)  # weighted mean, not deflated
    return {
        "abs_err": torch.sum(torch.abs(err) * w) / denom,
        "work_fraction": torch.sum(pair_ranks.float() * w) / (denom * k),
    }


def _train_step(
    params: MFParams,
    opt_state: MFOptState,
    batch: Batch,
    t_p: torch.Tensor,
    t_q: torch.Tensor,
    lr,
    dim_mask: torch.Tensor,  # (k,) twin-learners / strategy mask
    *,
    opt: RowOptimizer,
    lam: float,
    use_fused_kernel: bool = False,
) -> Tuple[MFParams, MFOptState, Dict[str, torch.Tensor]]:
    """One minibatched, dynamically pruned MF update (Algs. 2 + 3), in place.

    ``use_fused_kernel`` sends every plain-SGD case without implicit
    feedback (FunkSVD and BiasSVD, weighted or not) through the fused kernel
    (``kernels.ops.fused_mf_sgd``: the CUDA kernel on the card, its plain
    version on the CPU); every other (variant, optimizer) pair takes the
    masked tensor formulation with the same semantics.  Duplicate rows in a
    batch accumulate in batch order (``kernels.scatter.add_rows``).  An
    optional ``batch["weight"]`` (B,) gates rows out of the update and the
    metrics, never the prediction.
    ``t_p``/``t_q`` should be tensors on the tables' device: a Python float
    there costs a host-to-device copy per step.  The metrics are device
    scalars; nothing here waits on the card.
    """
    u, i, r = batch["user"], batch["item"], batch["rating"].float()
    hist = batch.get("hist")
    weight = batch.get("weight")
    k = params.p.shape[-1]

    pu = _user_vector(params, u, hist)
    qi = params.q[i]
    r_u = effective_ranks(pu, t_p)
    r_i = effective_ranks(qi, t_q)
    pair_ranks = torch.minimum(r_u, r_i)
    w = torch.ones_like(r) if weight is None else weight.float()

    if use_fused_kernel and opt.name == "sgd" and params.implicit is None:
        has_bias = params.user_bias is not None
        bu = params.user_bias[u, 0] if has_bias else None
        bi = params.item_bias[i, 0] if has_bias else None
        new_pu, new_qi, new_bu, new_bi, err = kops.fused_mf_sgd(
            pu, qi, r, t_p, t_q,
            lr=1.0,  # lr and the strategy mask fold into the delta below
            lam=lam, bias_u=bu, bias_i=bi,
            global_mean=params.global_mean if has_bias else 0.0,
            weight=weight, device=params.p.device,
        )
        # delta = (new - old) * lr * dim_mask, formed in the kernel's output
        # buffers, then scattered into the tables, duplicates in batch order
        dp = new_pu.sub_(pu).float().mul_(lr).mul_(dim_mask)
        dq = new_qi.sub_(qi).float().mul_(lr).mul_(dim_mask)
        add_rows(params.p, u, dp.to(params.p.dtype))
        add_rows(params.q, i, dq.to(params.q.dtype))
        if has_bias:
            add_rows(params.user_bias[:, 0], u, ((new_bu - bu) * lr).to(params.user_bias.dtype))
            add_rows(params.item_bias[:, 0], i, ((new_bi - bi) * lr).to(params.item_bias.dtype))
        return params, opt_state, _metrics(err, pair_ranks, w, k)

    pred_mask = rank_mask(pair_ranks, k) * dim_mask[None, :]
    mask = pred_mask * w[:, None]  # gates updates; predictions use pred_mask
    pred = torch.sum(pu.float() * qi.float() * pred_mask, dim=-1)
    if params.user_bias is not None:
        pred = pred + params.global_mean + params.user_bias[u, 0] + params.item_bias[i, 0]
    err = r - pred

    # gradients of 0.5 err^2 + 0.5 lam ||.||^2 at the gathered (old) rows;
    # every gather below happens before the table it reads is updated
    g_p = (lam * pu - err[:, None] * qi).float()
    g_q = (lam * qi - err[:, None] * pu).float()
    g_y = None
    if params.implicit is not None and hist is not None:
        # dL/dy_j = -err * q_i / sqrt(|N(u)|) for each j in N(u), masked
        n_items = params.implicit.shape[0] - 1
        counts = torch.sum((hist < n_items).float(), dim=1, keepdim=True)
        coef = err[:, None] * torch.rsqrt(torch.clamp(counts, min=1.0))
        g_y = -(coef[:, None, :] * (qi * pred_mask)[:, None, :]) * torch.ones(
            (1, hist.shape[1], 1), device=qi.device)
        g_y = g_y + lam * params.implicit[hist]
    if params.user_bias is not None:
        g_bu = (lam * params.user_bias[u] - err[:, None]).float()
        g_bi = (lam * params.item_bias[i] - err[:, None]).float()

    opt.apply_rows(params.p, opt_state.p, u, g_p, mask, lr)
    opt.apply_rows(params.q, opt_state.q, i, g_q, mask, lr)
    if params.user_bias is not None:
        w_col = w[:, None]
        opt.apply_rows(params.user_bias, opt_state.user_bias, u, g_bu, w_col, lr)
        opt.apply_rows(params.item_bias, opt_state.item_bias, i, g_bi, w_col, lr)
    if g_y is not None:
        flat_idx = hist.reshape(-1)
        # pred_mask-based mask: the row weight rides in once, through mask
        flat_mask = torch.repeat_interleave(mask, hist.shape[1], dim=0) * (
            flat_idx < n_items).float()[:, None]
        opt.apply_rows(params.implicit, opt_state.implicit, flat_idx,
                       g_y.reshape(-1, k), flat_mask, lr)
        params.implicit[n_items] = 0.0  # keep the padding row inert
    return params, opt_state, _metrics(err, pair_ranks, w, k)


train_step = _train_step


def _eval_mae(params: MFParams, batch: Batch, t_p, t_q) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum |err| and weighted count over a (possibly weight-masked) eval batch."""
    pred, _ = predict_pairs(params, batch["user"], batch["item"], t_p, t_q, batch.get("hist"))
    w = batch.get("weight")
    w = torch.ones_like(pred) if w is None else w
    abs_err = torch.abs(batch["rating"].float() - pred) * w
    return torch.sum(abs_err), torch.sum(w)


eval_mae = _eval_mae


def _epoch_loop(step_fn, params, opt_state, batches):
    """``step_fn(params, opt_state, batch)`` folded over packed ``(steps, B)``
    batches, the metrics summed as device scalars (sum of per-batch means,
    divided once), as the reference's ``_epoch_scan``."""
    steps = batches["user"].shape[0]
    err_sum = torch.zeros((), dtype=torch.float32, device=params.p.device)
    work_sum = torch.zeros((), dtype=torch.float32, device=params.p.device)
    for s in range(steps):
        params, opt_state, m = step_fn(params, opt_state,
                                       {key: value[s] for key, value in batches.items()})
        err_sum = err_sum + m["abs_err"]
        work_sum = work_sum + m["work_fraction"]
    denom = float(max(steps, 1))
    return params, opt_state, {"abs_err": err_sum / denom, "work_fraction": work_sum / denom}


def train_epoch_scan(
    params: MFParams,
    opt_state: MFOptState,
    batches: Batch,       # each value (steps, B) -- data/loader.PackedRatings
    t_p: torch.Tensor,
    t_q: torch.Tensor,
    lr,
    dim_mask: torch.Tensor,
    hist: Optional[torch.Tensor] = None,   # (m, H) device-resident SVD++ history
    *,
    opt: RowOptimizer,
    lam: float,
    use_fused_kernel: bool = False,
) -> Tuple[MFParams, MFOptState, Dict[str, torch.Tensor]]:
    """A whole epoch: :func:`train_step` folded over the packed batches.

    A device-side loop: the batches already lie on the card, the metrics
    accumulate as device scalars (sum of per-batch means, divided once), and
    nothing in the loop waits on the card.  The one host sync of an epoch is
    the caller's, when it reads the returned scalars.  The SVD++ history is
    passed whole and gathered per step.
    """
    def step(p, s, batch):
        if hist is not None:
            batch["hist"] = hist[batch["user"]]
        return _train_step(p, s, batch, t_p, t_q, lr, dim_mask,
                           opt=opt, lam=lam, use_fused_kernel=use_fused_kernel)

    return _epoch_loop(step, params, opt_state, batches)


def eval_epoch_scan(
    params: MFParams,
    batches: Batch,       # each value (steps, B), weight-padded tail
    t_p,
    t_q,
    hist: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum |err| and weighted count over pre-packed eval batches, as device
    scalars (the :func:`eval_mae` treatment of a whole pass)."""
    tot = torch.zeros((), dtype=torch.float32, device=params.p.device)
    cnt = torch.zeros((), dtype=torch.float32, device=params.p.device)
    for s in range(batches["user"].shape[0]):
        batch = {key: value[s] for key, value in batches.items()}
        if hist is not None:
            batch["hist"] = hist[batch["user"]]
        step_sum, step_cnt = _eval_mae(params, batch, t_p, t_q)
        tot = tot + step_sum
        cnt = cnt + step_cnt
    return tot, cnt


def eval_ranking_epoch_scan(
    params: MFParams,
    batches: Batch,       # repro_torch.eval.ranking.pack_ranking_batches output
    t_p,
    t_q,
    hist: Optional[torch.Tensor] = None,   # (m, H) device-resident SVD++ history
    *,
    topk: int,
) -> Dict[str, torch.Tensor]:
    """Ranking-metrics variant of :func:`eval_epoch_scan`: HR@K / NDCG@K /
    recall@K sums over pre-packed user batches, as float32 device scalars.

    Item ranks reduce once, outside the loop.  Each batch scores its users
    against the whole catalog through ``kernels.pruned_topk.pruned_topk_ranked``
    (the hand-written kernel on CUDA, the streaming merge on the CPU; both
    break ties to the lower item index, as ``lax.top_k`` does), so no
    ``(B, n)`` score matrix is made, then folds the ids through
    :func:`repro_torch.eval.ranking.ranking_counts`.  The per-user constant
    (user bias + global mean) is omitted: it never changes a ranking; the
    item bias is kept.  Nothing in the loop waits on the card: the caller's
    read of the sums is the evaluation's one host sync.
    """
    from repro_torch.eval.ranking import ranking_counts
    from repro_torch.kernels.pruned_topk import pruned_topk_ranked

    dev = params.p.device
    n = params.q.shape[0]
    r_i = effective_ranks(params.q, t_q)
    q = params.q.float().contiguous()
    bias = (
        torch.zeros((n,), dtype=torch.float32, device=dev)
        if params.item_bias is None else params.item_bias[:, 0].float().contiguous()
    )
    sums = {
        key: torch.zeros((), dtype=torch.float32, device=dev)
        for key in ("hr_sum", "ndcg_sum", "recall_sum", "weight_sum")
    }
    weight = batches.get("weight")
    for s in range(batches["user"].shape[0]):
        u = batches["user"][s]
        pu = _user_vector(params, u, None if hist is None else hist[u])
        r_u = effective_ranks(pu, t_p)
        _, idx = pruned_topk_ranked(pu.float().contiguous(), q, r_u, r_i, bias, topk)
        counts = ranking_counts(idx, batches["relevant"][s], batches["n_valid"][s],
                                None if weight is None else weight[s])
        sums = {key: sums[key] + counts[key] for key in sums}
    return sums


# ---------------------------------------------------------------------------
# Owner-compute step across ranks
# ---------------------------------------------------------------------------


def _check_owner_compute_opt(opt_name: str) -> None:
    if opt_name not in ("adagrad", "sgd"):
        raise ValueError(
            "the owner-compute step implements sgd and adagrad only, got "
            f"{opt_name!r}"
        )


def _resolve_grad_compression(grad_compression: str, compress_grads: bool) -> str:
    """Normalize the two compression knobs: the legacy ``compress_grads``
    bool maps to plain ``"int8"``; the string knob wins when both are set."""
    if grad_compression == "none" and compress_grads:
        return "int8"
    if grad_compression not in ("none", "int8", "int8_ef"):
        raise ValueError(
            f"grad_compression must be none|int8|int8_ef, got {grad_compression!r}"
        )
    return grad_compression


def _add_rows(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, *,
              keep: Optional[torch.Tensor] = None, in_passes: Optional[bool] = None) -> None:
    """``table[idx] += rows`` with repeated indices added in batch order, so
    every replica of a block that applies the same rows holds the same
    bits: :func:`~repro_torch.kernels.scatter.add_rows` (``index_add_`` on
    the CPU, the batch-order kernel on CUDA), or with ``in_passes`` its
    plain form in passes of distinct indices.  ``keep`` drops rows that are
    exact zeros (adding them changes no bit)."""
    if in_passes:
        add_rows_in_passes(table, idx, rows, keep=keep)
    else:
        add_rows(table, idx, rows, keep=keep)


def init_error_feedback_state(params: MFParams, opt_state: MFOptState, mesh=None) -> MFOptState:
    """Attach this rank's blocks of the int8 error-feedback residual tables
    to ``opt_state`` (``params`` are the rank's blocks).

    ``grad_compression="int8_ef"`` keeps, per sender, the running
    quantization residual of each compressed collective and folds it into
    the next transmission (EF-SGD).  Globally the tables are the
    reference's: ``opt_state.p["ef_psum"]`` (m, n_model * k) over
    ``P(dp, "model")`` (each model rank's untransmitted part of the
    p-gradient psum, keyed by user row) and ``opt_state.q["ef_gather"]``
    (n, n_dp * k) over ``P("model", dp)`` (each data rank's untransmitted
    part of the q-delta all-gather, keyed by item row); a rank's blocks are
    (m_loc, k) and (n_loc, k).
    """
    if mesh is None:
        raise ValueError("init_error_feedback_state needs a mesh: pass mesh=")
    k = params.p.shape[1]
    zeros = lambda rows: torch.zeros((rows, k), dtype=torch.float32,  # noqa: E731
                                     device=params.p.device)
    return opt_state._replace(
        p={**opt_state.p, "ef_psum": zeros(params.p.shape[0])},
        q={**opt_state.q, "ef_gather": zeros(params.q.shape[0])},
    )


def train_step_shard_map(
    params: MFParams,
    opt_state: MFOptState,
    batch: Batch,
    t_p,
    t_q,
    *,
    lr: float,
    lam: float,
    opt_name: str = "adagrad",
    eps: float = 1e-8,
    compress_grads: bool = False,
    grad_compression: str = "none",
    mesh=None,
) -> Tuple[MFParams, MFOptState, Dict[str, torch.Tensor]]:
    """DP-MF minibatch step with owner-compute collectives (FunkSVD only),
    SPMD: every rank calls it with the same global ``batch`` and its own
    blocks of ``params`` and ``opt_state``, which it updates in place.

    The user rows ``p`` are split over the data axes and the batch with
    them: data shard ``s`` takes the ``s``-th contiguous chunk of the batch,
    whose users it must own (``sharding.route_batch_to_owner_shards``), so
    all ``p`` traffic is local.  The item rows ``q`` are split over
    ``"model"``: each model rank computes the partial masked dot of the
    ratings whose item it owns (exact zeros elsewhere).  In the reference's
    order and gating:

    1. ownership: ``is_local`` marks the rows whose item this rank owns;
    2. one psum of the partial predictions over ``"model"``;
    3. the ``g_p`` exchange over ``"model"``: a psum (``"none"``), the
       int8 :func:`~repro_torch.distributed.compression.compressed_psum`
       (``"int8"``), or int8 with the sender's residual folded in on a
       ``pmax`` common scale (``"int8_ef"``);
    4. adagrad or sgd on the local rows;
    5. one all-gather over the data axes of the q-delta rows (int8 in the
       compressed modes), their indices and, for adagrad, ``g_q^2``, so
       every replica of a ``q`` block applies the same total update;
    6. the weighted metrics, summed over the data axes.

    Replicated blocks (``p`` over ``"model"``, ``q`` over the data axes)
    add their rows in batch order (:func:`_add_rows`), so the replicas stay
    bitwise equal on the card as on the CPU.

    An optional ``batch["weight"]`` gates rows out of the update and the
    metrics (weight-0 rows are inert, which lets the router pad buckets).
    Duplicate rows accumulate.  Returns ``(params, opt_state, metrics)``
    with the metrics equal on every rank.
    """
    from repro_torch.distributed import compression, sharding, spmd

    if mesh is None:
        raise ValueError("train_step_shard_map needs a mesh: pass mesh=")
    dp = sharding.data_axes(mesh)
    m_loc, k = params.p.shape
    n_loc = params.q.shape[0]
    _check_owner_compute_opt(opt_name)
    adagrad = opt_name == "adagrad"
    gc = _resolve_grad_compression(grad_compression, compress_grads)
    if gc == "int8_ef" and ("ef_psum" not in opt_state.p or "ef_gather" not in opt_state.q):
        raise ValueError(
            "grad_compression='int8_ef' needs the residual tables: call "
            "mf.init_error_feedback_state(params, opt_state, mesh) first"
        )
    dev = params.p.device
    t_p = torch.as_tensor(t_p, dtype=torch.float32, device=dev)
    t_q = torch.as_tensor(t_q, dtype=torch.float32, device=dev)

    # this rank's chunk of the global batch; the weight column is laid out
    # as the others
    weight = batch.get("weight")
    cols = {
        "user": batch["user"], "item": batch["item"], "rating": batch["rating"],
        "weight": torch.ones_like(torch.as_tensor(batch["rating"]), dtype=torch.float32)
        if weight is None else weight,
    }
    specs = sharding.mf_batch_shardings(mesh)
    cols = {key: sharding.block(torch.as_tensor(value).to(dev), specs.get(key, specs["rating"]),
                                mesh)
            for key, value in cols.items()}
    u, i = cols["user"].long(), cols["item"].long()
    r, w = cols["rating"].float(), cols["weight"].float()

    # 1. block-local coordinates; the router guarantees user ownership
    u_loc = u - spmd.axis_index(mesh, dp) * m_loc
    off_i = spmd.axis_index(mesh, "model") * n_loc
    is_local = (i >= off_i) & (i < off_i + n_loc)
    i_loc = torch.clamp(i - off_i, 0, n_loc - 1)

    p_rows = params.p[u_loc].float()
    q_rows = torch.where(is_local[:, None], params.q[i_loc].float(), 0.0)
    r_u = effective_ranks(p_rows, t_p)
    r_i = effective_ranks(q_rows, t_q)  # 0 on non-owners at t_q > 0 (zero rows)
    pair_mask = rank_mask(r_u, k) * rank_mask(r_i, k)

    # 2. everything is gated by ownership: at t_q == 0 a zero (non-owner)
    # row has rank k, and the lambda term would count n_model times
    own = is_local[:, None].float()
    pred = spmd.psum(torch.sum(p_rows * q_rows * pair_mask, dim=-1) * is_local, mesh,
                     "model", name="pred psum")
    err = r - pred
    wv = w[:, None]

    # 3. the p gradient, assembled on the item owner, then one exchange
    g_p_partial = own * pair_mask * wv * (lam * p_rows - err[:, None] * q_rows)
    model_group = mesh.get_group("model") if spmd.axis_size(mesh, "model") > 1 else None
    if gc == "int8_ef":
        ef_p = opt_state.p["ef_psum"]
        target = g_p_partial + ef_p[u_loc]
        scale = (compression.common_scale(torch.max(torch.abs(target)), model_group,
                                          name="g_p scale")
                 if model_group is not None
                 else compression.int8_scale(torch.max(torch.abs(target))))
        q8 = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
        recon = q8.float() * scale
        summed = (compression.psum_int8(q8, model_group, name="g_p int8")
                  if model_group is not None else q8.to(torch.int32))
        g_p = summed.float() * scale
        add_rows(ef_p, u_loc, g_p_partial - recon)
    elif gc == "int8":
        if model_group is not None:
            g_p = compression.compressed_psum(g_p_partial, model_group)
        else:
            q8, scale = compression.quantize_int8(g_p_partial)
            g_p = q8.to(torch.int32).float() * scale
    else:
        g_p = spmd.psum(g_p_partial, mesh, "model", name="g_p psum")
    g_q = own * pair_mask * wv * (lam * q_rows - err[:, None] * p_rows)
    safe_i = torch.where(is_local, i_loc, 0)
    # rows whose updates are exact zeros, left out of the replicated
    # tables' adds: weight 0, and for q an item another rank owns.  Under
    # int8_ef a weight-0 row still carries its item's (and user's) residual
    inert_ok = gc != "int8_ef"
    p_keep = (w != 0) if inert_ok else None
    q_keep = is_local & (w != 0) if inert_ok else is_local

    # 4. the optimizer on the local rows.  The second ``* wv`` mirrors
    # RowOptimizer.apply_rows, whose delta multiplies the mask again
    if adagrad:
        acc_p, acc_q = opt_state.p["acc"], opt_state.q["acc"]
        acc_p_rows = acc_p[u_loc] + g_p * g_p
        dp_rows = -lr * g_p / torch.sqrt(acc_p_rows + eps) * wv
        _add_rows(acc_p, u_loc, g_p * g_p, keep=p_keep)
        acc_q_rows = acc_q[safe_i] + g_q * g_q
        dq_rows = torch.where(is_local[:, None],
                              -lr * g_q / torch.sqrt(acc_q_rows + eps) * wv, 0.0)
    else:
        dp_rows = -lr * g_p
        dq_rows = -lr * g_q
    _add_rows(params.p, u_loc, dp_rows.to(params.p.dtype), keep=p_keep)

    # 5. each data shard computed q deltas for its own ratings only: gather
    # the sparse (B_loc, k) rows so every replica of the block applies all
    if dp:
        if gc in ("int8", "int8_ef"):
            if gc == "int8_ef":
                # residual rows exist only for items this model rank owns
                ef_q = opt_state.q["ef_gather"]
                payload = torch.where(is_local[:, None], dq_rows + ef_q[safe_i], 0.0)
            else:
                payload = dq_rows
            q8, scale = compression.quantize_int8(payload)
            gat_q8 = spmd.all_gather(q8, mesh, dp, name="dq int8 gather")
            gat_scale = spmd.all_gather(scale.reshape(1), mesh, dp, name="dq scale gather")
            gat_dq = compression.dequantize_int8(
                gat_q8.reshape(-1, q8.shape[0], k), gat_scale.reshape(-1, 1, 1)).reshape(-1, k)
            if gc == "int8_ef":
                recon = compression.dequantize_int8(q8, scale)
                add_rows(ef_q, safe_i, torch.where(is_local[:, None], dq_rows - recon, 0.0))
        else:
            gat_dq = spmd.all_gather(dq_rows, mesh, dp, name="dq gather")
        # the indices travel with -1 on the rows left out
        gat_idx = spmd.all_gather(torch.where(q_keep, i_loc, -1), mesh, dp,
                                  name="dq index gather")
        gat_keep = gat_idx >= 0
        _add_rows(params.q, gat_idx, gat_dq.to(params.q.dtype), keep=gat_keep)
        if adagrad:
            _add_rows(acc_q, gat_idx, spmd.all_gather(g_q * g_q, mesh, dp, name="g_q^2 gather"),
                      keep=gat_keep)
    else:
        add_rows(params.q, safe_i, dq_rows.to(params.q.dtype))
        if adagrad:
            add_rows(acc_q, safe_i, g_q * g_q)

    # 6. weighted metrics (err and w agree across model ranks, so only the
    # data axes are summed)
    r_i_owner = spmd.psum(r_i * is_local, mesh, "model", name="metrics psum")
    sums = torch.stack([
        torch.sum(w),
        torch.sum(torch.abs(err) * w),
        torch.sum(torch.minimum(r_u, r_i_owner).float() * w),
    ])
    if dp:
        sums = spmd.psum(sums, mesh, dp, name="metrics psum")
    denom = torch.clamp(sums[0], min=1e-9)
    metrics = {"abs_err": sums[1] / denom, "work_fraction": sums[2] / (denom * k)}
    return params, opt_state, metrics


def train_epoch_scan_shard_map(
    params: MFParams,
    opt_state: MFOptState,
    batches: Batch,
    t_p,
    t_q,
    *,
    lr: float,
    lam: float,
    opt_name: str = "adagrad",
    eps: float = 1e-8,
    compress_grads: bool = False,
    grad_compression: str = "none",
    mesh=None,
) -> Tuple[MFParams, MFOptState, Dict[str, torch.Tensor]]:
    """A whole epoch of :func:`train_step_shard_map` over packed
    ``(steps, B)`` batches (each step under the ownership contract), the
    metrics averaged as :func:`train_epoch_scan` averages them (sum of
    per-step means, divided once)."""
    _check_owner_compute_opt(opt_name)
    if mesh is None:
        raise ValueError("train_epoch_scan_shard_map needs a mesh: pass mesh=")

    def step(p, s, batch):
        return train_step_shard_map(
            p, s, batch, t_p, t_q, lr=lr, lam=lam, opt_name=opt_name, eps=eps,
            compress_grads=compress_grads, grad_compression=grad_compression, mesh=mesh,
        )

    return _epoch_loop(step, params, opt_state, batches)
