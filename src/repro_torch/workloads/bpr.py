"""BPR pairwise ranking (Rendle et al., UAI'09) under dynamic pruning.

Counterpart of ``repro/workloads/bpr.py``.  For a user ``u``, an interacted
item ``i`` and a sampled non-interacted item ``j``, BPR minimizes

    -log sigma(s_ui - s_uj)  +  0.5 * lam * (||x_u||^2 + ||y_i||^2 + ||y_j||^2).

Every score stops at ``min(rank(x_u), rank(y_item))`` latent terms, the
regularizer is masked by each row's own rank, and the masks are constants,
so :func:`bpr_train_step` is the exact gradient of the masked loss; rate 0
is dense BPR.  The reference has no kernel for this step (masked ``jnp``),
and the port runs it as masked tensor ops, as its adagrad route does.

As everywhere in the port's training, the tables and optimizer state are
updated **in place**.  :class:`BPRSampler` draws each epoch's (user, pos,
neg) triples on the host with the reference's numpy calls, so the triples
for ``(seed, epoch)`` are bitwise the reference's; :func:`bpr_epoch_scan`
folds the step over them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import mf
from repro_torch.core.ranks import effective_ranks, rank_mask
from repro_torch.data.ratings import RatingsDataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.optimizers import RowOptimizer
from repro_torch.workloads.implicit import PositiveSet, _sample_negatives


def bpr_train_step(
    params: mf.MFParams,
    opt_state: mf.MFOptState,
    batch: Dict[str, torch.Tensor],   # {"user", "pos", "neg", opt. "weight"}
    t_p,
    t_q,
    lr,
    dim_mask: torch.Tensor,
    *,
    opt: RowOptimizer,
    lam: float,
) -> Tuple[mf.MFParams, mf.MFOptState, Dict[str, torch.Tensor]]:
    """One pruned BPR update on (user, pos, neg) triples, in place.

    With ``params.item_bias`` the item bias joins the score (the user bias
    and global mean cancel in the difference and stay untouched).  An
    optional ``batch["weight"]`` gates triples out of the update and the
    metrics (weight 0 = inert).  The positive and negative q-rows scatter
    through ONE ``apply_rows`` call on the concatenated indices, so a triple
    with ``pos == neg`` accumulates instead of racing.  ``abs_err`` carries
    the mean BPR loss, so the trainer's epoch record stays meaningful.
    Every gather happens before the first table is written.
    """
    u, i, j = batch["user"], batch["pos"], batch["neg"]
    weight = batch.get("weight")
    k = params.p.shape[-1]

    xf = params.p[u].float()
    yif = params.q[i].float()
    yjf = params.q[j].float()
    r_u = effective_ranks(xf, t_p)
    r_i = effective_ranks(yif, t_q)
    r_j = effective_ranks(yjf, t_q)
    rank_ui = torch.minimum(r_u, r_i)
    rank_uj = torch.minimum(r_u, r_j)
    dm = dim_mask[None, :]
    m_ui = rank_mask(rank_ui, k) * dm
    m_uj = rank_mask(rank_uj, k) * dm
    m_u = rank_mask(r_u, k) * dm
    m_i = rank_mask(r_i, k) * dm
    m_j = rank_mask(r_j, k) * dm

    s_ui = torch.sum(xf * yif * m_ui, dim=-1)
    s_uj = torch.sum(xf * yjf * m_uj, dim=-1)
    bias = params.item_bias
    if bias is not None:
        b_i, b_j = bias[i].float(), bias[j].float()
        s_ui = s_ui + b_i[:, 0]
        s_uj = s_uj + b_j[:, 0]
    diff = s_ui - s_uj
    # d(-log sigma(diff))/d(diff) = -(1 - sigma(diff)) = -sigma(-diff)
    sig = torch.sigmoid(-diff)
    w = torch.ones_like(diff) if weight is None else weight.float()

    g_p = -sig[:, None] * (yif * m_ui - yjf * m_uj) + lam * xf * m_u
    g_qi = -sig[:, None] * xf * m_ui + lam * yif * m_i
    g_qj = sig[:, None] * xf * m_uj + lam * yjf * m_j

    w_col = w[:, None].expand(-1, k)
    idx_q = torch.cat([i, j])
    w_q = torch.cat([w_col, w_col])
    opt.apply_rows(params.p, opt_state.p, u, g_p, w_col, lr)
    opt.apply_rows(params.q, opt_state.q, idx_q, torch.cat([g_qi, g_qj]), w_q, lr)
    if bias is not None:
        g_bi = -sig[:, None] + lam * b_i
        g_bj = sig[:, None] + lam * b_j
        w_b = torch.cat([w[:, None], w[:, None]])
        opt.apply_rows(bias, opt_state.item_bias, idx_q, torch.cat([g_bi, g_bj]), w_b, lr)

    denom = torch.clamp(torch.sum(w), min=1e-9)
    loss = torch.log1p(torch.exp(-diff.abs())) + torch.clamp(-diff, min=0.0)
    metrics = {
        "abs_err": torch.sum(loss * w) / denom,
        "work_fraction": torch.sum((rank_ui + rank_uj).float() * w) / (denom * 2 * k),
    }
    return params, opt_state, metrics


def bpr_epoch_scan(
    params: mf.MFParams,
    opt_state: mf.MFOptState,
    batches: Dict[str, torch.Tensor],   # each value (steps, B)
    t_p,
    t_q,
    lr,
    dim_mask: torch.Tensor,
    *,
    opt: RowOptimizer,
    lam: float,
) -> Tuple[mf.MFParams, mf.MFOptState, Dict[str, torch.Tensor]]:
    """A whole BPR epoch: :func:`bpr_train_step` folded over packed
    (user, pos, neg) triples, the metrics summed on the device as
    ``mf.train_epoch_scan`` sums them."""

    def step(p, s, batch):
        return bpr_train_step(p, s, batch, t_p, t_q, lr, dim_mask, opt=opt, lam=lam)

    return mf._epoch_loop(step, params, opt_state, batches)


class BPRSampler:
    """Per-epoch (user, pos, neg) triples from an interaction log.

    Every interaction is a positive; negatives are drawn fresh each epoch,
    uniformly over the catalog, with rejection against the observed pairs
    (``implicit._sample_negatives``).  Deterministic in ``(seed, epoch)``;
    the triples are uploaded per epoch as ``(steps, B)`` int64 tensors on
    ``device``, the operand of :func:`bpr_epoch_scan`.
    """

    def __init__(self, ds: RatingsDataset, batch_size: int, *, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.user = np.asarray(ds.user, np.int32)
        self.item = np.asarray(ds.item, np.int32)
        self.num_items = ds.num_items
        self.seed = seed
        self.batch_size = min(int(batch_size), max(self.user.size, 1))
        self._positives = PositiveSet(self.user, self.item, ds.num_items)

    @property
    def num_steps(self) -> int:
        return self.user.size // self.batch_size

    def epoch_triples_numpy(self, epoch: int) -> Dict[str, np.ndarray]:
        """The epoch's shuffled positives and fresh negatives, ``(steps,
        batch_size)`` int32 numpy arrays: the reference's draws."""
        if self.num_steps == 0:
            raise ValueError(
                f"batch_size {self.batch_size} exceeds the dataset "
                f"({self.user.size} interactions)"
            )
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, 0xB9]))
        take = rng.permutation(self.user.size)[: self.num_steps * self.batch_size]
        users = self.user[take]
        pos = self.item[take]
        neg = _sample_negatives(rng, users, self._positives, self.num_items)
        shape = (self.num_steps, self.batch_size)
        return {"user": users.reshape(shape), "pos": pos.reshape(shape),
                "neg": neg.reshape(shape)}

    def epoch_triples(self, epoch: int) -> Dict[str, torch.Tensor]:
        """:meth:`epoch_triples_numpy`, uploaded to the sampler's device."""
        return {key: torch.as_tensor(value, dtype=torch.int64).to(self.device)
                for key, value in self.epoch_triples_numpy(epoch).items()}
