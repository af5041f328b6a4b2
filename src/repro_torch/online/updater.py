"""Incremental pruned factor updates: the paper's Alg. 2/3 applied online.

Counterpart of ``repro/online/updater.py``.  The same masked
update as training (``mf.train_step`` with the trained thresholds, through
any :class:`~repro_torch.optim.optimizers.RowOptimizer`) is applied to
streaming event micro-batches; each batch touches only its gathered rows,
and the early-stopping mask gates the per-row work exactly as in training.
Like the reference, the updater calls ``train_step`` without
``use_fused_kernel``: it takes the masked route in both packages.

Beyond the step the updater owns three maintenance jobs:

* **cold start**: an event naming an id past the tables grows them (biases,
  implicit factors, optimizer state and histories too) by exactly the rows
  needed, the new rows drawn from the updater's numpy generator as the
  reference draws them;
* **threshold drift**: :meth:`maybe_recalibrate` re-solves Eq. 7/8 and, past
  ``drift_budget``, adopts the new thresholds and re-runs the §4.3
  rearrangement over P, Q, the implicit factors and the optimizer state;
* **publish bookkeeping**: touched row sets and a ``layout_dirty`` flag for
  :class:`~repro_torch.online.publisher.SnapshotPublisher`.

With a :class:`~repro_torch.store.eviction.UserEvictor` attached
(:meth:`attach_evictor`) event user ids are *external*: every batch is
translated to physical rows (reviving spilled users), snapshots carry the
remap table and its epoch, and :meth:`evaluate` scores spilled users by the
bias-only fallback.

**Across ranks** (``mesh=``, SPMD: every rank makes the same calls with
the same batches) each rank holds only its blocks of the tables and
optimizer state (``sharding.shard_tree``), and every event batch goes
through ``route_batch_to_owner_shards`` and one owner-compute
``mf.train_step_shard_map`` (FunkSVD with sgd or adagrad, as the reference
refuses the rest).  Growth, snapshots, drift and evaluation work on the
assembled tables (one all-gather each); growth rounds up to the mesh
multiples and re-shards.

**Published versions are immutable.**  The port trains in place, where the
reference's arrays are immutable and its :meth:`snapshot` can hand the
engine the live tables.  Here the updater never writes a tensor it did not
make: the tables given to the constructor and the tables a snapshot hands
out are marked shared, and the next write (an :meth:`apply`, a
recalibration) first clones the shared ones (copy on write).  A published
version therefore keeps its tensors as they were, and a batch in flight on
the engine finishes on them bit for bit.  Memory: the live tables plus the
served version, two copies; the clone costs one pass over the tables at the
first write after each publish.  Growth makes new tables anyway and needs
no clone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set

import numpy as np
import torch

from repro_torch.core import mf, rearrange, threshold
from repro_torch.data import loader
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.online.stream import EventBatch, RatingFreeStreamError
from repro_torch.optim.optimizers import RowOptimizer

_FIELDS = frozenset(mf.MFParams._fields)


@dataclasses.dataclass
class PublishSnapshot:
    """What one :meth:`OnlineUpdater.snapshot` hands the publisher."""

    params: mf.MFParams
    t_p: torch.Tensor
    t_q: torch.Tensor
    touched_users: np.ndarray
    touched_items: np.ndarray
    touched_implicit_items: np.ndarray
    user_history: Optional[np.ndarray]
    full_rebuild: bool          # thresholds/permutation/geometry changed
    events_seen: int            # cumulative over the updater's lifetime
    snapshot_id: int = 0        # monotonic per updater
    user_remap: Optional[np.ndarray] = None  # ext -> phys (store/eviction.py)
    remap_epoch: int = 0        # compaction counter; a bump forces a full payload


class OnlineUpdater:
    """Apply streaming event micro-batches as pruned row updates.

    Runs on ``device`` (default ``cuda``; ``"cpu"`` for the plain path), to
    which the tables are moved.  ``batch_size`` caps a step: event batches
    split into power-of-two chunks (:meth:`_chunk_sizes`), which is part of
    the arithmetic, so the chunking is the reference's.  ``pruning_rate``
    enables :meth:`maybe_recalibrate`.  ``mesh`` (a ``DeviceMesh`` with
    a ``"model"`` dim and data axes) shards the updates: ``params`` and
    ``opt_state`` are the full tables on every rank, of which each keeps
    its blocks; ``grad_compression`` (none | int8 | int8_ef) then picks the
    sharded step's gradient exchange.
    """

    def __init__(
        self,
        params: mf.MFParams,
        opt_state: Optional[mf.MFOptState] = None,
        t_p=0.0,
        t_q=0.0,
        *,
        optimizer="adagrad",
        lr: float = 0.05,
        lam: float = 0.02,
        pruning_rate: float = 0.0,
        drift_budget: float = 0.25,
        user_history: Optional[np.ndarray] = None,
        batch_size: int = 256,
        init_scale: float = 0.1,
        seed: int = 0,
        mesh=None,
        grad_compression: str = "none",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.opt = optimizer if isinstance(optimizer, RowOptimizer) else RowOptimizer(name=optimizer)
        self.params = mf.MFParams(*(None if v is None else v.to(self.device) for v in params))
        self.opt_state = (
            mf.init_opt_state(self.params, self.opt) if opt_state is None
            else mf.MFOptState(*(
                None if s is None else {key: v.to(self.device) for key, v in s.items()}
                for s in opt_state))
        )
        # copy on write: the caller's tables (and state) are never written
        self._shared_params: Set[str] = set(_FIELDS)
        self._shared_state: Set[str] = set(_FIELDS) if opt_state is not None else set()
        self.mesh = mesh
        self.grad_compression = grad_compression
        self._n_dp = self._user_multiple = self._item_multiple = 1
        if mesh is not None:
            self._init_mesh(mesh, grad_compression)
        self.t_p = self._scalar(t_p)
        self.t_q = self._scalar(t_q)
        self.lr = float(lr)
        self.lam = float(lam)
        self.pruning_rate = float(pruning_rate)
        self.drift_budget = float(drift_budget)
        self.batch_size = int(batch_size)
        self.init_scale = float(init_scale)
        self._rng = np.random.default_rng(seed)
        if self.params.implicit is not None and user_history is None:
            raise ValueError(
                "SVD++ params need user_history (data.build_user_history) so "
                "online events can extend the implicit-feedback sets")
        self.user_history = (
            None if user_history is None else np.array(user_history, np.int32, copy=True)
        )
        self._dim_mask = torch.ones((self.params.p.shape[1],), dtype=torch.float32,
                                    device=self.device)
        self.evictor = None  # store.eviction.UserEvictor, via attach_evictor

        # publish bookkeeping
        self._touched_users: Set[int] = set()
        self._touched_items: Set[int] = set()
        self._touched_implicit: Set[int] = set()
        self._layout_dirty = False
        self.events_seen = 0
        self.snapshots_taken = 0
        self.batches_applied = 0
        self._work_sum = 0.0
        self._abs_err_sum = 0.0

    def _init_mesh(self, mesh, grad_compression: str) -> None:
        """Distributed refresh: the reference's refusals, then this rank's
        blocks (new tensors: nothing of the caller's is written)."""
        from repro_torch.distributed import sharding, spmd

        if self.opt.name not in ("sgd", "adagrad"):
            raise ValueError(
                "mesh-backed online updates support sgd/adagrad only "
                f"(got {self.opt.name!r})")
        params = self.params
        if params.user_bias is not None or params.implicit is not None:
            raise ValueError(
                "mesh-backed online updates support the FunkSVD variant "
                "only (no biases / implicit factors)")
        self._n_dp = spmd.axis_size(mesh, sharding.data_axes(mesh))
        self._user_multiple = self._n_dp
        self._item_multiple = spmd.axis_size(mesh, "model")
        if params.p.shape[0] % self._user_multiple or params.q.shape[0] % self._item_multiple:
            raise ValueError(
                "factor tables must divide over the mesh: "
                f"P rows {params.p.shape[0]} over {self._user_multiple}, "
                f"Q rows {params.q.shape[0]} over {self._item_multiple}")
        mf._resolve_grad_compression(grad_compression, False)
        self._shard({"params": self.params, "opt_state": self.opt_state})
        if grad_compression == "int8_ef":
            # per-sender residuals ride in the opt_state (row-indexed, so
            # growth keeps them aligned)
            self.opt_state = mf.init_error_feedback_state(self.params, self.opt_state, mesh)

    def _shard(self, tree) -> None:
        from repro_torch.distributed import sharding

        blocks = sharding.shard_tree(tree, self.mesh, device=self.device)
        self.params, self.opt_state = blocks["params"], blocks["opt_state"]
        self._shared_params.clear()
        self._shared_state.clear()

    def _assembled(self, with_state: bool = True):
        """``(params, opt_state)`` as full tables (on a mesh: one all-gather
        of every block, the state only ``with_state``; otherwise the live
        tables)."""
        if self.mesh is None:
            return self.params, self.opt_state
        from repro_torch.distributed import sharding

        tree = {"params": self.params, "opt_state": self.opt_state if with_state else None}
        full = sharding.assemble_tree(tree, self.mesh)
        return full["params"], full["opt_state"]

    def _scalar(self, value) -> torch.Tensor:
        return torch.as_tensor(value, dtype=torch.float32).to(self.device)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_trainer(cls, trainer, **kwargs) -> "OnlineUpdater":
        """Continue a :class:`~repro_torch.core.trainer.DPMFTrainer` run
        online: same params, optimizer state, thresholds, history and
        device (the trainer's tensors are not written)."""
        cfg = trainer.config
        kwargs.setdefault("optimizer", trainer.opt)
        kwargs.setdefault("lr", cfg.lr)
        kwargs.setdefault("lam", cfg.lam)
        kwargs.setdefault("pruning_rate", cfg.pruning_rate)
        kwargs.setdefault("user_history", trainer.hist)
        kwargs.setdefault("batch_size", min(cfg.batch_size, 4096))
        kwargs.setdefault("device", trainer.device)
        kwargs.setdefault("grad_compression", cfg.grad_compression)
        return cls(trainer.params, trainer.opt_state, trainer.t_p, trainer.t_q, **kwargs)

    def attach_evictor(self, evictor) -> None:
        """Arm cold-row eviction (``store/eviction.UserEvictor``): event user
        ids become external ids, translated to physical rows on every apply;
        ``evictor.maybe_evict()`` may spill and compact the user tables at
        publish points.  ``bind`` refuses a mesh-backed updater."""
        evictor.bind(self)
        self.evictor = evictor

    def resolve_users(self, users: np.ndarray) -> np.ndarray:
        """External user ids to the physical rows an update writes, growing
        and reviving as needed (the identity plus cold-start growth without
        an evictor).  Scorers call this instead of ``ensure_capacity`` so
        they stay correct under a remap."""
        users = np.asarray(users, np.int32)
        if users.size == 0:
            return users
        if self.evictor is None:
            self.ensure_capacity(int(users.max()), -1)
            return users
        return self.evictor.resolve(users).astype(np.int32)

    # -- properties ----------------------------------------------------------
    @property
    def num_users(self) -> int:
        """Current user-table rows (grows with cold-start events)."""
        return self.params.p.shape[0] * self._user_multiple

    @property
    def num_items(self) -> int:
        """Current catalog size (grows with cold-start events)."""
        return self.params.q.shape[0] * self._item_multiple

    @property
    def mean_work_fraction(self) -> float:
        """Mean executed share of dense MACs over the updater's lifetime."""
        return self._work_sum / max(self.batches_applied, 1)

    @property
    def mean_abs_err(self) -> float:
        """Mean per-batch training |error| over the updater's lifetime."""
        return self._abs_err_sum / max(self.batches_applied, 1)

    # -- copy on write -------------------------------------------------------
    def _own_tables(self) -> None:
        """Clone every table (and optimizer-state table) that a caller or a
        published snapshot still holds, before the updater writes it."""
        if self._shared_params:
            self.params = mf.MFParams(*(
                value.clone() if value is not None and name in self._shared_params else value
                for name, value in zip(mf.MFParams._fields, self.params)))
            self._shared_params.clear()
        if self._shared_state:
            self.opt_state = mf.MFOptState(*(
                {key: v.clone() for key, v in state.items()}
                if state is not None and name in self._shared_state else state
                for name, state in zip(mf.MFOptState._fields, self.opt_state)))
            self._shared_state.clear()

    # -- cold start ----------------------------------------------------------
    def _fresh_rows(self, rows: int, k: int, dtype) -> torch.Tensor:
        """``init_scale * N(0, 1)`` rows from the numpy generator (float64,
        rounded once to ``dtype``), as the reference draws them."""
        draw = self.init_scale * self._rng.standard_normal((rows, k))
        return torch.as_tensor(draw).to(self.device, dtype)

    @staticmethod
    def _grow_state(state: Dict, rows: int, axis0: int) -> Dict:
        def grow(v):
            if v.dim() >= 1 and v.shape[0] == axis0:
                return torch.cat([v, v.new_zeros((rows,) + tuple(v.shape[1:]))])
            return v

        return {key: grow(value) for key, value in state.items()}

    def ensure_capacity(self, max_user: int, max_item: int) -> bool:
        """Grow the tables so ``max_user``/``max_item`` are valid ids, by
        exactly the rows needed (on a mesh, rounded up to the mesh
        multiples: the assembled tables grow, then are re-sharded).

        New factor rows get the training init (``init_scale * N(0, 1)``),
        biases and optimizer accumulators start at zero, new SVD++ history
        rows start empty.  Growth only appends, into new tensors (a version
        the engine holds keeps its own), and the grown rows join the touched
        sets.  Returns True if anything grew.
        """
        m, n = self.num_users, self.num_items
        k = self.params.p.shape[1]

        # on a mesh, growth rounds up to the mesh multiples so the grown
        # tables keep dividing over the data/model axes
        def round_up(v: int, mult: int) -> int:
            return -(-v // mult) * mult

        add_n = max(0, round_up(max_item + 1, self._item_multiple) - n)
        add_m = max(0, round_up(max_user + 1, self._user_multiple) - m)
        if not (add_n or add_m):
            return False
        params, state = self._assembled()
        grew = False
        if add_n:
            grew = True
            new_n = n + add_n
            zeros_n = lambda t: torch.cat([t, t.new_zeros((add_n,) + tuple(t.shape[1:]))])  # noqa: E731
            params = params._replace(
                q=torch.cat([params.q, self._fresh_rows(add_n, k, params.q.dtype)]),
                item_bias=None if params.item_bias is None else zeros_n(params.item_bias),
            )
            if params.implicit is not None:
                # (n + 1, k) with the inert padding row last: old rows,
                # fresh rows, then a new zero padding row at index new_n
                params = params._replace(implicit=torch.cat([
                    params.implicit[:n],
                    self._fresh_rows(add_n, k, params.implicit.dtype),
                    params.implicit.new_zeros((1, k)),
                ]))
                if self.user_history is not None:
                    self.user_history[self.user_history == n] = new_n
            state = state._replace(
                q=self._grow_state(state.q, add_n, n),
                item_bias=(None if state.item_bias is None
                           else self._grow_state(state.item_bias, add_n, n)),
                implicit=(None if state.implicit is None else {
                    key: torch.cat([v[:n], v.new_zeros((add_n,) + tuple(v.shape[1:])), v[n:]])
                    if v.dim() >= 1 and v.shape[0] == n + 1 else v
                    for key, v in state.implicit.items()
                }),
            )
            self._shared_params -= {"q", "item_bias", "implicit"}
            self._shared_state -= {"q", "item_bias", "implicit"}
            self._touched_items.update(range(n, new_n))
            self._touched_implicit.update(range(n, new_n))
            n = new_n
        if add_m:
            grew = True
            params = params._replace(
                p=torch.cat([params.p, self._fresh_rows(add_m, k, params.p.dtype)]),
                user_bias=(None if params.user_bias is None else torch.cat([
                    params.user_bias, params.user_bias.new_zeros((add_m, 1))])),
            )
            state = state._replace(
                p=self._grow_state(state.p, add_m, m),
                user_bias=(None if state.user_bias is None
                           else self._grow_state(state.user_bias, add_m, m)),
            )
            self._shared_params -= {"p", "user_bias"}
            self._shared_state -= {"p", "user_bias"}
            if self.user_history is not None:
                self.user_history = np.concatenate([
                    self.user_history,
                    np.full((add_m, self.user_history.shape[1]), n, np.int32),
                ])
            self._touched_users.update(range(m, m + add_m))
        # growth does not mark the layout dirty: the engine's swap sees a
        # changed catalog on its own, and grown rows are touched rows
        if self.mesh is not None:
            self._shard({"params": params, "opt_state": state})
        else:
            self.params = params
            self.opt_state = state
        return grew

    # -- the incremental step ------------------------------------------------
    def _append_history(self, users: np.ndarray, items: np.ndarray) -> None:
        """Record new interactions in the SVD++ implicit sets: first free
        slot, or FIFO eviction of the oldest entry when the row is full."""
        hist = self.user_history
        pad = self.num_items
        for u, i in zip(users, items):
            row = hist[u]
            if i in row:
                continue
            free = np.nonzero(row == pad)[0]
            if free.size:
                row[free[0]] = i
            else:
                row[:-1] = row[1:]
                row[-1] = i

    @staticmethod
    def _chunk_sizes(total: int, cap: int):
        """Binary decomposition of ``total`` into power-of-two chunk sizes
        capped at ``cap``, largest first: no padding rows, so stateful
        optimizers stay exact."""
        sizes = []
        while total >= cap:
            sizes.append(cap)
            total -= cap
        bit = 1
        while total:
            if total & bit:
                sizes.append(bit)
                total &= ~bit
            bit <<= 1
        sizes.sort(reverse=True)
        return sizes

    def _upload(self, values: np.ndarray, dtype) -> torch.Tensor:
        return torch.as_tensor(values, dtype=dtype).to(self.device)

    def apply(self, batch: EventBatch) -> Dict[str, float]:
        """Apply one event micro-batch; returns step metrics.

        The batch is split into power-of-two chunks (largest first, capped
        at ``batch_size``); ``work_fraction`` is the executed share of dense
        MACs over the real events.  The metrics are read once, after the
        last chunk.
        """
        if len(batch) == 0:
            return {"abs_err": 0.0, "work_fraction": 1.0, "events": 0}
        if batch.rating is None:
            raise RatingFreeStreamError(
                "OnlineUpdater.apply trains on the rating column and this "
                "batch is rating-free.  Convert clicks into weighted binary "
                "preferences first (repro_torch.workloads.implicit."
                "implicit_event_batch(batch, num_items=...)), then apply "
                "the converted batch.")
        users = np.asarray(batch.user, np.int32)
        items = np.asarray(batch.item, np.int32)
        ratings = np.asarray(batch.rating, np.float32)
        weights = None if batch.weight is None else np.asarray(batch.weight, np.float32)
        if self.evictor is not None:
            # external ids -> physical rows (reviving spilled users); every
            # index from here on is physical
            users = self.evictor.resolve(users)
        self.ensure_capacity(int(users.max()), int(items.max()))
        if self.user_history is not None:
            self._append_history(users, items)
        self._own_tables()

        total = len(users)
        if self.mesh is not None:
            return self._finish_apply(users, items, total, *self._apply_sharded(
                users, items, ratings, weights))
        sizes = self._chunk_sizes(total, self.batch_size)
        parts = []
        lo = 0
        for size in sizes:
            sl = slice(lo, lo + size)
            lo += size
            step_batch = {
                "user": self._upload(users[sl], torch.int64),
                "item": self._upload(items[sl], torch.int64),
                "rating": self._upload(ratings[sl], torch.float32),
            }
            if weights is not None:
                step_batch["weight"] = self._upload(weights[sl], torch.float32)
            if self.user_history is not None:
                step_batch["hist"] = self._upload(self.user_history[users[sl]], torch.int64)
            self.params, self.opt_state, metrics = mf.train_step(
                self.params, self.opt_state, step_batch, self.t_p, self.t_q, self.lr,
                self._dim_mask, opt=self.opt, lam=self.lam,
            )
            parts += [metrics["abs_err"], metrics["work_fraction"]]
        values = torch.stack(parts).tolist()  # the apply's one host sync
        abs_err = work = 0.0
        for size, e, w in zip(sizes, values[0::2], values[1::2]):
            abs_err += e * size
            work += w * size
        return self._finish_apply(users, items, total, abs_err, work)

    def _apply_sharded(self, users, items, ratings, weights):
        """One owner-compute sharded step over the whole event batch, routed
        to its owners' shards (weight-0 padding to a power-of-two length);
        returns the batch's ``(abs_err, work)`` sums."""
        from repro_torch.distributed.sharding import route_batch_to_owner_shards

        routed = route_batch_to_owner_shards(
            users, items, ratings, num_users=self.num_users, n_dp=self._n_dp,
            weight=weights, pad_to_pow2=True)
        step_batch = {key: torch.as_tensor(value) for key, value in routed.items()}
        self.params, self.opt_state, metrics = mf.train_step_shard_map(
            self.params, self.opt_state, step_batch, self.t_p, self.t_q, lr=self.lr,
            lam=self.lam, opt_name=self.opt.name, grad_compression=self.grad_compression,
            mesh=self.mesh)
        abs_err, work = torch.stack([metrics["abs_err"], metrics["work_fraction"]]).tolist()
        total = len(users)
        return abs_err * total, work * total

    def _finish_apply(self, users, items, total, abs_err, work) -> Dict[str, float]:
        self._touched_users.update(users.tolist())
        self._touched_items.update(items.tolist())
        if self.params.implicit is not None:
            # the implicit rows of every history item of the batch users moved
            hist_rows = self.user_history[users]
            self._touched_implicit.update(hist_rows[hist_rows < self.num_items].tolist())
        self.events_seen += total
        self.batches_applied += 1
        self._work_sum += work / total
        self._abs_err_sum += abs_err / total
        return {"abs_err": abs_err / total, "work_fraction": work / total, "events": total}

    # -- threshold drift maintenance -----------------------------------------
    def _candidate_thresholds(self):
        """(cand_p, cand_q, drift): the thresholds the current factors imply
        and their relative distance from the live ones."""
        params, _ = self._assembled(with_state=False)
        cand_p, cand_q = threshold.thresholds_from_matrices(params.p, params.q, self.pruning_rate)
        t_p, t_q = float(self.t_p), float(self.t_q)
        drift = max(abs(float(cand_p) - t_p) / max(t_p, 1e-8),
                    abs(float(cand_q) - t_q) / max(t_q, 1e-8))
        return cand_p, cand_q, drift

    def drift(self) -> float:
        """Relative distance between the live thresholds and the ones the
        current factors imply (0 when pruning is off)."""
        if self.pruning_rate <= 0.0:
            return 0.0
        return self._candidate_thresholds()[2]

    def maybe_recalibrate(self, *, force: bool = False) -> Optional[Dict]:
        """Past ``drift_budget`` (or with ``force``): adopt fresh thresholds
        and re-run the §4.3 rearrangement, one latent permutation applied to
        P, Q, the implicit factors and every 2-D optimizer-state table of
        width k (in place, after the copy on write), so every inner product
        is preserved.  Marks the next snapshot for a full rebuild.  Returns
        a report, or None within budget."""
        if self.pruning_rate <= 0.0:
            return None
        cand_p, cand_q, drift = self._candidate_thresholds()
        if not force and drift <= self.drift_budget:
            return None
        old_t_p, old_t_q = float(self.t_p), float(self.t_q)
        self.t_p, self.t_q = cand_p.to(self.device), cand_q.to(self.device)
        full, _ = self._assembled(with_state=False)
        perm = rearrange.rearrangement(full.p, full.q, self.t_p, self.t_q).perm
        del full
        self._own_tables()
        k = self.params.p.shape[1]
        tables = [self.params.p, self.params.q]
        if self.params.implicit is not None:
            tables.append(self.params.implicit)
        for state in (self.opt_state.p, self.opt_state.q, self.opt_state.implicit):
            for value in (state or {}).values():
                if value.dim() == 2 and value.shape[1] == k:
                    tables.append(value)
        rearrange.apply_perm_tree(tables, perm)
        self._layout_dirty = True
        return {"drift": drift, "t_p": (old_t_p, float(self.t_p)),
                "t_q": (old_t_q, float(self.t_q)), "perm": perm.cpu().numpy()}

    # -- publishing ----------------------------------------------------------
    def snapshot(self) -> PublishSnapshot:
        """Freeze the accumulated delta for publication and reset the
        touched-row bookkeeping.  The snapshot holds the live tables, which
        become shared: the updater's next write clones them first, so the
        published version never changes.  On a mesh it holds the assembled
        tables (new tensors on every rank).  The history is copied."""
        self.snapshots_taken += 1
        params, _ = self._assembled(with_state=False)

        def ids(rows: Set[int]) -> np.ndarray:
            return np.fromiter(sorted(rows), np.int64, len(rows))

        snap = PublishSnapshot(
            params=params,
            t_p=self.t_p,
            t_q=self.t_q,
            touched_users=ids(self._touched_users),
            touched_items=ids(self._touched_items),
            touched_implicit_items=ids(self._touched_implicit),
            user_history=None if self.user_history is None else self.user_history.copy(),
            full_rebuild=self._layout_dirty,
            events_seen=self.events_seen,
            snapshot_id=self.snapshots_taken,
            user_remap=None if self.evictor is None else self.evictor.remap.as_array(),
            remap_epoch=0 if self.evictor is None else self.evictor.remap.epoch,
        )
        if self.mesh is None:
            self._shared_params = set(_FIELDS)
        self._touched_users.clear()
        self._touched_items.clear()
        self._touched_implicit.clear()
        self._layout_dirty = False
        return snap

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, ds, batch_size: int = 8192) -> float:
        """Test MAE (Eq. 12) of the current online params and thresholds;
        one host sync at the end.

        With an evictor attached the dataset's user ids are external: live
        users score through their physical rows, spilled and unseen users
        bias-only (global mean + item bias for the bias variants, else 0),
        the engine's fallback; evaluation never revives rows.
        """
        if self.evictor is not None:
            return self._evaluate_remapped(ds, batch_size)
        params, _ = self._assembled(with_state=False)
        total = self._scalar(0.0)
        count = self._scalar(0.0)
        for batch_np in loader.iterate_batches(
            ds, min(batch_size, max(len(ds), 1)), shuffle=False,
            drop_remainder=False, hist=self.user_history,
        ):
            batch = {key: torch.as_tensor(value).to(self.device) for key, value in batch_np.items()}
            if "hist" in batch:
                batch["hist"] = batch["hist"].long()
            s, c = mf.eval_mae(params, batch, self.t_p, self.t_q)
            total = total + s
            count = count + c
        return float(total) / max(float(count), 1.0)

    def _evaluate_remapped(self, ds, batch_size: int) -> float:
        """:meth:`evaluate` under the eviction remap, summed in host float64
        as the reference sums it (a sync per batch)."""
        remap = self.evictor.remap
        item_bias = (None if self.params.item_bias is None
                     else self.params.item_bias[:, 0].cpu().numpy().astype(np.float64))
        total, count = 0.0, 0.0
        for batch_np in loader.iterate_batches(
            ds, min(batch_size, max(len(ds), 1)), shuffle=False, drop_remainder=False,
        ):
            users = np.asarray(batch_np["user"], np.int64)
            items = np.asarray(batch_np["item"], np.int64)
            phys = remap.lookup(users)
            live = phys >= 0
            pred, _ = mf.predict_pairs(
                self.params, self._upload(np.where(live, phys, 0), torch.int64),
                self._upload(items, torch.int64), self.t_p, self.t_q)
            pred = pred.cpu().numpy().astype(np.float64)
            fallback = np.zeros(users.shape, np.float64)
            if self.params.global_mean is not None:
                fallback += float(self.params.global_mean)
            if item_bias is not None:
                fallback += item_bias[items]
            pred = np.where(live, pred, fallback)
            w = batch_np.get("weight")
            w = np.ones(users.shape, np.float64) if w is None else np.asarray(w, np.float64)
            rating = np.asarray(batch_np["rating"], np.float64)
            total += float((np.abs(rating - pred) * w).sum())
            count += float(w.sum())
        return total / max(count, 1.0)
