"""Batched top-k recommendation engine over a trained DP-MF model.

Counterpart of ``repro/serving/engine.py``.  The engine:

* **loads once, serves many**: per-item effective ranks ``r_i``, item biases
  and per-user constants are computed at load, the scoring layouts on first
  use;
* **never materializes (B, n)**: on CUDA every request batch goes through the
  hand-written ``pruned_topk`` kernel, which reads the raw factors and ranks
  (no padded copy); on the CPU through the plain streaming merge over
  rank-masked item tiles;
* **micro-batches**: request batches are padded to power-of-two buckets
  (``serving/batching.py``), chunked at ``max_batch``;
* **caches hot users**: SVD++ user vectors go through an LRU;
* **pipelines requests**: ``submit()`` hands a request to the continuous
  batching queue (``serving/queue.py``) and returns a future;
* **hot-swaps factor versions**: :meth:`ServingEngine.swap` publishes a new
  ``(params, t_p, t_q)`` snapshot without dropping requests.  Everything
  derived from a version (ranks, layouts, user constants, the hot-user LRU)
  lives in a per-version :class:`_Snapshot`, and every scoring batch
  captures the current snapshot once, so a batch in flight finishes on its
  version bit for bit.  A swap that names its touched item rows (thresholds
  and catalog unchanged) builds the next version's ranks and CPU tiles as
  clones of the previous ones with only those rows rewritten, never
  writing into a tensor the previous snapshot holds;
* **serves evicted users**: with an eviction remap, request ids are external
  ids mapped to physical rows; a spilled user gets the bias-only
  :meth:`_Snapshot.fallback_topk` ranking;
* **shards both operand axes**: :meth:`ServingEngine.topk_sharded` runs
  SPMD on a ``torch.distributed`` mesh (every rank calls it with the same
  request): each rank scores its data shard's slab of the request's users
  against its ``"model"`` slab of the catalog (the ``pruned_topk`` kernel
  on CUDA), one all-gather of the (b, topk) winners over ``"model"`` and a
  merge follow, then one all-gather over the data axes hands every rank
  the whole answer.

Scores returned are full model scores: user and global biases are added on
the host after ranking, since a per-user constant never changes the order.
"""
from __future__ import annotations

import threading
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.core import mf
from repro_torch.core.ranks import effective_ranks, rank_mask
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.pruned_topk import (
    pruned_topk_ranked,
    stream_topk_tiles,
    tile_catalog,
)
from repro_torch.serving.batching import LRUCache, bucket_size

# Catalog slabs of the sharded top-k are whole multiples of this many rows
# (the reference pads to its kernel's item block, TOPK_BLOCK_N); padding
# rows carry rank 0 and a -inf bias, so they never win.
SLAB_ROWS = 256


def load_mf_checkpoint(
    directory: str, *, step: Optional[int] = None, device: DeviceLike = None
) -> Tuple[mf.MFParams, torch.Tensor, torch.Tensor, Optional[torch.Tensor], dict]:
    """Load a DP-MF trainer checkpoint for serving, onto ``device``.

    Restores the full ``MFParams`` (biases, global mean and SVD++ implicit
    factors when the checkpoint has them).  Returns
    ``(params, t_p, t_q, perm, metadata)``; missing thresholds are 0.
    """
    dev = resolve_device(device)
    data, meta = ckpt_lib.load_raw(directory, step)
    params = mf.params_from_flat(data, device=dev)

    def threshold(key):
        value = np.float32(data[key]) if key in data else np.float32(0.0)
        return torch.tensor(value, dtype=torch.float32, device=dev)

    perm = torch.as_tensor(data["perm"]).to(dev) if "perm" in data else None
    return params, threshold("t_p"), threshold("t_q"), perm, meta


def _id_array(ids) -> Optional[np.ndarray]:
    """int64 numpy copy of a touched-row set (array, tensor or any
    iterable, one-shot iterators included); None stays None."""
    if ids is None:
        return None
    if isinstance(ids, torch.Tensor):
        return ids.cpu().numpy().astype(np.int64).reshape(-1)
    if not isinstance(ids, np.ndarray):
        ids = list(ids)
    return np.asarray(ids, np.int64).reshape(-1)


class _Snapshot:
    """One factor version plus everything derived from it.

    Scoring captures ``engine._snap`` once per request batch, so a swap (a
    plain attribute store, atomic under the GIL) can flip versions while
    requests are in flight: a batch that started on version v finishes on
    version v.  Layouts are built lazily under ``_build_lock`` and carried
    (or patched into new tensors) across swaps."""

    def __init__(
        self,
        version: int,
        params: mf.MFParams,
        t_p,
        t_q,
        *,
        device: torch.device,
        block_n: int,
        cache: LRUCache,
        user_history: Optional[np.ndarray],
        r_i: Optional[torch.Tensor] = None,
        user_const: Optional[np.ndarray] = None,
        compact_latent: bool = False,
        user_remap: Optional[np.ndarray] = None,
        remap_epoch: int = 0,
    ):
        self.version = version
        self.params = params
        self.device = device
        self.t_p = torch.as_tensor(t_p, dtype=torch.float32).to(device)
        self.t_q = torch.as_tensor(t_q, dtype=torch.float32).to(device)
        self.num_users, self.k = params.p.shape
        self.n_items = params.q.shape[0]
        self.block_n = block_n
        self.cache = cache
        self.user_history = user_history
        self.compact_latent = compact_latent
        # Eviction remap: request ids are external, user_remap[ext] is the
        # physical row or -1 (spilled).  None: ids are physical rows.
        self.user_remap = None if user_remap is None else np.asarray(user_remap, np.int32)
        self.remap_epoch = int(remap_epoch)
        self.num_external = (
            self.num_users if self.user_remap is None else int(self.user_remap.shape[0])
        )
        self._fallback_topk = {}  # topk -> (scores, idx) for spilled users

        # r_i and the user constants accept values patched from the previous
        # snapshot at the touched rows (incremental swap); the item biases
        # are a view of this version's own table
        self.r_i = effective_ranks(params.q, self.t_q) if r_i is None else r_i
        if params.item_bias is not None:
            self.item_bias_vec = params.item_bias[:, 0].float().contiguous()
        else:
            self.item_bias_vec = torch.zeros((self.n_items,), dtype=torch.float32, device=device)
        # per-user additive constant, folded in after top-k on the host
        if user_const is not None:
            self.user_const = user_const
        elif params.user_bias is not None:
            self.user_const = (params.user_bias[:, 0].float() + params.global_mean).cpu().numpy()
        else:
            self.user_const = None
        self._stream_layout = None
        self._kernel_layout = None
        self._shard_slabs = {}   # (mesh shape, names, model index) -> kernel slab
        self._build_lock = threading.Lock()

    # -- spilled-user fallback ----------------------------------------------
    def fallback_topk(self, topk: int) -> Tuple[np.ndarray, np.ndarray]:
        """Bias-only top-k for spilled (evicted) users: ``global_mean +
        item_bias`` for the bias variants, zeros for funk, in a stable
        descending order, so ties (all of funk's items) go to the lower
        index as ``lax.top_k`` sends them.  Built once per (snapshot, topk):
        every spilled user gets the same row."""
        with self._build_lock:
            got = self._fallback_topk.get(topk)
            if got is None:
                scores = self.item_bias_vec.float()
                if self.params.global_mean is not None:
                    scores = scores + self.params.global_mean.float()
                s, i = torch.sort(scores, descending=True, stable=True)
                got = (
                    s[:topk].cpu().numpy().astype(np.float32),
                    i[:topk].to(torch.int32).cpu().numpy(),
                )
                self._fallback_topk[topk] = got
            return got

    # -- layouts -------------------------------------------------------------
    def _compact_k(self) -> int:
        """Latent columns the streaming layout keeps under ``compact_latent``:
        masked item rows are zero past their ranks, so columns past
        ``max(r_i)`` are zero for the whole catalog.  Rounded up to a
        multiple of 8; the full ``k`` at ``t_q == 0``."""
        if not self.compact_latent or float(self.t_q) <= 0.0:
            return self.k
        r_max = max(int(self.r_i.max()), 1) if self.n_items else self.k
        return min(self.k, ((r_max + 7) // 8) * 8)

    def stream_layout(self):
        """Rank-masked float32 item tiles of the plain (CPU) path, narrowed
        to :meth:`_compact_k` columns under ``compact_latent``."""
        with self._build_lock:
            if self._stream_layout is None:
                qm = self.params.q.float() * rank_mask(self.r_i, self.k)
                k_eff = self._compact_k()
                if k_eff < self.k:
                    qm = qm[:, :k_eff].contiguous()
                self._stream_layout = tile_catalog(qm, self.item_bias_vec, self.block_n)
            return self._stream_layout

    def kernel_layout(self):
        """Operands of the CUDA kernel: raw float32 factors, ranks, biases
        (no copy when ``q`` is already contiguous float32; never compacted)."""
        with self._build_lock:
            if self._kernel_layout is None:
                self._kernel_layout = (
                    self.params.q.float().contiguous(), self.r_i, self.item_bias_vec,
                )
            return self._kernel_layout

    def kernel_shard_slab(self, mesh):
        """This rank's slab of the kernel operands ``(q, r_i, bias)`` for the
        sharded top-k, and the slab's row count: the catalog padded to a
        multiple of ``SLAB_ROWS x n_model`` rows (rank 0, -inf bias) and
        split over ``"model"``.  Only this rank's rows are made (views where
        they lie inside the catalog).  One slab per mesh layout."""
        from repro_torch.distributed import sharding, spmd

        n_model = spmd.axis_size(mesh, "model")
        key = (tuple(mesh.shape), spmd.axis_names(mesh), spmd.axis_index(mesh, "model"))
        q, r_i, bias = self.kernel_layout()
        with self._build_lock:
            if key not in self._shard_slabs:
                mult = SLAB_ROWS * n_model
                rows = -(-self.n_items // mult) * mult
                spec = sharding.P("model", None)
                self._shard_slabs[key] = (
                    sharding.block(q, spec, mesh, pad_rows=rows, fill=0.0),
                    sharding.block(r_i, spec[:1], mesh, pad_rows=rows, fill=0),
                    sharding.block(bias, spec[:1], mesh, pad_rows=rows, fill=float("-inf")),
                    rows // n_model,
                )
            return self._shard_slabs[key]

    # -- incremental rebuilds (hot-swap fast path) ---------------------------
    def layouts_view(self):
        """The built layouts, read under the build lock: the swap thread
        reads them while a scoring thread may still be building into this
        (previous) snapshot."""
        with self._build_lock:
            return self._stream_layout, self._kernel_layout

    def clone_layouts_from(self, prev: "_Snapshot", rows: torch.Tensor) -> bool:
        """Carry ``prev``'s built layouts to this snapshot with only the item
        rows ``rows`` (int64 ids on the device; repeats allowed) rewritten,
        valid only when thresholds, catalog size and latent order are
        unchanged (the caller checks).  The CPU tiles are cloned and
        patched, so ``prev``'s stay as they were; the kernel layout holds
        this snapshot's own ``q``, ranks and biases.

        Returns False (the caller rebuilds) when a compacted streaming
        layout is narrower than a touched row's new rank."""
        stream, kernel = prev.layouts_view()
        if stream is not None:
            q_tiles, b_tiles, offs = stream
            r_rows = self.r_i[rows]
            kc = q_tiles.shape[2]
            if kc < self.k and int(r_rows.max()) > kc:
                return False
            qm_rows = self.params.q[rows].float() * rank_mask(r_rows, self.k)
            t_idx, slot = rows // q_tiles.shape[1], rows % q_tiles.shape[1]
            q_tiles, b_tiles = q_tiles.clone(), b_tiles.clone()
            q_tiles[t_idx, slot] = qm_rows[:, :kc]
            b_tiles[t_idx, slot] = self.item_bias_vec[rows]
            self._stream_layout = (q_tiles, b_tiles, offs)
        if kernel is not None:
            self.kernel_layout()
        return True

    def build_like(self, prev: "_Snapshot") -> None:
        """Build every layout ``prev`` had built (the full-rebuild path), so
        the first request after the swap does not pay for it."""
        stream, kernel = prev.layouts_view()
        if stream is not None:
            self.stream_layout()
        if kernel is not None:
            self.kernel_layout()


class ServingEngine:
    """Load a DP-MF model once; answer batched top-k requests forever.

    Runs on ``device`` (default ``cuda``; ``"cpu"`` selects the plain PyTorch
    path), moving ``params`` there.  ``max_batch`` caps a scoring launch;
    larger requests are chunked.  ``block_n`` sizes the item tiles of the
    CPU path only.  Top-k entry points return ``(scores, indices)`` numpy
    arrays, scores descending, ties to the lower item index.

    ``compact_latent=True`` narrows the CPU path's tiles to the catalog's
    largest item rank (rounded up to 8) when ``t_q > 0``, so a tighter
    threshold saves real work there; scores may then differ from the
    full-width path by reduction-order ulps.  The CUDA kernel reads each
    row only to its rank anyway and is never narrowed.  ``user_remap`` and
    ``remap_epoch`` arm the eviction remap (see :meth:`swap`).
    """

    def __init__(
        self,
        params: mf.MFParams,
        t_p=0.0,
        t_q=0.0,
        *,
        device: DeviceLike = None,
        max_batch: int = 256,
        block_n: int = 1024,
        cache_size: int = 4096,
        user_history: Optional[np.ndarray] = None,
        allow_missing_history: bool = False,
        compact_latent: bool = False,
        user_remap: Optional[np.ndarray] = None,
        remap_epoch: int = 0,
    ):
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.block_n = block_n
        self.cache_size = cache_size
        self.compact_latent = compact_latent
        params = self._on_device(params)
        history = self._resolve_history(params, user_history, allow_missing_history)
        cache = LRUCache(cache_size if params.implicit is not None else 0)
        self._snap = _Snapshot(
            0, params, t_p, t_q, device=self.device, block_n=block_n,
            cache=cache, user_history=history, compact_latent=compact_latent,
            user_remap=user_remap, remap_epoch=remap_epoch,
        )
        self._queue = None  # async frontend, created by start()/submit()
        self._queue_lock = threading.Lock()  # guards _queue transitions
        self._stopping = False               # stop() drain in progress
        self._queue_mesh = None              # mesh of a leading sharded queue
        self._swap_lock = threading.Lock()   # serializes swap() builders

    def _on_device(self, params: mf.MFParams) -> mf.MFParams:
        return mf.MFParams(*(None if v is None else v.to(self.device) for v in params))

    @staticmethod
    def _resolve_history(params, user_history, allow_missing_history):
        history = None if user_history is None else np.asarray(user_history)
        if params.implicit is not None and history is None:
            if not allow_missing_history:
                raise ValueError(
                    "SVD++ params need user_history, or pass "
                    "allow_missing_history=True to serve from p alone"
                )
            # every entry is the implicit table's padding row: vectors = p_u
            history = np.full((params.p.shape[0], 1), params.q.shape[0], np.int32)
        return history

    @classmethod
    def from_checkpoint(
        cls, directory: str, *, step: Optional[int] = None,
        device: DeviceLike = None, **kwargs,
    ) -> "ServingEngine":
        """Build an engine from a trainer checkpoint directory (full
        ``MFParams`` and the trained thresholds); ``kwargs`` pass to the
        constructor."""
        params, t_p, t_q, _, _ = load_mf_checkpoint(directory, step=step, device=device)
        return cls(params, t_p, t_q, device=device, **kwargs)

    # -- read-only state ----------------------------------------------------
    @property
    def version(self) -> int:
        """Version of the served snapshot (0 at load; each :meth:`swap`
        adds one)."""
        return self._snap.version

    @property
    def params(self) -> mf.MFParams:
        """Factor tables of the current snapshot."""
        return self._snap.params

    @property
    def t_p(self) -> torch.Tensor:
        """User-side pruning threshold."""
        return self._snap.t_p

    @property
    def t_q(self) -> torch.Tensor:
        """Item-side pruning threshold."""
        return self._snap.t_q

    @property
    def r_i(self) -> torch.Tensor:
        """(n,) per-item effective ranks."""
        return self._snap.r_i

    @property
    def num_users(self) -> int:
        """User-table rows (valid request ids are ``[0, num_users)``)."""
        return self._snap.num_users

    @property
    def num_external(self) -> int:
        """Size of the request id domain: :attr:`num_users` without an
        eviction remap, else the external-id domain (grow-only, even while
        compactions shrink the physical table)."""
        return self._snap.num_external

    @property
    def remap_epoch(self) -> int:
        """Compaction counter of the current snapshot's id remap (0 when no
        eviction was ever armed)."""
        return self._snap.remap_epoch

    @property
    def n_items(self) -> int:
        """Catalog size."""
        return self._snap.n_items

    @property
    def k(self) -> int:
        """Latent dimension."""
        return self._snap.k

    @property
    def user_history(self) -> Optional[np.ndarray]:
        """(m, H) SVD++ implicit-history matrix, or None."""
        return self._snap.user_history

    @property
    def vector_cache(self) -> LRUCache:
        """Hot-user vector LRU (zero capacity unless SVD++)."""
        return self._snap.cache

    # -- hot swap ------------------------------------------------------------
    def swap(
        self,
        params: mf.MFParams,
        t_p=None,
        t_q=None,
        *,
        touched_users: Optional[Iterable[int]] = None,
        touched_items: Optional[Iterable[int]] = None,
        touched_implicit_items: Optional[Iterable[int]] = None,
        user_history: Optional[np.ndarray] = None,
        user_remap: Optional[np.ndarray] = None,
        remap_epoch: Optional[int] = None,
    ) -> int:
        """Atomically publish a new factor version; returns its number.

        A batch in flight when the swap lands completes on the old snapshot;
        batches started afterwards score on the new one.  The new snapshot
        is built before the flip:

        * ``touched_items`` given, thresholds and catalog unchanged: item
          ranks are reduced for those rows only, and the ranks and CPU
          tiles are clones of the previous ones with those rows rewritten
          (the previous snapshot's tensors are never written);
        * otherwise (new thresholds, a permuted latent axis, a grown
          catalog): every layout in use is rebuilt.

        The hot-user LRU carries over minus the stale entries: the
        ``touched_users`` and, for SVD++, every cached user whose history
        holds a row of ``touched_implicit_items``/``touched_items``.
        ``touched_users=None`` drops the whole cache.

        Tables may grow, never shrink, except in an eviction compaction: a
        ``remap_epoch`` bump (with its ``user_remap``) may shrink the user
        table, external ids stay valid through the remap, and the swap takes
        the full rebuild with a fresh cache.  Omitting both remap arguments
        carries the previous remap forward.
        """
        # one-shot iterables are walked several times below
        touched_users = _id_array(touched_users)
        touched_items = _id_array(touched_items)
        touched_implicit_items = _id_array(touched_implicit_items)
        params = self._on_device(params)
        with self._swap_lock:
            prev = self._snap
            if remap_epoch is None:
                remap_epoch = prev.remap_epoch
                if user_remap is None:
                    user_remap = prev.user_remap
            remap_changed = int(remap_epoch) != prev.remap_epoch
            if remap_changed:
                # physical rows were renumbered: nothing of the previous
                # version can be patched
                if user_remap is None:
                    raise ValueError("a remap_epoch bump must carry its user_remap table")
                touched_users = touched_items = touched_implicit_items = None
            if not remap_changed and (
                params.p.shape[0] < prev.num_users or params.q.shape[0] < prev.n_items
            ):
                raise ValueError(
                    "swap cannot shrink the user/item tables "
                    f"({prev.num_users}x{prev.n_items} -> "
                    f"{params.p.shape[0]}x{params.q.shape[0]}): queued requests may "
                    "already reference the trailing rows (only an eviction "
                    "compaction, a remap_epoch bump, may shrink the user table)"
                )
            t_p = prev.t_p if t_p is None else t_p
            t_q = prev.t_q if t_q is None else t_q
            t_q_dev = torch.as_tensor(t_q, dtype=torch.float32).to(self.device)

            if user_history is None and prev.user_history is not None:
                user_history = self._grow_history(prev.user_history, params, prev.n_items)
            elif params.implicit is not None and user_history is None:
                user_history = self._resolve_history(params, None, True)

            same_geometry = (
                params.q.shape[0] == prev.n_items
                and params.p.shape[1] == prev.k
                and float(t_q_dev) == float(prev.t_q)
            )
            incremental = touched_items is not None and same_geometry
            rows = r_i_pre = user_const_pre = None
            if incremental:
                if touched_items.size:
                    # repeated ids rewrite a row with the same values, so
                    # they need no host-side unique (a sort of the ids on
                    # the host costs more than the whole device patch)
                    rows = torch.as_tensor(touched_items).to(self.device)
                    # a new tensor: the previous snapshot's stays as it is
                    r_i_pre = prev.r_i.clone()
                    r_i_pre[rows] = effective_ranks(params.q[rows], t_q_dev)
                else:
                    r_i_pre = prev.r_i
                user_const_pre = self._patch_user_const(prev, params, touched_users)

            new = _Snapshot(
                prev.version + 1, params, t_p, t_q_dev,
                device=self.device, block_n=self.block_n,
                cache=self._carry_cache(
                    prev, params, touched_users, touched_items,
                    touched_implicit_items, user_history,
                ),
                user_history=user_history,
                r_i=r_i_pre,
                user_const=user_const_pre,
                compact_latent=self.compact_latent,
                user_remap=user_remap,
                remap_epoch=int(remap_epoch),
            )
            if rows is not None:
                if not new.clone_layouts_from(prev, rows):
                    # a touched row's rank outgrew the compacted width: a
                    # patch would cut real factors, so rebuild at the new width
                    new._stream_layout = new._kernel_layout = None
                    new.build_like(prev)
            elif incremental:  # no item row touched: the layouts carry over
                new._stream_layout, new._kernel_layout = prev.layouts_view()
            else:
                new.build_like(prev)
            if self.device.type == "cuda":
                # publish a built double buffer, not queued work that the
                # first request would wait on
                torch.cuda.synchronize(self.device)
            self._snap = new  # atomic: in-flight batches hold `prev`
            return new.version

    @staticmethod
    def _patch_user_const(prev, params, touched_users) -> Optional[np.ndarray]:
        """User constants of an incremental swap: the previous (m,) vector
        with the touched and grown rows rewritten, or None (recompute) when a
        patch could be wrong: no bias term, no touched-user list, or a moved
        global mean."""
        if params.user_bias is None or prev.user_const is None or touched_users is None:
            return None
        if (prev.params.global_mean is None
                or float(params.global_mean) != float(prev.params.global_mean)):
            return None
        m_new = params.p.shape[0]
        tu = np.asarray(touched_users, np.int64)
        if m_new > prev.num_users:
            # grown rows are rewritten whether or not the caller listed them
            tu = np.concatenate([tu, np.arange(prev.num_users, m_new, dtype=np.int64)])
        uc = np.empty((m_new,), np.float32)
        uc[: prev.num_users] = prev.user_const
        if tu.size:
            rows = torch.as_tensor(tu).to(params.p.device)
            uc[tu] = (params.user_bias[rows, 0].float() + params.global_mean).cpu().numpy()
        return uc

    @staticmethod
    def _grow_history(history, params, old_n_items):
        """Pad the history matrix for grown user tables and move the padding
        sentinel (the old catalog size) when the item table grew under it."""
        new_m = params.p.shape[0]
        new_n = params.q.shape[0]
        out = history
        if new_n != old_n_items and params.implicit is not None:
            out = out.copy()
            out[out == old_n_items] = new_n
        if new_m > history.shape[0]:
            pad_rows = np.full(
                (new_m - history.shape[0], history.shape[1]),
                new_n if params.implicit is not None else old_n_items,
                history.dtype,
            )
            out = np.concatenate([out, pad_rows], axis=0)
        return out

    def _carry_cache(
        self, prev, params, touched_users, touched_items,
        touched_implicit_items, user_history,
    ) -> LRUCache:
        """Hot-user LRU of the next snapshot: the previous entries minus the
        stale ones (the previous cache itself is not touched)."""
        capacity = self.cache_size if params.implicit is not None else 0
        if capacity != prev.cache.capacity or touched_users is None:
            return LRUCache(capacity)
        stale = set(int(u) for u in touched_users)
        if params.implicit is not None:
            # an SVD++ vector folds in its history's implicit rows: a cached
            # user whose history holds a touched row is stale too.  Only the
            # cached users are scanned.
            items = set(int(i) for i in (() if touched_items is None else touched_items))
            items |= set(int(i) for i in (
                () if touched_implicit_items is None else touched_implicit_items))
            cached = [u for u in prev.cache.keys() if u not in stale]
            if items and cached and user_history is not None:
                hit = np.isin(
                    user_history[np.asarray(cached, np.int64)],
                    np.fromiter(items, np.int64, len(items)),
                ).any(axis=1)
                stale |= set(int(u) for u, h in zip(cached, hit) if h)
        return prev.cache.copy_without(stale)


    # -- user vectors --------------------------------------------------------
    def _user_vectors(self, snap: _Snapshot, user_ids: np.ndarray) -> torch.Tensor:
        """(B, k) user vectors: plain rows, or SVD++ history-aggregated rows
        memoized per user in the LRU."""
        if snap.params.implicit is None:
            idx = torch.as_tensor(user_ids, dtype=torch.long).to(snap.device)
            return snap.params.p[idx]
        rows = [snap.cache.get(int(u)) for u in user_ids]
        missing = [i for i, r in enumerate(rows) if r is None]
        if missing:
            miss_ids = np.asarray([user_ids[i] for i in missing], np.int64)
            hist = torch.as_tensor(snap.user_history[miss_ids], dtype=torch.long)
            fresh = mf._user_vector(
                snap.params,
                torch.as_tensor(miss_ids).to(snap.device),
                hist.to(snap.device),
            )
            for slot, row in zip(missing, fresh):
                rows[slot] = row
                snap.cache.put(int(user_ids[slot]), row)
        return torch.stack(rows)

    # -- scoring -------------------------------------------------------------
    def _topk_block(self, snap: _Snapshot, pu: torch.Tensor, topk: int):
        r_u = effective_ranks(pu, snap.t_p)
        if pu.is_cuda:
            q, r_i, bias = snap.kernel_layout()
            return pruned_topk_ranked(pu.float().contiguous(), q, r_u, r_i, bias, topk)
        q_tiles, b_tiles, offs = snap.stream_layout()
        pm = pu.float() * rank_mask(r_u, snap.k)
        if q_tiles.shape[2] < pm.shape[1]:
            # latent-compacted layout: user columns past the catalog's
            # largest rank only ever multiply zeros
            pm = pm[:, : q_tiles.shape[2]]
        return stream_topk_tiles(pm, q_tiles, b_tiles, offs, topk=topk)

    def _validate_request(self, user_ids, topk: int) -> np.ndarray:
        return self._validate_for(self._snap, user_ids, topk)

    @staticmethod
    def _validate_for(snap: _Snapshot, user_ids, topk: int) -> np.ndarray:
        if not 0 < topk <= snap.n_items:
            raise ValueError(f"topk must be in [1, {snap.n_items}], got {topk}")
        ids = np.asarray(user_ids, np.int64).reshape(-1)
        # checked on the host before any gather: an out-of-range index on
        # CUDA is a device-side assert that poisons the context.  With an
        # eviction remap the request domain is the external ids.
        bad = (ids < 0) | (ids >= snap.num_external)
        if bad.any():
            raise ValueError(
                f"unknown user ids {ids[bad][:5].tolist()} "
                f"(catalog has {snap.num_external} users)"
            )
        return ids

    @staticmethod
    def _translate_ids(
        snap: _Snapshot, ids: np.ndarray
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """External ids to physical rows under the snapshot's remap:
        ``(physical_ids, evicted_mask or None)``.  Evicted users point at
        row 0, are scored, and their rows are then overwritten by
        :meth:`_Snapshot.fallback_topk`."""
        if snap.user_remap is None:
            return ids, None
        phys = snap.user_remap[ids].astype(np.int64)
        evicted = phys < 0
        if not evicted.any():
            return phys, None
        return np.where(evicted, 0, phys), evicted

    @staticmethod
    def _apply_fallback(snap, evicted, topk, out_s, out_i):
        if evicted is not None:
            fs, fi = snap.fallback_topk(topk)
            out_s[evicted] = fs
            out_i[evicted] = fi
        return out_s, out_i

    def _run_chunked(self, snap: _Snapshot, ids: np.ndarray, topk: int, block_fn=None):
        """Split into max_batch chunks, pad each chunk to its power-of-two
        bucket, score (``block_fn(pu, topk)``, default the local path),
        fold the user constants back in."""
        block_fn = block_fn or (lambda pu, k_: self._topk_block(snap, pu, k_))
        out_s = np.empty((len(ids), topk), np.float32)
        out_i = np.empty((len(ids), topk), np.int32)
        for lo in range(0, len(ids), self.max_batch):
            chunk = ids[lo : lo + self.max_batch]
            bucket = bucket_size(len(chunk), self.max_batch)
            padded = np.pad(chunk, (0, bucket - len(chunk)), mode="edge")
            pu = self._user_vectors(snap, padded)
            scores, idx = block_fn(pu, topk)
            scores = scores[: len(chunk)].cpu().numpy()
            idx = idx[: len(chunk)].cpu().numpy()
            if snap.user_const is not None:
                scores = scores + snap.user_const[chunk][:, None]
            out_s[lo : lo + len(chunk)] = scores
            out_i[lo : lo + len(chunk)] = idx
        return out_s, out_i

    def topk(self, user_ids, topk: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k items for a batch of users: ``(scores, indices)`` as
        (B, topk) numpy arrays, identical to dense score-and-stable-sort."""
        snap = self._snap  # captured once: the whole batch serves one version
        ids = self._validate_for(snap, user_ids, topk)
        if ids.size == 0:
            return np.empty((0, topk), np.float32), np.empty((0, topk), np.int32)
        phys, evicted = self._translate_ids(snap, ids)
        out_s, out_i = self._run_chunked(snap, phys, topk)
        return self._apply_fallback(snap, evicted, topk, out_s, out_i)

    # -- sharded catalog -----------------------------------------------------
    def topk_sharded(self, user_ids, topk: int = 10, *, mesh=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Mesh-sharded top-k, SPMD: every rank of ``mesh`` (a
        ``DeviceMesh`` with a ``"model"`` dim, and ``"data"``/``"pod"``
        where present) calls it with the same ``user_ids``, and every rank
        returns the whole ``(scores, indices)``, equal to :meth:`topk`'s.

        Requests go through :meth:`topk`'s chunk/bucket loop; each bucket is
        padded to :func:`~repro_torch.distributed.sharding.serving_row_multiple`
        and split over the data axes.  A rank scores its user slab against
        its catalog slab (:meth:`_Snapshot.kernel_shard_slab`) through
        ``pruned_topk_ranked`` (the kernel on CUDA, the plain version on the
        CPU), offsets the indices by its model coordinate times the slab's
        rows, and :func:`_merge_over_model` keeps the best ``topk`` of the
        ``"model"`` ranks' winners, ties to the lower item index; one
        all-gather over the data axes assembles the batch.  The collective
        traffic is O(b * topk), independent of the catalog.  Evicted users
        get the fallback ranking, as in :meth:`topk`."""
        from repro_torch.distributed import sharding, spmd

        if mesh is None or "model" not in spmd.axis_names(mesh):
            raise ValueError("topk_sharded needs a mesh with a 'model' axis")
        snap = self._snap
        ids = self._validate_for(snap, user_ids, topk)
        if ids.size == 0:
            return np.empty((0, topk), np.float32), np.empty((0, topk), np.int32)
        ids, evicted = self._translate_ids(snap, ids)
        q, r_i, bias, n_loc = snap.kernel_shard_slab(mesh)
        offset = spmd.axis_index(mesh, "model") * n_loc
        row_mult = sharding.serving_row_multiple(mesh)
        (user_spec, *_), (out_spec, _) = sharding.serving_topk_kernel_specs(mesh)

        def block_fn(pu, k_):
            b = pu.shape[0]
            pm = pu.float()
            pad = (-b) % row_mult  # equal user slabs per data shard
            if pad:
                pm = torch.cat([pm, pm.new_zeros((pad, pm.shape[1]))])
            pu_blk = sharding.block(pm, user_spec, mesh).contiguous()
            r_u = effective_ranks(pu_blk, snap.t_p)
            local_s, local_i = pruned_topk_ranked(pu_blk, q, r_u, r_i, bias, k_)
            merged_s, merged_i = _merge_over_model(local_s, local_i + offset, mesh, k_)
            scores = sharding.assemble(merged_s, out_spec, mesh)
            idx = sharding.assemble(merged_i, out_spec, mesh)
            return scores[:b], idx[:b]

        out_s, out_i = self._run_chunked(snap, ids, topk, block_fn)
        return self._apply_fallback(snap, evicted, topk, out_s, out_i)

    # -- async frontend ------------------------------------------------------
    def start(self, *, mesh=None, **queue_kwargs):
        """Start the async request pipeline; returns the
        :class:`~repro_torch.serving.queue.RequestQueue` (kwargs such as
        ``max_batch``, ``max_pending``, ``linger_ms`` pass through).
        Restartable after :meth:`stop`.

        With ``mesh`` (spanning every rank of the default process group) the
        queue scores through :meth:`topk_sharded`.  The queue forms its
        batches by time, so only the mesh's first rank runs one: each of its
        batches is broadcast to the other ranks, whose ``start(mesh=)``
        returns None and runs a follower thread that scores every broadcast
        batch with it, until the first rank's :meth:`stop`.  While the queue
        runs, the ranks run no other collective."""
        with self._queue_lock:
            return self._start_locked(mesh=mesh, **queue_kwargs)

    def _start_locked(self, *, mesh=None, **queue_kwargs):
        from repro_torch.serving.queue import RequestQueue

        if self._queue is not None:
            if not self._queue.closed:
                raise RuntimeError("engine already has a running request queue")
            self._queue = None  # stale handle: queue was closed directly
        score_fn = None
        if mesh is not None:
            import torch.distributed as dist

            if dist.get_rank() != 0:
                self._queue = _ShardFollower(self, mesh)
                return None
            score_fn = lambda users, k: self._lead_sharded(users, k, mesh)  # noqa: E731
        self._queue = RequestQueue(self, score_fn=score_fn, **queue_kwargs)
        self._queue_mesh = mesh
        return self._queue

    def _lead_sharded(self, users, topk: int, mesh):
        """The first rank's scoring under ``start(mesh=)``: announce the
        batch to the followers, then score it with them."""
        _broadcast_batch(np.asarray(users, np.int64), topk, self.device)
        return self.topk_sharded(users, topk, mesh=mesh)

    def submit(self, user_id: int, topk: int = 10, *, timeout=None, priority: int = 0):
        """Async single-user request: a ``concurrent.futures.Future``
        resolving to ``(scores, item_ids)``, byte-identical to the caller's
        row of :meth:`topk`.  Starts a default queue on first use; rejected
        with ``RuntimeError`` while :meth:`stop` drains."""
        with self._queue_lock:
            if self._stopping:
                raise RuntimeError("engine is stopping; request rejected")
            if self._queue is None or self._queue.closed:
                self._start_locked()
            queue = self._queue
        return queue.submit(user_id, topk, timeout=timeout, priority=priority)

    @property
    def queue_depth(self) -> int:
        """Requests queued or being scored by the async frontend."""
        with self._queue_lock:
            queue = self._queue
        return 0 if queue is None or queue.closed else queue.depth

    def stop(self) -> None:
        """Drain and stop the async pipeline: every accepted request
        completes before this returns.  Idempotent."""
        with self._queue_lock:
            if self._stopping:
                return  # another thread's stop() owns the drain
            queue, self._queue = self._queue, None
            self._stopping = True
        try:
            if queue is not None:
                queue.close()  # outside the lock: close() joins the scheduler
                if self._queue_mesh is not None:
                    self._queue_mesh = None
                    _broadcast_batch(None, 0, self.device)   # releases the followers
        finally:
            with self._queue_lock:
                self._stopping = False

    # -- convenience ---------------------------------------------------------
    def recommend(self, user_ids, topk: int = 10):
        """JSON-friendly form: list of per-user [{item, score}, ...]."""
        scores, idx = self.topk(user_ids, topk)
        return [
            [{"item": int(i), "score": round(float(s), 4)} for i, s in zip(row_i, row_s)]
            for row_i, row_s in zip(idx, scores)
        ]


def _merge_over_model(local_s: torch.Tensor, local_i: torch.Tensor, mesh, topk: int):
    """Cross-shard merge of per-shard (b, topk) winners: one all-gather over
    ``"model"``, then the best ``topk`` of the ``n_model * topk``
    candidates by a stable descending sort over the shard-major candidate
    order, so ties go to the lower item index as ``lax.top_k`` sends them."""
    from repro_torch.distributed import spmd

    b = local_s.shape[0]
    gs = spmd.all_gather(local_s, mesh, "model").reshape(-1, b, topk)
    gi = spmd.all_gather(local_i, mesh, "model").reshape(-1, b, topk)
    cand_s = gs.permute(1, 0, 2).reshape(b, -1)
    cand_i = gi.permute(1, 0, 2).reshape(b, -1)
    merged_s, sel = torch.sort(cand_s, dim=1, descending=True, stable=True)
    return merged_s[:, :topk], torch.gather(cand_i, 1, sel[:, :topk])


def _broadcast_batch(users: Optional[np.ndarray], topk: int, device: torch.device):
    """Broadcast one batch header and its user ids from rank 0 over the
    default process group; ``users=None`` on rank 0 sends the stop header.
    Returns ``(users, topk)`` on every rank (``(None, 0)`` for a stop)."""
    import torch.distributed as dist

    on = device if dist.get_backend() == "nccl" else torch.device("cpu")
    head = torch.zeros(2, dtype=torch.int64, device=on)
    if dist.get_rank() == 0 and users is not None:
        head[0], head[1] = len(users), topk
    dist.broadcast(head, 0)
    n, k = int(head[0]), int(head[1])
    if k == 0:
        return None, 0
    ids = (torch.as_tensor(users, dtype=torch.int64).to(on) if dist.get_rank() == 0
           else torch.empty(n, dtype=torch.int64, device=on))
    dist.broadcast(ids, 0)
    return ids.cpu().numpy(), k


class _ShardFollower:
    """A non-first rank's side of ``start(mesh=)``: a thread that scores
    every batch the first rank broadcasts, until the stop header."""

    def __init__(self, engine: "ServingEngine", mesh):
        self.closed = False
        self.depth = 0
        self._thread = threading.Thread(target=self._loop, args=(engine, mesh),
                                        name="shard-follower", daemon=True)
        self._thread.start()

    def _loop(self, engine, mesh):
        try:
            while True:
                users, topk = _broadcast_batch(None, 0, engine.device)
                if users is None:
                    break
                engine.topk_sharded(users, topk, mesh=mesh)
        finally:
            self.closed = True

    def submit(self, *args, **kwargs):
        raise RuntimeError("requests go to the mesh's first rank")

    def close(self):
        self._thread.join()
