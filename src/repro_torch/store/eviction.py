"""Cold-row eviction and compaction: the bounded-memory contract for the
grow-only online user table.

Counterpart of ``repro/store/eviction.py``.  The online updater
(``online/updater.py``) grows P (and its biases and optimizer state) for
every cold-start user and never shrinks.  This module adds a watermark: when
the table passes ``max_users`` rows, the coldest rows are *spilled* to disk
and *compacted* out of the device tables.

Coldness order (most evictable first):

1. **last-touched step** ascending: rows no event has updated recently;
2. **per-row effective rank** ascending (``core/ranks.effective_ranks``):
   rows the pruned dot product truncates earliest are the cheapest to lose;
3. physical index ascending, so the order is total and the victims are the
   reference's ``np.lexsort((index, rank, last_touched))`` for any correct
   sort of the three keys.

Compaction renumbers the physical rows, so every layer that holds user ids
needs the **id remap** (:class:`IdRemap`): external (stream and request) ids
stay stable; ``ext_to_phys`` maps them to the current physical row, ``-1``
meaning spilled.  Each compaction bumps ``remap_epoch``: the publisher then
forces a ``kind=full`` payload and the engine rebuilds rather than patches.

Spilled rows come back when an event names their user: the factor row,
bias and optimizer-state rows are read from the spill file into freshly
grown physical rows, bitwise what was evicted.  A spilled user who is only
*scored* gets the engine's bias-only fallback; scoring never revives.

The spill files are the reference's: npz with ``ext_ids``,
``last_touched``, ``p``, ``user_bias`` (bias variants) and
``opt.<group>.<key>`` for every optimizer-state table with a row per user.

Tensors: compaction builds new tables (``p[keep]``) and never writes the
old ones, so a version the engine serves keeps its tensors as they were;
revival writes rows in place, after the updater's copy on write
(``OnlineUpdater._own_tables``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ranks import effective_ranks


@dataclasses.dataclass
class IdRemap:
    """External-id to physical-row translation table.

    ``ext_to_phys[e]`` is the physical row of external user ``e``, or -1 if
    the row is spilled.  ``epoch`` counts compactions: any bump invalidates
    every cached physical index downstream.
    """

    ext_to_phys: np.ndarray  # (n_external,) int32, -1 = spilled
    epoch: int = 0

    @property
    def num_external(self) -> int:
        """Size of the external id domain (grow-only)."""
        return int(self.ext_to_phys.shape[0])

    def lookup(self, ext_ids: np.ndarray) -> np.ndarray:
        """Translate external ids; unknown (never-seen) ids map to -1."""
        ext_ids = np.asarray(ext_ids, np.int64)
        phys = np.full(ext_ids.shape, -1, np.int64)
        known = (ext_ids >= 0) & (ext_ids < self.num_external)
        phys[known] = self.ext_to_phys[ext_ids[known]]
        return phys

    def as_array(self) -> np.ndarray:
        """Frozen copy for snapshots and payloads."""
        return np.array(self.ext_to_phys, np.int32, copy=True)


@dataclasses.dataclass
class EvictionConfig:
    """Watermark policy: evict down to ``target_users`` once the physical
    table exceeds ``max_users``; spilled rows land under ``spill_dir``."""

    max_users: int
    spill_dir: str
    target_users: Optional[int] = None  # default: 80% of max_users

    def resolved_target(self) -> int:
        target = (self.target_users if self.target_users is not None
                  else int(self.max_users * 0.8))
        if not 0 < target <= self.max_users:
            raise ValueError(
                f"target_users {target} must be in (0, max_users={self.max_users}]")
        return target


def _row_tables(state: Dict[str, torch.Tensor], m: int) -> Dict[str, torch.Tensor]:
    """The optimizer-state tables with a row per user (not step counters)."""
    return {key: value for key, value in state.items() if value.dim() >= 1 and value.shape[0] == m}


class UserEvictor:
    """Owns the remap table, the per-row touch clock, the spill files and
    the compaction pass for one
    :class:`~repro_torch.online.updater.OnlineUpdater`.

    Usage: ``updater.attach_evictor(UserEvictor(config))``; from then on the
    updater routes every batch through :meth:`resolve` (external ids to
    physical rows, with revival) and the driver calls :meth:`maybe_evict`
    at publish points.
    """

    def __init__(self, config: EvictionConfig):
        config.resolved_target()  # validate eagerly
        self.config = config
        self.updater = None
        self.remap: Optional[IdRemap] = None
        self.phys_to_ext: Optional[np.ndarray] = None
        self.last_touched: Optional[np.ndarray] = None
        self._step = 0
        self._spilled: Dict[int, Tuple[str, int]] = {}  # ext -> (file, row)
        self._spill_seq = 0
        self._spill_cache: Tuple[Optional[str], Optional[Dict]] = (None, None)
        self.evictions = 0          # rows spilled, lifetime
        self.revivals = 0           # rows brought back, lifetime
        self.compactions = 0        # remap-epoch bumps, lifetime

    def spilled_external_ids(self) -> np.ndarray:
        """External ids currently resident on disk (sorted)."""
        return np.array(sorted(self._spilled), dtype=np.int64)

    # -- wiring --------------------------------------------------------------
    def bind(self, updater) -> None:
        """Attach to an updater; the initial remap is the identity over the
        current physical table."""
        if updater.mesh is not None:
            raise ValueError(
                "eviction is a single-host feature: mesh-sharded tables "
                "must keep their row counts divisible over the mesh")
        if updater.params.implicit is not None:
            raise ValueError(
                "eviction does not support the SVD++ variant (per-user implicit "
                "history rows cannot be spilled independently)")
        os.makedirs(self.config.spill_dir, exist_ok=True)
        self.updater = updater
        m = updater.num_users
        self.remap = IdRemap(ext_to_phys=np.arange(m, dtype=np.int32))
        self.phys_to_ext = np.arange(m, dtype=np.int64)
        self.last_touched = np.zeros(m, np.int64)

    def _sync(self) -> None:
        """Track growth done outside :meth:`resolve` (direct
        ``ensure_capacity`` callers): appended rows are identity-mapped new
        external ids, touched now."""
        m = self.updater.num_users
        have = self.phys_to_ext.shape[0]
        if m > have:
            add = m - have
            new_ext = np.arange(self.remap.num_external, self.remap.num_external + add,
                                dtype=np.int64)
            self.remap.ext_to_phys = np.concatenate(
                [self.remap.ext_to_phys, np.arange(have, m, dtype=np.int32)])
            self.phys_to_ext = np.concatenate([self.phys_to_ext, new_ext])
            self.last_touched = np.concatenate(
                [self.last_touched, np.full(add, self._step, np.int64)])

    # -- the hot-path translation --------------------------------------------
    def resolve(self, ext_ids: np.ndarray) -> np.ndarray:
        """External ids to physical rows, for an *update*.

        Unseen ids get fresh physical rows (cold-start growth, the same
        draws as ``ensure_capacity``); spilled ids are revived from their
        spill records.  Every returned row's touch clock is advanced.
        """
        self._sync()
        ext_ids = np.asarray(ext_ids, np.int64)
        remap = self.remap
        max_ext = int(ext_ids.max()) if ext_ids.size else -1
        if max_ext >= remap.num_external:
            # extend the external domain as grow-only cold start does: every
            # id up to the max gets a fresh physical row
            add = max_ext + 1 - remap.num_external
            base = self.updater.num_users
            remap.ext_to_phys = np.concatenate(
                [remap.ext_to_phys, np.arange(base, base + add, dtype=np.int32)])
            self.phys_to_ext = np.concatenate([
                self.phys_to_ext,
                np.arange(remap.num_external - add, remap.num_external, dtype=np.int64)])
            self.updater.ensure_capacity(base + add - 1, -1)
            self.last_touched = np.concatenate(
                [self.last_touched, np.full(add, self._step, np.int64)])
        phys = remap.ext_to_phys[ext_ids].astype(np.int64)
        spilled = np.unique(ext_ids[phys < 0])
        if spilled.size:
            self._revive(spilled)
            phys = remap.ext_to_phys[ext_ids].astype(np.int64)
        self._step += 1
        self.last_touched[phys] = self._step
        return phys.astype(np.int32)

    # -- spill / revive ------------------------------------------------------
    def _row_states(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The user-row-indexed optimizer-state dicts, by group name."""
        opt = self.updater.opt_state
        groups = {"p": opt.p}
        if opt.user_bias is not None:
            groups["user_bias"] = opt.user_bias
        return groups

    def _spill(self, victims: np.ndarray) -> str:
        """Write the victims' rows to a new spill file; returns its path."""
        upd = self.updater
        m = upd.num_users
        idx = torch.as_tensor(victims, dtype=torch.int64).to(upd.device)
        payload: Dict[str, np.ndarray] = {
            "ext_ids": self.phys_to_ext[victims],
            "last_touched": self.last_touched[victims],
            "p": upd.params.p[idx].cpu().numpy(),
        }
        if upd.params.user_bias is not None:
            payload["user_bias"] = upd.params.user_bias[idx].cpu().numpy()
        for group, state in self._row_states().items():
            for key, value in _row_tables(state, m).items():
                payload[f"opt.{group}.{key}"] = value[idx].cpu().numpy()
        name = f"spill_{self._spill_seq:06d}.npz"
        self._spill_seq += 1
        path = os.path.join(self.config.spill_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
        for row, ext in enumerate(payload["ext_ids"]):
            self._spilled[int(ext)] = (path, row)
        self.evictions += victims.size
        return path

    def _load_spill(self, path: str) -> Dict[str, np.ndarray]:
        cached_path, cached = self._spill_cache
        if cached_path != path:
            with np.load(path) as data:
                cached = {key: data[key] for key in data.files}
            self._spill_cache = (path, cached)
        return cached

    def _revive(self, ext_ids: np.ndarray) -> None:
        """Grow fresh physical rows, then overwrite them with the spilled
        values: bitwise the rows that were evicted."""
        upd = self.updater
        n_new = int(ext_ids.size)
        base = upd.num_users
        upd.ensure_capacity(base + n_new - 1, -1)
        upd._own_tables()  # the rows below are written in place
        phys = np.arange(base, base + n_new, dtype=np.int64)
        self.phys_to_ext = np.concatenate([self.phys_to_ext, ext_ids])
        self.last_touched = np.concatenate(
            [self.last_touched, np.full(n_new, self._step, np.int64)])

        records = [self._spilled.pop(int(ext)) for ext in ext_ids]
        files = np.array([path for path, _ in records])
        rows = np.array([row for _, row in records], np.int64)
        stacked: Dict[str, np.ndarray] = {}
        for path in dict.fromkeys(files.tolist()):  # each spill file read once
            sel = files == path
            for key, value in self._load_spill(path).items():
                if key == "ext_ids":
                    continue
                if key not in stacked:
                    stacked[key] = np.empty((n_new,) + value.shape[1:], value.dtype)
                stacked[key][sel] = value[rows[sel]]

        dev = upd.device
        idx = torch.as_tensor(phys).to(dev)

        def put(table: torch.Tensor, key: str) -> None:
            table[idx] = torch.as_tensor(stacked[key]).to(dev, table.dtype)

        put(upd.params.p, "p")
        if "user_bias" in stacked:
            put(upd.params.user_bias, "user_bias")
        for group, state in self._row_states().items():
            for key, value in state.items():
                if f"opt.{group}.{key}" in stacked:
                    put(value, f"opt.{group}.{key}")
        self.remap.ext_to_phys[ext_ids] = phys.astype(np.int32)
        self.revivals += n_new

    # -- the watermark pass --------------------------------------------------
    def maybe_evict(self) -> Optional[Dict[str, float]]:
        """Spill and compact down to the target if past the watermark.

        Returns a report when a compaction ran (the caller should publish
        soon after: the updater's next snapshot is a full rebuild and
        carries the bumped ``remap_epoch``), else None.  The report times
        its parts in ms: ``ranks_ms`` (the device ranks read back),
        ``sort_ms`` (the host lexsort), ``spill_ms`` (rows read back and the
        npz written, ``spill_bytes``) and ``compact_ms`` (new tables,
        waited for, and the remap).
        """
        self._sync()
        upd = self.updater
        m = upd.num_users
        if m <= self.config.max_users:
            return None
        target = self.config.resolved_target()
        n_evict = m - target
        t0 = time.perf_counter()
        row_ranks = effective_ranks(upd.params.p, upd.t_p).cpu().numpy()
        t1 = time.perf_counter()
        order = np.lexsort((np.arange(m), row_ranks, self.last_touched))
        victims = np.sort(order[:n_evict])
        keep = np.sort(order[n_evict:])
        t2 = time.perf_counter()
        path = self._spill(victims)
        t3 = time.perf_counter()
        self._compact(keep, m)
        t4 = time.perf_counter()
        return {
            "evicted": int(n_evict),
            "num_users": int(upd.num_users),
            "remap_epoch": int(self.remap.epoch),
            "spilled_total": int(len(self._spilled)),
            "ranks_ms": (t1 - t0) * 1e3,
            "sort_ms": (t2 - t1) * 1e3,
            "spill_ms": (t3 - t2) * 1e3,
            "compact_ms": (t4 - t3) * 1e3,
            "spill_bytes": os.path.getsize(path),
        }

    def _compact(self, keep: np.ndarray, m: int) -> None:
        upd = self.updater
        old_to_new = np.full(m, -1, np.int64)
        old_to_new[keep] = np.arange(keep.size)
        take = torch.as_tensor(keep, dtype=torch.int64).to(upd.device)

        # new tables: the old ones (perhaps a served version's) stay as they were
        params = upd.params._replace(p=upd.params.p[take])
        if upd.params.user_bias is not None:
            params = params._replace(user_bias=upd.params.user_bias[take])
        upd.params = params
        upd._shared_params -= {"p", "user_bias"}

        def shrink(state):
            rows = _row_tables(state, m)
            return {key: value[take] if key in rows else value for key, value in state.items()}

        upd.opt_state = upd.opt_state._replace(
            p=shrink(upd.opt_state.p),
            user_bias=None if upd.opt_state.user_bias is None else shrink(upd.opt_state.user_bias),
        )

        live = self.remap.ext_to_phys >= 0
        translated = np.full_like(self.remap.ext_to_phys, -1)
        translated[live] = old_to_new[self.remap.ext_to_phys[live]].astype(np.int32)
        self.remap.ext_to_phys = translated
        self.remap.epoch += 1
        self.phys_to_ext = self.phys_to_ext[keep]
        self.last_touched = self.last_touched[keep]
        self.compactions += 1

        # pending-delta bookkeeping: physical indices shifted, so translate
        # the touched set and make the next publish a full rebuild
        upd._touched_users = {int(old_to_new[u]) for u in upd._touched_users
                              if u < m and old_to_new[u] >= 0}
        upd._layout_dirty = True
        if take.is_cuda:
            torch.cuda.synchronize(take.device)  # the report times the copies
