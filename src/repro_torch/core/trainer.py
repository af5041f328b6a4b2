"""The DP-MF trainer: the paper's overall procedure (Figs. 6 and 10).

Counterpart of ``repro/core/trainer.py``.  Schedule:

  epoch 0   : standard (unpruned) training; no thresholds exist yet
  after it  : measure (mu, sigma) of P and Q -> T_p, T_q      (§4.2, once)
              rearrange the latent axis by joint sparsity      (§4.3, once)
  epoch 1.. : dynamically pruned training                      (§4.4)

The dense baseline is the same trainer at ``pruning_rate = 0``.  Everything
runs on ``cuda`` unless the trainer is given ``device="cpu"``; on the card
the fused SGD step (``use_fused_kernel=True`` with ``optimizer="sgd"``)
goes through the hand-written ``fused_mf_sgd`` kernel.  With
``ranking_topk > 0`` every epoch also logs HR/NDCG/recall@K over the test
split (``mf.eval_ranking_epoch_scan``, through the ``pruned_topk`` kernel on
the card).

Three objectives (``repro_torch.workloads``): ``explicit`` (the paper's
squared rating error), ``implicit`` (WALS: the log is expanded once at init
into positives and sampled negatives, the confidence riding the step's
weight column, so sgd with ``use_fused_kernel`` takes the ``fused_mf_sgd``
kernel with a weight column) and ``bpr`` (pairwise, on per-epoch sampled
triples; the test MAE is NaN, the ranking metrics carry).

**Store mode** (``TrainConfig.store_dir``): the ratings stay on disk in a
``repro_torch.store`` ratings store and each epoch streams through
``ShardedRatingsLoader`` as ``(slab_steps, B)`` slabs, the step still
``mf.train_epoch_scan`` (so sgd with ``use_fused_kernel`` launches
``fused_mf_sgd`` every streamed step).  The slab order is the reference's
Feistel order, so both packages train on the same batches.  Metric means
accumulate weighted by step in host float64; ``checkpoint_every_slabs``
saves mid-epoch with the running sums, and a restart replays only the
remaining slabs.  ``max_step_retries`` wraps each slab in
``run_with_retries``: a retry is bitwise because the step writes the tables
in place only once it runs, and the fault seams (the ``failure_injector``
hook and the ``trainer.slab`` seam of ``repro_torch.testing.faults``) fire
before that; a failure raised part-way through a slab's steps would re-run
the slab on the tables as that attempt left them.  Wall-time outliers among
slabs are counted by a ``StragglerDetector``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.core import mf, rearrange, threshold
from repro_torch.data import loader
from repro_torch.data.ratings import RatingsDataset, build_user_history
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.fault_tolerance import StragglerDetector, run_with_retries
from repro_torch.eval import ranking as ranking_eval
from repro_torch.optim.optimizers import RowOptimizer
from repro_torch.optim.schedules import twin_learners_mask
from repro_torch.store import RatingsStore, ShardedRatingsLoader
from repro_torch.testing import faults
from repro_torch.workloads import bpr as bpr_wl
from repro_torch.workloads import implicit as implicit_wl


@dataclasses.dataclass
class TrainConfig:
    k: int = 50
    epochs: int = 15
    batch_size: int = 4096
    lr: float = 0.05
    lam: float = 0.02
    pruning_rate: float = 0.0          # 0 disables pruning (dense baseline)
    optimizer: str = "adagrad"         # sgd | momentum | adagrad | adadelta | adam
    strategy: str = "standard"         # standard | twin  (paper §5.3)
    init_method: str = "normal"        # normal | uniform | libmf
    variant: str = "funk"              # funk | bias | svdpp
    objective: str = "explicit"        # explicit | implicit | bpr
    implicit_alpha: float = 40.0       # implicit confidence c = 1 + alpha * r
    implicit_negatives: int = 4        # sampled unobserved items a positive
    use_fused_kernel: bool = False     # the fused kernel for sgd without SVD++
    epoch_mode: str = "scan"           # scan: device-resident epoch loop
    #                                  # python: per-batch host loop
    seed: int = 0
    eval_batch_size: int = 8192
    max_hist: int = 32                 # svd++ implicit history length
    rearrange: bool = True             # Alg. 1; False = ablation
    ranking_topk: int = 0              # > 0: per-epoch HR/NDCG/recall@K too
    ranking_max_users: Optional[int] = 512   # eval-user cap for ranking
    checkpoint_dir: Optional[str] = None
    checkpoint_every_epochs: int = 0   # 0 = only final
    keep_checkpoints: int = 3
    # -- out-of-core streaming (repro_torch.store) ---------------------------
    store_dir: Optional[str] = None    # train from an on-disk RatingsStore
    slab_steps: int = 256              # steps per streamed slab
    prefetch_slabs: int = 2            # bounded prefetch queue depth
    checkpoint_every_slabs: int = 0    # 0 = no mid-epoch checkpoints
    max_step_retries: int = 0          # retries per streamed slab; 0 = no wrapper
    # -- gradient exchange of the sharded step (mf.train_step_shard_map) ----
    grad_compression: str = "none"     # none | int8 | int8_ef; the trainer does not read it


@dataclasses.dataclass
class EpochRecord:
    """One epoch's logged measurements (``DPMFTrainer.history`` entries).
    The ranking fields are NaN unless ``TrainConfig.ranking_topk > 0`` and
    a test split exists."""

    epoch: int
    wall_time_s: float
    train_abs_err: float
    test_mae: float
    work_fraction: float   # mean k_eff / k: the work-proportional cost
    t_p: float
    t_q: float
    hr: float = float("nan")       # HR@K at ranking_topk
    ndcg: float = float("nan")     # NDCG@K
    recall: float = float("nan")   # recall@K
    straggler_slabs: int = 0       # slabs flagged as wall-time outliers
    step_retries: int = 0          # slab retries consumed this epoch


def _check_supported(config: TrainConfig, train_ds) -> None:
    """The reference's validation, in its order."""
    if config.epoch_mode not in ("scan", "python"):
        raise ValueError(f"unknown epoch_mode {config.epoch_mode!r}")
    if config.objective not in ("explicit", "implicit", "bpr"):
        raise ValueError(f"unknown objective {config.objective!r}")
    if config.objective != "explicit":
        if config.store_dir is not None:
            raise ValueError("store-backed training supports only the explicit objective")
        if config.epoch_mode != "scan":
            raise ValueError(f"objective {config.objective!r} requires epoch_mode='scan'")
        if config.variant == "svdpp":
            raise ValueError(
                "svdpp histories assume a rated log; use variant 'funk' or 'bias' "
                "with implicit/bpr objectives")
        if train_ds is None:
            raise ValueError(f"objective {config.objective!r} requires train_ds")
    if config.store_dir is not None:
        if config.epoch_mode != "scan":
            raise ValueError("store-backed training requires epoch_mode='scan'")
        if config.variant == "svdpp":
            raise ValueError(
                "store-backed training does not support svdpp (the implicit-history "
                "matrix is itself O(users))")
    elif train_ds is None:
        raise ValueError("either train_ds or config.store_dir is required")


class DPMFTrainer:
    """End-to-end trainer implementing the paper, with checkpoint/restart.

    ``params`` and ``opt_state`` are public: a caller may replace ``params``
    (for example with factors carried over by ``mf.params_from_numpy``)
    before :meth:`run`, and then rebuilds ``opt_state`` with
    ``mf.init_opt_state(trainer.params, trainer.opt)``.  With
    ``config.store_dir`` the trainer needs no ``train_ds``: sizes and global
    mean come from the store's index.  ``failure_injector`` (a callable of
    the global slab number, e.g. ``FailureInjector``) is a test hook of
    store mode.
    """

    def __init__(
        self,
        config: TrainConfig,
        train_ds: Optional[RatingsDataset] = None,
        test_ds: Optional[RatingsDataset] = None,
        *,
        device: DeviceLike = None,
    ):
        _check_supported(config, train_ds)
        self.config = config
        self.device = resolve_device(device)
        self.opt = RowOptimizer(name=config.optimizer)
        self._train_weight = None   # implicit confidence column
        self._bpr_sampler = None
        if config.objective == "implicit":
            # one-time expansion: positives + sampled negatives, with the
            # WALS confidence column carried as per-example weights
            train_ds, self._train_weight = implicit_wl.implicit_dataset(
                train_ds, alpha=config.implicit_alpha,
                negatives=config.implicit_negatives, seed=config.seed)
            if test_ds is not None:
                # held-out interactions as preference-1 targets
                test_ds = implicit_wl.binarize_positives(test_ds)
        self.train_ds = train_ds
        self.test_ds = test_ds
        self._loader = None
        self._resume_slab = 0
        self._resume_sums = (0.0, 0.0, 0)   # (err_sum, work_sum, steps_done)
        self.straggler = StragglerDetector(window=20, z_threshold=4.0)
        self.failure_injector = None
        self._slab_counter = 0              # global slab number across epochs
        if config.store_dir is not None:
            # out of core: the ratings stay on disk (mmap) and stream through
            # a bounded prefetch queue; host memory is set by its depth
            self._loader = ShardedRatingsLoader(
                RatingsStore(config.store_dir), config.batch_size,
                slab_steps=config.slab_steps, prefetch=config.prefetch_slabs,
                device=self.device)
        self.hist = (
            build_user_history(train_ds, config.max_hist) if config.variant == "svdpp" else None
        )
        self._hist_dev = (
            None if self.hist is None
            else torch.as_tensor(self.hist, dtype=torch.int64).to(self.device)
        )
        self._packed_train = self._packed_eval = None
        if config.objective == "bpr":
            self._bpr_sampler = bpr_wl.BPRSampler(
                train_ds, config.batch_size, seed=config.seed, device=self.device)
        if config.epoch_mode == "scan":
            # upload the ratings once; the batch size is clamped so a tiny
            # dataset trains as one batch per epoch instead of zero steps
            if self._bpr_sampler is None and self._loader is None:
                self._packed_train = loader.pack_ratings(
                    train_ds, min(config.batch_size, max(len(train_ds), 1)),
                    weight=self._train_weight, device=self.device)
            if test_ds is not None:
                self._packed_eval = loader.pack_eval_batches(
                    test_ds, config.eval_batch_size, device=self.device)
        self._packed_ranking = None
        if config.ranking_topk > 0 and test_ds is not None:
            self._packed_ranking = ranking_eval.pack_ranking_batches(
                test_ds, 256, max_users=config.ranking_max_users, device=self.device)

        generator = torch.Generator(device=self.device).manual_seed(config.seed)
        src = train_ds if train_ds is not None else self._loader.store
        self.params = mf.init_params(
            generator, src.num_users, src.num_items, config.k,
            variant=config.variant, init_method=config.init_method,
            global_mean=src.global_mean, device=self.device,
        )
        self.opt_state = mf.init_opt_state(self.params, self.opt)
        self.t_p = self._scalar(0.0)
        self.t_q = self._scalar(0.0)
        self.perm: Optional[torch.Tensor] = None
        # the joint sparsity (Eq. 10) of the latent dims in ``perm`` order,
        # set by calibrate(); two runs whose perms differ can show it was a
        # near-tie
        self.joint_sparsity: Optional[torch.Tensor] = None
        self.epoch = 0
        self.history: List[EpochRecord] = []
        self._ckpt = (
            ckpt_lib.AsyncCheckpointer(config.checkpoint_dir, keep=config.keep_checkpoints)
            if config.checkpoint_dir else None
        )

    def _scalar(self, value) -> torch.Tensor:
        return torch.as_tensor(value, dtype=torch.float32).to(self.device)

    # -- checkpoint/restart ------------------------------------------------
    def _state_tree(self) -> Dict[str, Any]:
        perm = self.perm
        if perm is None:
            perm = torch.arange(self.config.k, dtype=torch.int32, device=self.device)
        return {"params": self.params, "opt_state": self.opt_state,
                "t_p": self.t_p, "t_q": self.t_q, "perm": perm}

    def _ckpt_step(self, slabs_done: int = 0) -> int:
        """Checkpoint step number: the epoch count in memory; in store mode
        ``epoch * num_slabs + slabs_done``, so epoch-boundary and mid-epoch
        saves never collide and steps stay monotonic over the run."""
        if self._loader is None:
            return self.epoch
        return self.epoch * self._loader.num_slabs + slabs_done

    def save(self, step: int, *, extra_metadata: Optional[Dict[str, Any]] = None) -> None:
        """Checkpoint the state tree as ``step`` (asynchronously)."""
        if self._ckpt is None:
            return
        metadata = {"epoch": self.epoch, "seed": self.config.seed,
                    "pruning_rate": self.config.pruning_rate}
        if extra_metadata:
            metadata.update(extra_metadata)
        self._ckpt.save(step, self._state_tree(), metadata=metadata)

    def _save_mid_epoch(self, slabs_done: int, err_sum: float, work_sum: float,
                        steps_done: int) -> None:
        """Checkpoint inside an epoch (store mode): the state plus the
        running metric sums, so a restart replays only the remaining slabs
        and reports the same epoch metrics."""
        self.save(self._ckpt_step(slabs_done), extra_metadata={
            "slab_idx": slabs_done, "err_sum": err_sum, "work_sum": work_sum,
            "steps_done": steps_done})

    def maybe_restore(self) -> bool:
        """Resume from the newest checkpoint in ``checkpoint_dir``, if any
        (mid-epoch in store mode: the next epoch starts at the saved slab
        with the saved sums).  Reads the reference trainer's checkpoints as
        well as the port's."""
        directory = self.config.checkpoint_dir
        if directory is None or ckpt_lib.latest_step(directory) is None:
            return False
        tree, meta = ckpt_lib.restore(directory, self._state_tree())

        def up(value):
            return None if value is None else torch.as_tensor(value).to(self.device)

        self.params = mf.MFParams(*(up(v) for v in tree["params"]))
        self.opt_state = mf.MFOptState(*(
            None if state is None else {key: up(v) for key, v in state.items()}
            for state in tree["opt_state"]
        ))
        self.t_p = self._scalar(tree["t_p"])
        self.t_q = self._scalar(tree["t_q"])
        self.perm = up(tree["perm"])
        self.epoch = int(meta["epoch"])
        self._resume_slab = int(meta.get("slab_idx", 0))
        self._resume_sums = (float(meta.get("err_sum", 0.0)), float(meta.get("work_sum", 0.0)),
                             int(meta.get("steps_done", 0)))
        return True

    # -- the paper's one-time calibration (after epoch 0) --------------------
    def calibrate(self) -> None:
        """Solve ``(T_p, T_q)`` (Eq. 7/8) and permute the latent axis by
        joint sparsity (Alg. 1) in the factors and in every 2-D optimizer
        state of width k, in place and in row chunks."""
        cfg = self.config
        if cfg.pruning_rate <= 0.0:
            return
        self.t_p, self.t_q = threshold.thresholds_from_matrices(
            self.params.p, self.params.q, cfg.pruning_rate)
        if not cfg.rearrange:  # ablation: prune without Algorithm 1
            self.perm = torch.arange(cfg.k, dtype=torch.int32, device=self.device)
            return
        result = rearrange.rearrangement(self.params.p, self.params.q, self.t_p, self.t_q)
        self.perm, self.joint_sparsity = result.perm, result.joint_sparsity
        tables = [self.params.p, self.params.q]
        if self.params.implicit is not None:
            tables.append(self.params.implicit)
        for state in (self.opt_state.p, self.opt_state.q, self.opt_state.implicit):
            for value in (state or {}).values():
                if value.dim() == 2 and value.shape[1] == cfg.k:
                    tables.append(value)
        rearrange.apply_perm_tree(tables, self.perm)

    # -- epochs --------------------------------------------------------------
    def run_epoch(self) -> EpochRecord:
        cfg = self.config
        pruning_active = cfg.pruning_rate > 0.0 and self.epoch >= 1
        t_p = self.t_p if pruning_active else self._scalar(0.0)
        t_q = self.t_q if pruning_active else self._scalar(0.0)
        dim_mask = (
            twin_learners_mask(cfg.k, self.epoch, device=self.device)
            if cfg.strategy == "twin"
            else torch.ones((cfg.k,), dtype=torch.float32, device=self.device)
        )
        start = time.perf_counter()
        straggler_slabs = retries = 0
        if self._loader is not None:
            abs_err, work, straggler_slabs, retries = self._run_store_epoch(t_p, t_q, dim_mask)
        elif self._bpr_sampler is not None:
            # pairwise epoch: freshly sampled triples; abs_err is the BPR loss
            triples = self._bpr_sampler.epoch_triples(self.epoch)
            self.params, self.opt_state, metrics = bpr_wl.bpr_epoch_scan(
                self.params, self.opt_state, triples, t_p, t_q, cfg.lr, dim_mask,
                opt=self.opt, lam=cfg.lam,
            )
            abs_err = float(metrics["abs_err"])
            work = float(metrics["work_fraction"])
        elif cfg.epoch_mode == "scan":
            batches = self._packed_train.epoch_batches(cfg.seed, self.epoch)
            self.params, self.opt_state, metrics = mf.train_epoch_scan(
                self.params, self.opt_state, batches, t_p, t_q, cfg.lr, dim_mask,
                self._hist_dev, opt=self.opt, lam=cfg.lam,
                use_fused_kernel=cfg.use_fused_kernel,
            )
            # the epoch's single host sync: two scalars
            abs_err = float(metrics["abs_err"])
            work = float(metrics["work_fraction"])
        else:
            # per-batch host loop; the metrics still accumulate on the
            # device and are read once after the loop
            err_sum = self._scalar(0.0)
            work_sum = self._scalar(0.0)
            steps = 0
            for batch_np in loader.iterate_batches(
                self.train_ds, cfg.batch_size, seed=cfg.seed, epoch=self.epoch, hist=self.hist,
            ):
                batch = {key: torch.as_tensor(value).to(self.device)
                         for key, value in batch_np.items()}
                self.params, self.opt_state, metrics = mf.train_step(
                    self.params, self.opt_state, batch, t_p, t_q, cfg.lr, dim_mask,
                    opt=self.opt, lam=cfg.lam, use_fused_kernel=cfg.use_fused_kernel,
                )
                err_sum = err_sum + metrics["abs_err"]
                work_sum = work_sum + metrics["work_fraction"]
                steps += 1
            abs_err = float(err_sum) / max(steps, 1)
            work = float(work_sum) / max(steps, 1)
        wall = time.perf_counter() - start

        test_mae = self.evaluate(t_p, t_q) if self.test_ds is not None else float("nan")
        ranking = self.evaluate_ranking(t_p, t_q)
        record = EpochRecord(
            epoch=self.epoch, wall_time_s=wall, train_abs_err=abs_err, test_mae=test_mae,
            work_fraction=work, t_p=float(t_p), t_q=float(t_q),
            straggler_slabs=straggler_slabs, step_retries=retries,
            **({"hr": ranking.hr, "ndcg": ranking.ndcg, "recall": ranking.recall}
               if ranking is not None else {}),
        )
        self.history.append(record)
        if self.epoch == 0:
            self.calibrate()  # the paper: once, right after the first epoch
        self.epoch += 1
        if (self._ckpt is not None and cfg.checkpoint_every_epochs
                and self.epoch % cfg.checkpoint_every_epochs == 0):
            self.save(self._ckpt_step())
        return record

    def _run_store_epoch(self, t_p, t_q, dim_mask):
        """One streamed epoch from the resume point: ``(abs_err, work,
        straggler_slabs, retries)``.  The means are step-weighted sums in
        host float64, so a run resumed from a mid-epoch checkpoint reports
        the uninterrupted run's numbers."""
        cfg = self.config
        err_sum, work_sum, steps_done = self._resume_sums
        start_slab = self._resume_slab
        self._resume_slab, self._resume_sums = 0, (0.0, 0.0, 0)
        stragglers = 0
        retries = [0]

        def count_retry(attempt, exc):
            retries[0] += 1

        for slab in self._loader.epoch_slabs(cfg.seed, self.epoch, start_slab=start_slab):
            def run_slab(slab=slab):
                # the faults fire before the step's first write, so a retry
                # re-runs the slab on the tables as they were
                if self.failure_injector is not None:
                    self.failure_injector(self._slab_counter)
                if faults._PLAN is not None:
                    for act in faults.fire("trainer.slab"):
                        if act.op == "error":
                            raise faults.FaultError("injected slab failure")
                return mf.train_epoch_scan(
                    self.params, self.opt_state, slab.batches, t_p, t_q, cfg.lr, dim_mask,
                    self._hist_dev, opt=self.opt, lam=cfg.lam,
                    use_fused_kernel=cfg.use_fused_kernel,
                )

            slab_start = time.perf_counter()
            if cfg.max_step_retries > 0:
                self.params, self.opt_state, metrics = run_with_retries(
                    run_slab, max_retries=cfg.max_step_retries, backoff_s=0.05,
                    on_retry=count_retry)
            else:
                self.params, self.opt_state, metrics = run_slab()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if self.straggler.record(time.perf_counter() - slab_start):
                stragglers += 1
            self._slab_counter += 1
            err, work = torch.stack([metrics["abs_err"], metrics["work_fraction"]]).tolist()
            err_sum += err * slab.steps
            work_sum += work * slab.steps
            steps_done += slab.steps
            slabs_done = slab.slab_idx + 1
            if (self._ckpt is not None and cfg.checkpoint_every_slabs
                    and slabs_done % cfg.checkpoint_every_slabs == 0
                    and slabs_done < self._loader.num_slabs):
                self._save_mid_epoch(slabs_done, err_sum, work_sum, steps_done)
        denom = max(steps_done, 1)
        return err_sum / denom, work_sum / denom, stragglers, retries[0]

    def run(self) -> List[EpochRecord]:
        """Train the remaining epochs, then save a final checkpoint."""
        for _ in range(self.epoch, self.config.epochs):
            self.run_epoch()
        self.finish()
        return self.history

    def finish(self) -> None:
        """Save a final checkpoint and wait until it is published (nothing
        without ``checkpoint_dir``)."""
        if self._ckpt is not None:
            self.save(self._ckpt_step())
            self._ckpt.wait()

    def evaluate(self, t_p=None, t_q=None) -> float:
        """Test MAE (Eq. 12) at the given (default: current) thresholds; NaN
        without a test split and under ``bpr`` (pairwise scores have no
        rating scale)."""
        if self.test_ds is None or self.config.objective == "bpr":
            return float("nan")
        t_p = self.t_p if t_p is None else t_p
        t_q = self.t_q if t_q is None else t_q
        if self.config.epoch_mode == "scan":
            total, count = mf.eval_epoch_scan(self.params, self._packed_eval, t_p, t_q,
                                              self._hist_dev)
            return float(total) / max(float(count), 1.0)
        total = self._scalar(0.0)
        count = self._scalar(0.0)
        for batch_np in loader.iterate_batches(
            self.test_ds, self.config.eval_batch_size, shuffle=False,
            drop_remainder=False, hist=self.hist,
        ):
            batch = {key: torch.as_tensor(value).to(self.device)
                     for key, value in batch_np.items()}
            s, c = mf.eval_mae(self.params, batch, t_p, t_q)
            total = total + s
            count = count + c
        return float(total) / max(float(count), 1.0)

    def evaluate_ranking(self, t_p=None, t_q=None):
        """Test-split HR/NDCG/recall@``ranking_topk`` at the given (default:
        current) thresholds, as a :class:`~repro_torch.eval.ranking.RankingReport`;
        None unless ``ranking_topk > 0`` and a test split exists.  Runs
        ``mf.eval_ranking_epoch_scan`` over the batches packed at init and
        reads its four sums once."""
        if self._packed_ranking is None:
            return None
        t_p = self.t_p if t_p is None else t_p
        t_q = self.t_q if t_q is None else t_q
        sums = mf.eval_ranking_epoch_scan(
            self.params, self._packed_ranking, t_p, t_q, self._hist_dev,
            topk=self.config.ranking_topk,
        )
        values = torch.stack(list(sums.values())).tolist()  # the one host sync
        return ranking_eval.report_from_sums(dict(zip(sums, values)), self.config.ranking_topk)

    # -- summary metrics matching the paper's Eqs. 12-14 ---------------------
    def total_train_time(self) -> float:
        return sum(r.wall_time_s for r in self.history)

    def mean_work_fraction(self) -> float:
        pruned = [r.work_fraction for r in self.history if r.epoch >= 1]
        return float(np.mean(pruned)) if pruned else 1.0


def percentage_mae(mae_accelerated: float, mae_original: float) -> float:
    """Eq. 13."""
    return (mae_accelerated - mae_original) / mae_original * 100.0


def work_speedup(history: List[EpochRecord]) -> float:
    """Work-proportional speedup: dense MACs over executed MACs across the
    whole run (epoch 0 is always dense, as in the paper)."""
    total = len(history)
    if total == 0:
        return 1.0
    executed = sum(r.work_fraction for r in history)
    return total / max(executed, 1e-9)
