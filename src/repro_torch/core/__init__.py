"""Model core of the port: ranks, thresholds, the MF model, rearrangement and the trainer."""
import importlib

# the reference's names, each from its module, loaded on first use: the
# modules import the kernels, optim, serving and workloads packages, which
# import these modules in turn
_EXPORTS = {
    "mf": (
        "MFOptState", "MFParams", "eval_epoch_scan", "eval_mae", "init_opt_state",
        "init_params", "predict_all_items", "predict_pairs", "train_epoch_scan",
        "train_epoch_scan_shard_map", "train_step", "train_step_shard_map",
    ),
    "ranks": (
        "effective_ranks", "mask_rows", "pair_rank", "pruned_pair_dot", "rank_mask",
        "sparsity_per_dim", "work_fraction",
    ),
    "rearrange": (
        "apply_perm", "apply_perm_tree", "joint_sparsity", "rearrangement",
    ),
    "threshold": (
        "MatrixStats", "empirical_pruned_fraction", "measure_stats", "threshold_for_rate",
        "thresholds_from_matrices",
    ),
    "trainer": (
        "DPMFTrainer", "EpochRecord", "TrainConfig", "percentage_mae", "work_speedup",
    ),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}


def __getattr__(name):
    if name in _MODULE_OF:
        return getattr(importlib.import_module(f"repro_torch.core.{_MODULE_OF[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_MODULE_OF))
