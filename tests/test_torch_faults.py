"""The port's fault seams held against the JAX reference on the CPU: the
``FaultPlan`` harness (schedules drawn from a seed bitwise as the
reference draws them, firing counts and logs), ``FailureInjector``, the
``checkpoint.fsync`` seam (an injected error publishes nothing) and the
store-mode trainer's ``trainer.slab`` seam under ``max_step_retries`` (a
retried slab ends bitwise equal to the run without the fault).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import trainer as jtrainer
from repro.data import ratings as jratings
from repro.distributed import fault_tolerance as jft
from repro.testing import faults as jfaults
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import trainer
from repro_torch.distributed.fault_tolerance import (
    FailureInjector,
    StepFailure,
    StragglerDetector,
)
from repro_torch.store import build_store
from repro_torch.testing import faults

SITES = [("replica.submit", ["r0", "r1", "r2"], ["kill"]),
         ("bus.deliver", ["r0", "r1"], ["drop", "dup", "corrupt", "delay"]),
         ("checkpoint.fsync", [], ["error"]),
         ("trainer.slab", [], ["error"])]


def _as_tuples(plan):
    return [dataclasses.astuple(a) for a in plan._actions]


@pytest.mark.parametrize("seed", [0, 1, 7, 8, 12345])
@pytest.mark.parametrize("n_actions,horizon", [(6, 16), (8, 32), (40, 5)])
def test_from_seed_draws_the_reference_schedule(seed, n_actions, horizon):
    got = faults.FaultPlan.from_seed(seed, sites=SITES, n_actions=n_actions, horizon=horizon)
    want = jfaults.FaultPlan.from_seed(seed, sites=SITES, n_actions=n_actions, horizon=horizon)
    assert _as_tuples(got) == _as_tuples(want)
    # the same events fire the same actions, in the same order
    rng = np.random.default_rng(seed)
    for _ in range(200):
        site, targets, _ = SITES[int(rng.integers(len(SITES)))]
        target = str(targets[int(rng.integers(len(targets)))]) if targets else ""
        assert ([dataclasses.astuple(a) for a in got.fire(site, target)]
                == [dataclasses.astuple(a) for a in want.fire(site, target)])
    assert got.fired == want.fired and got.pending == want.pending


def test_fault_plan_fires_at_exact_count_once():
    plan = faults.FaultPlan([faults.FaultAction(site="s", op="kill", at=2, target="x")])
    assert plan.fire("s", "x") == []
    assert plan.fire("s", "y") == []          # other targets do not advance x
    assert plan.fire("s", "x") == []
    assert [h.op for h in plan.fire("s", "x")] == ["kill"]
    assert plan.fire("s", "x") == []          # fires once
    assert plan.pending == 0
    assert plan.fired == [("s", "x", "kill", 2)]
    anyone = faults.FaultPlan([faults.FaultAction(site="s", op="error", at=0)])
    assert [h.op for h in anyone.fire("s", "whoever")] == ["error"]
    delays = [faults.FaultAction("bus.deliver", "delay", 0, arg=0.25),
              faults.FaultAction("bus.deliver", "drop", 0),
              faults.FaultAction("bus.deliver", "delay", 0, arg=0.5)]
    assert faults.delay_s(delays) == jfaults.delay_s(delays) == 0.75


def test_harness_disarmed_is_a_noop():
    assert faults._PLAN is None
    assert faults.fire("s", "x") == ()
    plan = faults.FaultPlan([faults.FaultAction(site="s", op="kill", at=0)])
    with faults.installed(plan):
        assert faults._PLAN is plan
        assert [h.op for h in faults.fire("s")] == ["kill"]
    assert faults._PLAN is None               # always disarmed on exit
    faults.install(plan)
    faults.uninstall()
    assert faults._PLAN is None


def test_failure_injector_matches_the_reference():
    got, want = FailureInjector((0, 3)), jft.FailureInjector((0, 3))
    for step in (0, 0, 1, 3, 3, 5):
        outcomes = []
        for injector in (got, want):
            try:
                injector(step)
                outcomes.append(None)
            except RuntimeError as exc:
                outcomes.append(str(exc))
        assert outcomes[0] == outcomes[1]
    assert (got.calls, got.failures, got.fail_on_steps) == (
        want.calls, want.failures, want.fail_on_steps) == (6, 2, set())


def _tree():
    return {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(3, np.int32)}


@pytest.mark.parametrize("prior_step", [None, 4])
def test_injected_fsync_failure_publishes_nothing(tmp_path, prior_step):
    """The seam fires after the payload is written and before the fsync and
    the publish: the directory keeps its latest step, and the reference
    restores what the port then writes."""
    directory = str(tmp_path)
    if prior_step is not None:
        ckpt.save(directory, prior_step, _tree())
    plan = faults.FaultPlan([faults.FaultAction(site="checkpoint.fsync", op="error", at=0)])
    with faults.installed(plan):
        with pytest.raises(OSError, match="injected fsync"):
            ckpt.save(directory, 5, _tree())
    assert plan.pending == 0 and plan.fired == [("checkpoint.fsync", "", "error", 0)]
    assert ckpt.latest_step(directory) == prior_step
    ckpt.save(directory, 5, _tree())          # disarmed: the save works again
    assert ckpt.latest_step(directory) == 5
    restored, _ = jckpt.restore(directory, _tree())
    np.testing.assert_array_equal(np.asarray(restored["a"]), _tree()["a"])


def test_async_checkpointer_surfaces_the_injected_failure(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    saver.save(1, _tree())
    saver.wait()
    plan = faults.FaultPlan([faults.FaultAction(site="checkpoint.fsync", op="error", at=0)])
    with faults.installed(plan):
        saver.save(2, {"a": torch.zeros(2, 3), "b": torch.ones(3, dtype=torch.int32)})
        with pytest.raises(OSError, match="injected fsync"):
            saver.wait()
    assert ckpt.all_steps(str(tmp_path)) == [1]


# ---------------------------------------------------------------------------
# the store-mode trainer's slab seam
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ratings_store(tmp_path_factory):
    store_dir = str(tmp_path_factory.mktemp("fault_store") / "store")
    ds = jratings.synthetic_ratings(300, 100, 4096, seed=0)
    from repro_torch.data.ratings import RatingsDataset

    build_store(RatingsDataset(ds.user, ds.item, ds.rating, ds.num_users, ds.num_items),
                store_dir)
    return store_dir


def _store_cfg(module, store_dir, **kw):
    base = dict(k=8, epochs=1, batch_size=64, lr=0.05, lam=0.02, pruning_rate=0.5, seed=0,
                store_dir=store_dir, slab_steps=4, prefetch_slabs=2)
    base.update(kw)
    return module.TrainConfig(**base)


def _port(cfg):
    return trainer.DPMFTrainer(cfg, None, None, device="cpu")


@pytest.mark.parametrize("at", [0, 1, 5])
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_retried_slab_failure_is_bitwise(ratings_store, at, optimizer):
    clean = _port(_store_cfg(trainer, ratings_store, optimizer=optimizer))
    clean.run_epoch()
    assert clean.history[-1].step_retries == 0
    faulted = _port(_store_cfg(trainer, ratings_store, optimizer=optimizer, max_step_retries=2))
    plan = faults.FaultPlan([faults.FaultAction(site="trainer.slab", op="error", at=at)])
    with faults.installed(plan):
        faulted.run_epoch()
    assert plan.pending == 0
    assert faulted.history[-1].step_retries == 1
    assert torch.equal(faulted.params.p, clean.params.p)
    assert torch.equal(faulted.params.q, clean.params.q)
    for group in ("p", "q"):
        for key, value in getattr(clean.opt_state, group).items():
            assert torch.equal(getattr(faulted.opt_state, group)[key], value)
    assert faulted.history[-1].train_abs_err == clean.history[-1].train_abs_err


def test_retry_exhaustion_raises_step_failure_as_the_reference(ratings_store):
    for module, make, fmod in ((trainer, _port, faults),
                               (jtrainer, lambda c: jtrainer.DPMFTrainer(c), jfaults)):
        t = make(_store_cfg(module, ratings_store, max_step_retries=1))
        plan = fmod.FaultPlan([fmod.FaultAction(site="trainer.slab", op="error", at=0),
                               fmod.FaultAction(site="trainer.slab", op="error", at=1)])
        with fmod.installed(plan):
            with pytest.raises(Exception) as info:
                t.run_epoch()
        assert type(info.value).__name__ == "StepFailure"
    assert issubclass(StepFailure, RuntimeError)


def test_failure_injector_hook_and_record_fields(ratings_store):
    t = _port(_store_cfg(trainer, ratings_store, max_step_retries=1, epochs=2))
    num_slabs = t._loader.num_slabs
    t.failure_injector = FailureInjector((0, num_slabs))  # the first slab of each epoch
    t.run_epoch()
    t.run_epoch()
    assert t.failure_injector.failures == 2 and t._slab_counter == 2 * num_slabs
    assert [r.step_retries for r in t.history] == [1, 1]
    assert all(r.straggler_slabs >= 0 for r in t.history)
    # no wrapper without max_step_retries: the injected fault propagates
    bare = _port(_store_cfg(trainer, ratings_store))
    bare.failure_injector = FailureInjector((0,))
    with pytest.raises(RuntimeError, match="injected fault at step 0"):
        bare.run_epoch()


def test_straggler_detector_flags_an_outlier():
    det = StragglerDetector(window=20, z_threshold=4.0, min_samples=10)
    assert not any(det.record(0.1 + 1e-4 * i) for i in range(15))
    assert det.record(10.0)
    assert det.flagged == 1
    assert not det.record(0.1)
