"""The port's checkpoint write side and the training launcher, held against
the JAX reference on the CPU: identical keys, checkpoints restored across
both packages in both directions, and train-then-serve through the CLIs."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import mf as jmf
from repro.core import trainer as jtrainer
from repro.data import ratings as jratings
from repro.optim.optimizers import RowOptimizer as JRowOptimizer
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import mf, trainer
from repro_torch.data import ratings
from repro_torch.optim.optimizers import RowOptimizer
from repro_torch.serving import ServingEngine

REPO = Path(__file__).resolve().parents[1]


def _state_trees(variant, opt_name):
    jparams = jmf.init_params(jax.random.PRNGKey(0), 5, 7, 4, variant=variant, global_mean=3.0)
    jtree = {"params": jparams, "opt_state": jmf.init_opt_state(jparams, JRowOptimizer(opt_name)),
             "t_p": jnp.float32(0.1), "t_q": jnp.float32(0.2),
             "perm": jnp.arange(4, dtype=jnp.int32)}
    params = mf.params_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in jparams._asdict().items()},
        device="cpu")
    tree = {"params": params, "opt_state": mf.init_opt_state(params, RowOptimizer(opt_name)),
            "t_p": torch.tensor(0.1), "t_q": torch.tensor(0.2),
            "perm": torch.arange(4, dtype=torch.int32)}
    return jtree, tree


@pytest.mark.parametrize("variant,opt_name", [("funk", "sgd"), ("bias", "adagrad"),
                                              ("svdpp", "adam")])
def test_keys_are_the_reference_keys(variant, opt_name, tmp_path):
    jtree, tree = _state_trees(variant, opt_name)
    want = jckpt._flatten_with_paths(jtree)
    got = ckpt.flatten_with_paths(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == np.asarray(w).dtype and g.shape == np.asarray(w).shape
    jckpt.save(str(tmp_path / "ref"), 1, jtree)
    ckpt.save(str(tmp_path / "port"), 1, tree)
    assert (ckpt.load_metadata(str(tmp_path / "port"), 1)["keys"]
            == jckpt.load_metadata(str(tmp_path / "ref"), 1)["keys"])


def _datasets():
    tr, te = jratings.train_test_split(jratings.synthetic_ratings(80, 60, 2500, seed=1), 0.2,
                                       seed=1)
    port = [ratings.RatingsDataset(d.user, d.item, d.rating, d.num_users, d.num_items)
            for d in (tr, te)]
    return (tr, te), port


CONFIG = dict(k=8, batch_size=128, pruning_rate=0.3, variant="bias", optimizer="adagrad",
              epoch_mode="python")


def _assert_same_state(port, ref):
    for name, g, w in zip(port.params._fields, port.params, ref.params):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for g, w in zip(port.opt_state, ref.opt_state):
        assert (g is None) == (w is None)
        for key in (g or {}):
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]), err_msg=key)
    np.testing.assert_array_equal(port.perm.numpy(), np.asarray(ref.perm))
    assert float(port.t_p) == float(ref.t_p) and float(port.t_q) == float(ref.t_q)
    assert port.epoch == ref.epoch


def test_port_restores_a_reference_checkpoint_and_trains_on(tmp_path):
    (tr, te), (ptr, pte) = _datasets()
    ref = jtrainer.DPMFTrainer(jtrainer.TrainConfig(epochs=2, checkpoint_dir=str(tmp_path),
                                                    **CONFIG), tr, te)
    ref.run()
    port = trainer.DPMFTrainer(trainer.TrainConfig(epochs=3, checkpoint_dir=str(tmp_path),
                                                   **CONFIG), ptr, pte, device="cpu")
    assert port.maybe_restore()
    _assert_same_state(port, ref)
    # both go on from the same state: the third epoch agrees
    got = port.run_epoch()
    want = ref.run_epoch()
    for field in ("train_abs_err", "test_mae", "work_fraction"):
        assert abs(getattr(got, field) - getattr(want, field)) <= 1e-4 * abs(getattr(want, field))


def test_reference_restores_a_port_checkpoint(tmp_path):
    (tr, te), (ptr, pte) = _datasets()
    port = trainer.DPMFTrainer(trainer.TrainConfig(epochs=2, checkpoint_dir=str(tmp_path),
                                                   **CONFIG), ptr, pte, device="cpu")
    port.run()
    ref = jtrainer.DPMFTrainer(jtrainer.TrainConfig(epochs=3, checkpoint_dir=str(tmp_path),
                                                    **CONFIG), tr, te)
    assert ref.maybe_restore()
    _assert_same_state(port, ref)


def test_save_retention_async_and_restore_errors(tmp_path):
    _, tree = _state_trees("bias", "adagrad")
    d = str(tmp_path)
    for step in range(1, 6):
        ckpt.save(d, step, tree, keep=2)
    assert ckpt.all_steps(d) == [4, 5]
    assert not [n for n in os.listdir(d) if ".lnk." in n]  # no temp link left behind
    writer = ckpt.AsyncCheckpointer(d, keep=3)
    writer.save(6, tree, metadata={"epoch": 6})
    tree["params"].p.add_(1.0)  # the snapshot was taken at save()
    writer.wait()
    restored, meta = ckpt.restore(d, tree)
    assert meta["epoch"] == 6 and meta["step"] == 6
    np.testing.assert_array_equal(restored["params"].p + 1.0, tree["params"].p.numpy())
    assert restored["params"].implicit is None and isinstance(restored["params"], mf.MFParams)
    wrong = dict(tree, perm=torch.arange(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, wrong)
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(d, dict(tree, extra=torch.zeros(1)))


def test_restore_falls_back_past_a_corrupt_step(tmp_path):
    _, tree = _state_trees("funk", "sgd")
    d = str(tmp_path)
    ckpt.save(d, 1, tree)
    path = ckpt.save(d, 2, dict(tree, t_p=torch.tensor(0.5)))
    npz = Path(os.path.realpath(path)) / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    restored, meta = ckpt.restore(d, tree)
    assert meta["step"] == 1 and float(restored["t_p"]) == np.float32(0.1)
    with pytest.raises(ckpt.CorruptCheckpointError):
        ckpt.restore(d, tree, step=2)  # an explicit step never falls back


def test_train_then_serve_through_the_clis(tmp_path):
    """repro_torch.launch.train --device cpu writes a checkpoint that
    repro_torch.launch.serve serves, and the reference's engine serves the
    same top-k from it."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    ck = str(tmp_path / "ck")
    train = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--scale", "0.05",
         "--k", "8", "--epochs", "2", "--batch-size", "256", "--variant", "bias",
         "--optimizer", "sgd", "--use-fused-kernel", "--lr", "0.01", "--ckpt", ck],
        env=env, capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stderr
    assert '"device": "cpu"' in train.stdout and "epoch   1" in train.stdout
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--ckpt", ck,
         "--users", "0", "3", "--topk", "5", "--batched-requests", "16"],
        env=env, capture_output=True, text=True, timeout=300)
    assert serve.returncode == 0, serve.stderr
    assert "batched: 16 requests" in serve.stdout
    users = np.arange(0, 40, 3)
    want_s, want_i = JServingEngine.from_checkpoint(ck, use_kernel=False).topk(users, 5)
    got_s, got_i = ServingEngine.from_checkpoint(ck, device="cpu").topk(users, 5)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
