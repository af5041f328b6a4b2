"""The example and tool twins of the port, each run through its own
``main`` with ``--device cpu`` at a small size, its gates held: async
results equal sync, a killed store run resumes bitwise, the eviction-armed
launcher bounds residency, no request is dropped and the fleet converges
bitwise after a corrupted delivery.  (On the card ``chip_smoke.py`` runs
the same ``main``s at the reference's defaults.)"""
import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def twin(path):
    """The twin module at ``path`` (from the repo's root), imported by file."""
    name = "twin_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart():
    out = twin("examples/torch_quickstart.py").main(["--device", "cpu", "--scale", "0.05"])
    assert out["work_speedup"] > 1.0
    assert all(v == v for v in out.values())


def test_serve_recommendations():
    out = twin("examples/torch_serve_recommendations.py").main(
        ["--device", "cpu", "--scale", "0.05"])
    assert out["sync_req_s"] > 0 and out["async_req_s"] > 0 and out["launches"] >= 1


def test_train_at_scale(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = twin("examples/torch_train_at_scale.py").main(
        ["--device", "cpu", "--steps", "8", "--batch-size", "512", "--ckpt", ckpt])
    assert round(out["params_m"], 1) == 102.4
    assert out["steps"] > 0 and out["work_speedup"] > 1.0
    assert os.listdir(ckpt)


def test_eval_on_stream():
    out = twin("examples/torch_eval_on_stream.py").main(["--device", "cpu", "--events", "128"])
    assert out["events"] == 128 and out["version"] >= 1


def test_implicit_stream():
    out = twin("examples/torch_implicit_stream.py").main(["--device", "cpu", "--events", "128"])
    assert out["clicks"] == 128 and out["sessions"] == 5


def test_multiarch_dryrun():
    out = twin("examples/torch_multiarch_dryrun.py").main(["--cell", "gat-cora::full_graph_sm"])
    record = out["gat-cora::full_graph_sm"]
    assert record["status"] == "ok" and record["mesh"] == "16x16"


def test_scale_smoke():
    out = twin("tools/torch_scale_smoke.py").main(["--device", "cpu"])
    assert out["slabs"] >= 4 and out["eviction_rounds"] >= 1 and out["live_users"] <= 60


def test_chaos_smoke():
    """Two process replicas, a kill and a respawn: in a process of its own,
    with its own time limit."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools/torch_chaos_smoke.py"),
                           "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=150)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "chaos-smoke: all gates passed" in proc.stdout


@pytest.mark.parametrize("path", ["examples/torch_quickstart.py",
                                  "tools/torch_scale_smoke.py"])
def test_the_twins_refuse_a_card_that_is_not_there(path, monkeypatch):
    """Without ``--device cpu`` a twin runs on the card, and without one it
    raises rather than carry on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin(path).main([])
