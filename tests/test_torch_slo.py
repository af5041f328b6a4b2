"""The port's SLO controller held against the JAX reference on the CPU: the
control law (both controllers fed the same latency window, queue depth,
expiries and quality statistics), the floor measured at attach, the
per-class rates, ``rate_eps``, ``maybe_tick``, the application fan-out
(engine swap, publisher pin, the fleet's rolling rollout), the queue's
latency window, the report; and the serve and online launchers with a
fleet and the controller on.

Tolerances: action sequences, base and per-class rates, applied class and
swap flags identical; thresholds within 1e-6 of the reference's (exactly
0.0 at rate 0).  The factors are N(0, 0.1^2), so mu/sigma is near 0, well
inside the range where the port's Eq. 8 bracket and the reference's agree
(mu/sigma >= -10, ROADMAP C1).  After an apply the engine answers bitwise
as a fresh engine at the applied thresholds.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest

from repro.serving import engine as jengine
from repro.serving import slo as jslo
from repro.core import threshold as jthreshold
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import threshold
from repro_torch.launch import online as online_launch
from repro_torch.launch import serve as serve_launch
from repro_torch.online import SnapshotPublisher
from repro_torch.serving import LatencyWindow, SLOConfig, SLOController
from repro_torch.serving.fleet import ServingFleet, make_message
from tests.fleet_parity import (
    CPU,
    batch,
    engine,
    fields,
    port_params,
    port_updater,
    ref_params,
)

SM, SN, SK = 30, 240, 16
THRESHOLD_TOL = 1e-6


def _fields(seed=0):
    return fields(SM, SN, SK, seed=seed)


def _config(cls=SLOConfig, **kw):
    base = dict(p99_budget_ms=50.0, min_window=8, tick_interval_s=0.0)
    base.update(kw)
    return cls(**base)


def _quality(window_mae, events=200, window_events=50, ema_mae=0.5):
    return SimpleNamespace(events=events, window_events=window_events, window_mae=window_mae,
                           window_rmse=window_mae * 1.2, mae=0.6, rmse=0.8, ema_mae=ema_mae,
                           ema_rmse=0.7)


# Each scenario: config overrides, then ticks of (latencies [(s, class)],
# depth, cumulative expiries, quality stats or None).
SCENARIOS = {
    "p99-breach": ({}, [([(0.120, 0)] * 32, 0, 0, None)]),
    "apply-at-rate-0": ({"min_rate": 0.0}, [([], 0, 0, None), ([(0.120, 0)] * 32, 0, 0, None)]),
    "depth-alone": ({"depth_high": 10}, [([], 50, 0, None), ([], 50, 0, None)]),
    "expiry": ({}, [([], 0, 3, None), ([], 0, 3, None)]),
    "degrade-then-relax": ({}, [([(0.120, 0)] * 32, 0, 0, None)]
                           + [([(0.001, 0)] * 2048, 0, 0, None)] * 4),
    "relax-to-floor-0": ({"min_rate": 0.0}, [([(0.120, 0)] * 32, 0, 0, None)] * 2
                         + [([(0.001, 0)] * 2048, 0, 0, None)] * 12),
    "clamp-at-max": ({"max_rate": 0.5, "depth_high": 1}, [([], 100, 0, None)] * 10),
    "quality-wins": ({"depth_high": 1}, [([(0.120, 0)] * 32, 100, 0, None),
                                         ([], 100, 0, _quality(1.0)),
                                         ([], 100, 0, None)]),
    "quality-needs-drift": ({}, [([], 0, 0, _quality(9.0, events=10, window_events=10)),
                                 ([], 0, 0, _quality(0.55))]),
    "classes": ({"background_offset": 0.2, "class_offsets": {7: 0.05}},
                [([(0.120, 5)] * 32, 0, 0, None), ([(0.120, 0)] * 16, 0, 0, None),
                 ([(0.120, 7)] * 40, 0, 0, None)]),
    "rate-eps": ({"depth_high": 1, "step_up": 0.001, "rate_eps": 0.01},
                 [([], 100, 0, None)] * 6),
    "mixed": ({"depth_high": 20, "max_rate": 0.7},
              [([(0.02 * (1 + j % 5), j % 3) for j in range(64)], 5 * t, t // 3, None)
               for t in range(12)]),
}


def _drive(pkg, cfg_kw, steps, params_fields):
    """Run one scenario through a controller of ``pkg``; returns the
    decisions as dicts and the counters."""
    ref = pkg == "ref"
    params = ref_params(params_fields) if ref else port_params(params_fields)
    window = (jslo.LatencyWindow if ref else LatencyWindow)(4096)
    state = {"depth": 0, "expired": 0}
    cfg = _config(jslo.SLOConfig if ref else SLOConfig, **cfg_kw)
    ctl = (jslo.SLOController if ref else SLOController)(
        config=cfg, window=window, depth_fn=lambda: state["depth"],
        expired_fn=lambda: state["expired"], params_fn=lambda: params)
    out = []
    for lat, depth, expired, quality in steps:
        for s, c in lat:
            window.record(s, priority=c)
        state["depth"], state["expired"] = depth, expired
        if quality is not None:
            ctl.quality_hook()(quality)
        out.append(ctl.tick().as_dict())
    counters = {k: getattr(ctl, k) for k in ("ticks", "degrades", "relaxes", "quality_relaxes",
                                              "swaps", "floor_rate", "base_rate")}
    return out, counters, ctl


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_control_law_matches_the_reference(name):
    cfg_kw, steps = SCENARIOS[name]
    f = _fields(seed=len(name))
    got, got_counters, _ = _drive("port", cfg_kw, steps, f)
    want, want_counters, _ = _drive("ref", cfg_kw, steps, f)
    assert got_counters == want_counters
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("tick", "action", "depth", "expired", "completed", "base_rate", "rates",
                    "applied_class", "applied_rate", "swapped"):
            assert g[key] == w[key], (key, g, w)
        for key in ("p50_ms", "p99_ms"):
            assert g[key] == w[key] or (np.isnan(g[key]) and np.isnan(w[key])), key
        for key in ("t_p", "t_q"):
            assert g[key] == pytest.approx(w[key], abs=THRESHOLD_TOL), key
            if g["swapped"] and g["applied_rate"] == 0.0:
                assert g[key] == 0.0 == w[key]   # rate 0 is exactly dense
    if name == "apply-at-rate-0":
        assert got[0]["swapped"] and got[0]["t_q"] == 0.0 == got[0]["t_p"]
    if name == "relax-to-floor-0":
        assert got[-1]["applied_rate"] == 0.0 and got[-1]["action"] == "hold"


def test_swap_timings_record_every_swap():
    """The controller times each swap's solve and apply itself: one entry
    per swapped decision, with that decision's tick, rate and thresholds."""
    cfg_kw, steps = SCENARIOS["degrade-then-relax"]
    decisions, counters, ctl = _drive("port", cfg_kw, steps, _fields())
    swapped = [d for d in decisions if d["swapped"]]
    assert counters["swaps"] == len(swapped) == len(ctl.swap_timings) >= 2
    for d, t in zip(swapped, ctl.swap_timings):
        assert (t["tick"], t["rate"], t["t_p"], t["t_q"]) == (
            d["tick"], d["applied_rate"], d["t_p"], d["t_q"])
        assert t["solve_ms"] >= 0.0 and t["apply_ms"] >= 0.0


def test_report_and_decision_keys_are_the_references():
    f = _fields()
    cfg_kw, steps = SCENARIOS["p99-breach"]
    (_, _, got), (_, _, want) = (_drive(pkg, cfg_kw, steps, f) for pkg in ("port", "ref"))
    rep, jrep = got.report(), want.report()
    assert set(rep) == set(jrep)
    assert set(rep["last_decision"]) == set(jrep["last_decision"])
    assert rep["last_decision"]["action"] == "degrade" and rep["applied_t_q"] > 0.0
    for key in ("ticks", "degrades", "swaps", "floor_rate", "base_rate", "applied_rate", "rates"):
        assert rep[key] == jrep[key], key
    json.dumps(rep)


def test_floor_is_the_pruned_fraction_measured_at_attach():
    """The relax floor is the model's own pruned fraction of ``q`` at the
    served ``T_q``, the same in both packages."""
    f = _fields(seed=1)
    t_q = float(threshold.threshold_for_rate(threshold.measure_stats(port_params(f).q), 0.3))
    win = LatencyWindow(32)
    for _ in range(32):
        win.record(0.001)
    eng = engine(port_params(f), t_q, t_q)
    ctl = SLOController(eng, config=_config(), window=win, depth_fn=lambda: 0,
                        expired_fn=lambda: 0)
    jeng = jengine.ServingEngine(ref_params(f), t_q, t_q)
    jctl = jslo.SLOController(jeng, config=_config(), window=jslo.LatencyWindow(32),
                              depth_fn=lambda: 0, expired_fn=lambda: 0)
    want = float(jthreshold.empirical_pruned_fraction(ref_params(f).q, t_q))
    assert ctl.floor_rate == jctl.floor_rate == want > 0.2
    for _ in range(5):
        ctl.tick()
    assert ctl.base_rate == ctl.floor_rate
    eng.stop()


def test_maybe_tick_rate_limits():
    params = port_params(_fields())
    ctl = SLOController(config=SLOConfig(tick_interval_s=30.0), window=LatencyWindow(16),
                        depth_fn=lambda: 0, expired_fn=lambda: 0, params_fn=lambda: params)
    assert ctl.maybe_tick() is not None
    assert ctl.maybe_tick() is None
    assert ctl.ticks == 1


# ---------------------------------------------------------------------------
# application fan-out
# ---------------------------------------------------------------------------


def _slow_window(n=32, latency_s=0.120):
    win = LatencyWindow(64)
    for _ in range(n):
        win.record(latency_s)
    return win


def test_an_apply_serves_bitwise_as_a_fresh_engine_at_those_thresholds():
    params = port_params(_fields())
    eng = engine(params)
    eng.topk(np.arange(8), 5)
    ctl = SLOController(eng, config=_config(depth_high=1), window=_slow_window(),
                        depth_fn=lambda: 100, expired_fn=lambda: 0)
    users = np.arange(SM)
    for _ in range(3):
        d = ctl.tick()
        assert d.swapped and d.t_q > 0.0
        assert float(eng.t_q) == np.float32(d.t_q) and float(eng.t_p) == np.float32(d.t_p)
        fresh = engine(params, np.float32(d.t_p), np.float32(d.t_q))
        for got, want in zip(eng.topk(users, 5), fresh.topk(users, 5)):
            np.testing.assert_array_equal(got, want)
    eng.stop()


def test_the_publisher_pin_survives_a_publish():
    rng = np.random.default_rng(0)
    params = port_params(_fields())
    eng = engine(params)
    upd = port_updater(params)
    pub = SnapshotPublisher(eng, upd)
    ctl = SLOController(eng, config=_config(), window=_slow_window(), depth_fn=lambda: 0,
                        expired_fn=lambda: 0, publisher=pub)
    d = ctl.tick()
    assert d.t_q > 0.0 and float(eng.t_q) == np.float32(d.t_q)
    upd.apply(batch(rng, SM, SN))
    pub.publish()                              # new params, the pinned thresholds
    assert float(eng.t_q) == np.float32(d.t_q) and float(eng.t_p) == np.float32(d.t_p)
    fresh = engine(upd.params, np.float32(d.t_p), np.float32(d.t_q))
    for got, want in zip(eng.topk(np.arange(SM), 5), fresh.topk(np.arange(SM), 5)):
        np.testing.assert_array_equal(got, want)
    pub.clear_serving_thresholds()
    upd.apply(batch(rng, SM, SN))
    pub.publish()
    assert float(eng.t_q) == float(upd.t_q)
    eng.stop()


def test_the_fleet_rolls_the_thresholds_out_and_keeps_them_through_a_delta():
    params = port_params(_fields())
    fleet = ServingFleet(params, 0.0, 0.0, replicas=2, engine_kwargs=CPU)
    try:
        ctl = SLOController(config=_config(), window=_slow_window(), depth_fn=lambda: 0,
                            expired_fn=lambda: 0, router=fleet.router)
        d = ctl.tick()
        assert d.t_q > 0.0
        for rep in fleet.replicas:
            assert float(rep.engine.t_q) == np.float32(d.t_q)
        upd = port_updater(params, seed=1)
        upd.apply(batch(np.random.default_rng(1), SM, SN))
        fleet.apply_update(make_message(upd.snapshot(), 1, 0, full=False))
        fresh = engine(upd.params, np.float32(d.t_p), np.float32(d.t_q))
        want = fresh.topk(np.arange(SM), 5)
        for rep in fleet.replicas:
            assert rep.version == 1 and float(rep.engine.t_q) == np.float32(d.t_q)
            for got, w in zip(rep.engine.topk(np.arange(SM), 5), want):
                np.testing.assert_array_equal(got, w)
        # unpinning: the next replicated snapshot serves the model's thresholds
        assert fleet.router.apply_thresholds(None, None) == {"r0": 1, "r1": 1}
        upd.apply(batch(np.random.default_rng(2), SM, SN))
        fleet.apply_update(make_message(upd.snapshot(), 2, 1, full=False))
        assert all(float(rep.engine.t_q) == float(upd.t_q) for rep in fleet.replicas)
    finally:
        fleet.close()


def test_queue_latency_feeds_the_controller():
    eng = engine(port_params(_fields()))
    queue = eng.start()
    try:
        for f in [eng.submit(u, 5) for u in range(8)]:
            f.result(timeout=60)
        assert queue.latency.count >= 8
        ctl = SLOController(eng, queue=queue, config=_config(min_window=4,
                                                               p99_budget_ms=1e9))
        assert ctl.window is queue.latency
        d = ctl.tick()
        assert d.completed >= 8 and np.isfinite(d.p99_ms) and d.action in ("hold", "relax")
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# the launchers with a fleet and the controller
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("slo_ck"))
    params = port_params(fields(120, 400, 16, seed=3))
    t = threshold.thresholds_from_matrices(params.p, params.q, 0.3)
    ckpt.save(path, 1, {"params": params, "t_p": t[0].numpy(), "t_q": t[1].numpy()})
    return path


def test_serve_launcher_runs_a_fleet_under_the_slo(small_ckpt, capsys):
    serve_launch.main(["--ckpt", small_ckpt, "--device", "cpu", "--replicas", "2",
                       "--concurrent", "400", "--clients", "4", "--topk", "5",
                       "--slo-p99-ms", "5000", "--slo-tick-ms", "5"])
    out = capsys.readouterr().out
    assert "# fleet: 2 local replicas on cpu" in out and "# slo: p99 budget" in out
    report = json.loads(out.strip().splitlines()[-1])
    assert report["requests"] == 400 and not report["slo_violated"]
    assert report["slo"]["ticks"] >= 1 and report["slo"]["swaps"] >= 1


def test_serve_launcher_exits_non_zero_when_the_slo_is_violated(small_ckpt, capsys):
    with pytest.raises(SystemExit, match="SLO violated"):
        serve_launch.main(["--ckpt", small_ckpt, "--device", "cpu", "--concurrent", "200",
                           "--clients", "4", "--topk", "5", "--slo-p99-ms", "0.0001",
                           "--slo-tick-ms", "5"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["slo_violated"] and report["slo"]["ticks"] >= 1


def test_online_launcher_runs_a_supervised_fleet_under_the_slo(tmp_path, capsys):
    report_path = tmp_path / "report.json"
    online_launch.main(["--device", "cpu", "--scale", "0.03", "--k", "8", "--train-epochs",
                        "2", "--events", "300", "--batch-events", "32", "--swap-every", "3",
                        "--clients", "2", "--replicas", "2", "--supervise",
                        "--slo-p99-ms", "5000", "--json", str(report_path)])
    out = capsys.readouterr().out
    assert "# supervisor armed" in out and "# slo: p99 budget" in out
    report = json.loads(report_path.read_text())
    assert report["requests_failed"] == 0 and report["requests_ok"] > 0
    assert report["replica_versions"] == {"r0": report["final_version"],
                                          "r1": report["final_version"]}
    assert report["final_version"] == report["swaps"] == 4 and report["publisher_lag"] == 0
    assert report["wire_bytes_total"] > 0 and report["failures"]["deaths"] == 0
    assert report["slo"]["ticks"] >= 1 and not report["slo_violated"]
