"""The port's cold-row eviction held against the JAX reference on the CPU:
``IdRemap``, ``EvictionConfig``, ``UserEvictor`` (victims, remap, spill
payloads, revived rows), the updater's remapped apply and evaluation, the
publisher's remap barrier (a compaction makes the next payload
``kind=full``), delta chains with ``user_remap`` folded across the two
packages and the engine serving spilled users by the fallback
(``launch/online --evict-max-users`` is tested in ``test_torch_online.py``).

Tolerances: bitwise where no step runs (tables carried across with
``params_from_numpy``, growth drawn from the same numpy generator): the
victims, the remap, every spill payload, revived rows and folded chains;
1e-5 for tables after updater steps; 1e-6 for evaluation MAEs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import mf as jmf
from repro.online import publisher as jpublisher
from repro.online import stream as jstream
from repro.online import updater as jupdater
from repro.serving import engine as jengine
from repro.store import eviction as jeviction
from repro_torch.core import mf
from repro_torch.data.ratings import RatingsDataset
from repro_torch.online import publisher, stream, updater
from repro_torch.serving import ServingEngine
from repro_torch.store import eviction

K, M, N = 6, 24, 40


def _fields(seed, variant="bias", m=M):
    rng = np.random.default_rng(seed)
    out = {"p": rng.normal(0, 0.3, (m, K)).astype(np.float32),
           "q": rng.normal(0, 0.3, (N, K)).astype(np.float32),
           "user_bias": None, "item_bias": None, "global_mean": None, "implicit": None}
    if variant == "bias":
        out.update(user_bias=rng.normal(0, 0.1, (m, 1)).astype(np.float32),
                   item_bias=rng.normal(0, 0.1, (N, 1)).astype(np.float32),
                   global_mean=np.float32(3.0))
    return out


def _state(fields, optimizer, seed):
    """A non-zero optimizer state (so spilled state rows carry values)."""
    rng = np.random.default_rng(seed + 50)
    if optimizer == "sgd":
        return None
    names = {"adagrad": ["acc"], "momentum": ["mom"]}[optimizer]
    return {group: (None if fields[field] is None else {
        name: np.abs(rng.normal(0, 1, fields[field].shape)).astype(np.float32)
        for name in names})
        for group, field in (("p", "p"), ("q", "q"), ("user_bias", "user_bias"),
                             ("item_bias", "item_bias"), ("implicit", "implicit"))}


def _pair(tmp_path, fields, optimizer="sgd", t=0.05, max_users=30, target=20, seed=7,
          state=None):
    """A reference and a port updater on the same tables, each with an
    evictor spilling to its own directory."""
    kw = dict(optimizer=optimizer, lr=0.05, lam=0.02, batch_size=8, seed=seed)
    ref_state = port_state = None
    if state is not None:
        ref_state = jmf.MFOptState(*(None if state[g] is None else {
            k: jnp.asarray(v) for k, v in state[g].items()} for g in jmf.MFOptState._fields))
        port_state = mf.MFOptState(*(None if state[g] is None else {
            k: torch.tensor(v) for k, v in state[g].items()} for g in mf.MFOptState._fields))
    ref = jupdater.OnlineUpdater(
        jmf.MFParams(*(None if fields[n] is None else jnp.asarray(fields[n])
                       for n in jmf.MFParams._fields)), ref_state, t, t, **kw)
    port = updater.OnlineUpdater(mf.params_from_numpy(fields, device="cpu"), port_state, t, t,
                                 device="cpu", **kw)
    for name, upd in (("ref", ref), ("port", port)):
        module = jeviction if name == "ref" else eviction
        upd.attach_evictor(module.UserEvictor(module.EvictionConfig(
            max_users=max_users, spill_dir=str(tmp_path / f"spill_{name}"),
            target_users=target)))
    return ref, port


def _np_tree(params):
    return {n: None if v is None else np.asarray(v.numpy() if hasattr(v, "numpy") else v)
            for n, v in params._asdict().items()}


def _assert_tables(port, ref, exact=True, tol=1e-5):
    g, w = _np_tree(port.params), _np_tree(ref.params)
    for name in g:
        assert (g[name] is None) == (w[name] is None), name
        if g[name] is None:
            continue
        if exact:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
        else:
            np.testing.assert_allclose(g[name], w[name], rtol=tol, atol=tol, err_msg=name)
    for group in ("p", "user_bias"):
        gs, ws = getattr(port.opt_state, group), getattr(ref.opt_state, group)
        for key in (gs or {}):
            if exact:
                np.testing.assert_array_equal(gs[key].numpy(), np.asarray(ws[key]))
            else:
                np.testing.assert_allclose(gs[key].numpy(), np.asarray(ws[key]), rtol=tol,
                                           atol=tol)


def _assert_evictors(port_ev, ref_ev):
    np.testing.assert_array_equal(port_ev.remap.ext_to_phys, ref_ev.remap.ext_to_phys)
    assert port_ev.remap.epoch == ref_ev.remap.epoch
    np.testing.assert_array_equal(port_ev.phys_to_ext, ref_ev.phys_to_ext)
    np.testing.assert_array_equal(port_ev.last_touched, ref_ev.last_touched)
    np.testing.assert_array_equal(port_ev.spilled_external_ids(), ref_ev.spilled_external_ids())
    assert (port_ev.evictions, port_ev.revivals, port_ev.compactions) == (
        ref_ev.evictions, ref_ev.revivals, ref_ev.compactions)


def _assert_spill_files(port_ev, ref_ev):
    files = sorted({path for path, _ in ref_ev._spilled.values()})
    assert sorted({path.replace("spill_port", "spill_ref")
                   for path, _ in port_ev._spilled.values()}) == files
    for path in files:
        with np.load(path) as want, np.load(path.replace("spill_ref", "spill_port")) as got:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# IdRemap and EvictionConfig
# ---------------------------------------------------------------------------


def test_idremap_matches_the_reference():
    table = np.array([0, -1, 1, 4, -1], np.int32)
    got, want = eviction.IdRemap(table.copy(), epoch=3), jeviction.IdRemap(table.copy(), epoch=3)
    ids = np.array([0, 1, 2, 3, 4, 7, -2])
    np.testing.assert_array_equal(got.lookup(ids), want.lookup(ids))
    assert got.lookup(ids).tolist() == [0, -1, 1, 4, -1, -1, -1]
    assert got.num_external == want.num_external == 5
    frozen = got.as_array()
    frozen[0] = 99
    assert got.ext_to_phys[0] == 0 and frozen.dtype == np.int32


@pytest.mark.parametrize("max_users,target", [(10, 11), (10, 0), (10, None)])
def test_eviction_config_validates_as_the_reference(tmp_path, max_users, target):
    cfgs = [module.EvictionConfig(max_users=max_users, spill_dir=str(tmp_path),
                                  target_users=target) for module in (eviction, jeviction)]
    if target is None:
        assert cfgs[0].resolved_target() == cfgs[1].resolved_target() == 8
        return
    for module, cfg in zip((eviction, jeviction), cfgs):
        with pytest.raises(ValueError, match="target_users"):
            module.UserEvictor(cfg)


def test_bind_rejects_svdpp(tmp_path):
    fields = _fields(0)
    y = np.zeros((N + 1, K), np.float32)
    fields["implicit"] = y
    hist = np.full((M, 4), N, np.int32)
    upd = updater.OnlineUpdater(mf.params_from_numpy(fields, device="cpu"), None, 0.0, 0.0,
                                user_history=hist, device="cpu")
    with pytest.raises(ValueError, match="SVD"):
        upd.attach_evictor(eviction.UserEvictor(eviction.EvictionConfig(
            max_users=10, spill_dir=str(tmp_path))))


# ---------------------------------------------------------------------------
# the evictor against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["funk", "bias"])
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "momentum"])
def test_evictor_matches_the_reference_bitwise(tmp_path, variant, optimizer):
    """No step runs: the tables stay carried-across copies and growth draws
    the same numpy rows, so victims (ranks at T > 0, then the touch clock),
    remap, spill payloads and revived rows agree bit for bit."""
    fields = _fields(1, variant)
    ref, port = _pair(tmp_path, fields, optimizer, state=_state(fields, optimizer, 1))
    rng = np.random.default_rng(3)
    for upd in (ref, port):
        assert upd.resolve_users(np.array([], np.int32)).size == 0
    for step in range(6):
        ext = rng.integers(0, M + 3 * step, 10).astype(np.int32)  # grows the domain
        np.testing.assert_array_equal(port.resolve_users(ext), ref.resolve_users(ext))
    assert port.num_users == ref.num_users > 30
    _assert_tables(port, ref)
    reports = [upd.evictor.maybe_evict() for upd in (ref, port)]
    assert reports[0] is not None and port.num_users == ref.num_users == 20
    for key, value in reports[0].items():
        assert reports[1][key] == value, key
    assert {"ranks_ms", "sort_ms", "spill_ms", "compact_ms", "spill_bytes"} <= set(reports[1])
    _assert_evictors(port.evictor, ref.evictor)
    _assert_spill_files(port.evictor, ref.evictor)
    _assert_tables(port, ref)
    assert port._layout_dirty and ref._layout_dirty
    assert port._touched_users == ref._touched_users
    # touching spilled users revives them: bitwise the spilled rows
    spilled = port.evictor.spilled_external_ids()[::2].astype(np.int32)
    np.testing.assert_array_equal(port.resolve_users(spilled), ref.resolve_users(spilled))
    _assert_evictors(port.evictor, ref.evictor)
    _assert_tables(port, ref)
    assert port.evictor.maybe_evict() is None and ref.evictor.maybe_evict() is None


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_evicting_updater_matches_the_reference(tmp_path, optimizer):
    """Updater steps on external ids with compactions in between: at T = 0
    the victims depend on the touch clock alone, so the remap agrees
    exactly; the tables within 1e-5; the remapped evaluation within 1e-6."""
    fields = _fields(2)
    ref, port = _pair(tmp_path, fields, optimizer, t=0.0, max_users=28, target=20)
    rng = np.random.default_rng(5)
    for i in range(8):
        ext_max = M + 4 * i
        users = rng.integers(0, ext_max, 16).astype(np.int32)
        items = rng.integers(0, N, 16).astype(np.int32)
        rating = rng.uniform(1, 5, 16).astype(np.float32)
        port.apply(stream.EventBatch(user=users, item=items, rating=rating))
        ref.apply(jstream.EventBatch(user=users, item=items, rating=rating))
        if i % 3 == 2:
            got, want = port.evictor.maybe_evict(), ref.evictor.maybe_evict()
            assert (got is None) == (want is None)
        _assert_evictors(port.evictor, ref.evictor)
        _assert_tables(port, ref, exact=False)
    assert port.evictor.compactions >= 1 and port.evictor.revivals > 0
    test = RatingsDataset(rng.integers(0, M + 40, 300).astype(np.int32),
                          rng.integers(0, N, 300).astype(np.int32),
                          rng.uniform(1, 5, 300).astype(np.float32), M + 40, N)
    got, want = port.evaluate(test, batch_size=128), ref.evaluate(test, batch_size=128)
    assert abs(got - want) <= 1e-6 * abs(want)
    snap_got, snap_want = port.snapshot(), ref.snapshot()
    np.testing.assert_array_equal(snap_got.user_remap, snap_want.user_remap)
    assert snap_got.remap_epoch == snap_want.remap_epoch == port.evictor.remap.epoch


def test_compaction_never_writes_a_published_version(tmp_path):
    """Compaction makes new tables; the version a snapshot handed out keeps
    its tensors bit for bit, and revival writes only the updater's own."""
    fields = _fields(4)
    _, port = _pair(tmp_path, fields, t=0.05, max_users=26, target=18)
    port.resolve_users(np.arange(M + 6, dtype=np.int32))
    snap = port.snapshot()
    held = {n: v.clone() for n, v in snap.params._asdict().items() if v is not None}
    assert port.evictor.maybe_evict() is not None
    port.resolve_users(port.evictor.spilled_external_ids()[:3].astype(np.int32))
    port.apply(stream.EventBatch(user=np.arange(20, dtype=np.int32),
                                 item=np.arange(20, dtype=np.int32) % N,
                                 rating=np.full(20, 4.0, np.float32)))
    for name, value in held.items():
        assert torch.equal(getattr(snap.params, name), value), name
    assert port.params.p.data_ptr() != snap.params.p.data_ptr()


# ---------------------------------------------------------------------------
# publisher, engine, delta chains
# ---------------------------------------------------------------------------


def _drive(upd, pub, ev, rng, module_stream, *, publishes=6):
    kinds = []
    for i in range(publishes):
        upd.apply(module_stream.EventBatch(
            user=rng.integers(0, 20 + 6 * i, 16).astype(np.int32),
            item=rng.integers(0, N, 16).astype(np.int32),
            rating=rng.uniform(1, 5, 16).astype(np.float32)))
        bumped = i >= 2 and ev.maybe_evict() is not None
        kinds.append((bumped, pub.publish().kind))
    return kinds


def test_remap_bump_publishes_full_and_chains_fold_across_packages(tmp_path):
    fields = _fields(6, m=20)
    ref, port = _pair(tmp_path, fields, t=0.0, max_users=30, target=24)
    engines = {"ref": jengine.ServingEngine(ref.params, 0.0, 0.0),
               "port": ServingEngine(port.params, 0.0, 0.0, device="cpu")}
    pubs = {"ref": jpublisher.SnapshotPublisher(engines["ref"], ref,
                                                checkpoint_dir=str(tmp_path / "ref_chain"),
                                                keep=32),
            "port": publisher.SnapshotPublisher(engines["port"], port,
                                                checkpoint_dir=str(tmp_path / "port_chain"),
                                                keep=32)}
    kinds = {name: _drive(upd, pubs[name], upd.evictor, np.random.default_rng(7), module)
             for name, upd, module in (("ref", ref, jstream), ("port", port, stream))}
    for pub in pubs.values():
        pub.close()
    assert kinds["port"] == kinds["ref"]
    assert any(bumped for bumped, _ in kinds["port"])
    for bumped, kind in kinds["port"]:
        if bumped:
            assert kind == "full"
    assert engines["port"].remap_epoch == engines["ref"].remap_epoch == port.evictor.remap.epoch
    _assert_tables(port, ref, exact=False)

    base_fields = _fields(6, m=20)
    for chain, live in (("port_chain", port), ("ref_chain", ref)):
        for folder in ("port", "ref"):
            extras = {}
            if folder == "port":
                folded, _, _, _, last = publisher.fold_deltas(
                    str(tmp_path / chain), mf.params_from_numpy(base_fields, device="cpu"),
                    0.0, 0.0, extras=extras)
            else:
                folded, _, _, _, last = jpublisher.fold_deltas(
                    str(tmp_path / chain),
                    jmf.MFParams(*(None if base_fields[n] is None else jnp.asarray(base_fields[n])
                                   for n in jmf.MFParams._fields)), 0.0, 0.0, extras=extras)
            assert last == pubs["port"].version == 6
            np.testing.assert_array_equal(extras["user_remap"], live.evictor.remap.as_array())
            assert extras["remap_epoch"] == live.evictor.remap.epoch
            got, want = _np_tree(folded), _np_tree(live.params)
            for name in ("p", "q", "user_bias", "item_bias"):
                np.testing.assert_array_equal(got[name], want[name], err_msg=(chain, folder, name))

    # the engine serves every external user as a fresh engine on the version
    users = np.arange(port.evictor.remap.num_external, dtype=np.int32)
    fresh = ServingEngine(port.params, 0.0, 0.0, device="cpu",
                          user_remap=port.evictor.remap.as_array(),
                          remap_epoch=port.evictor.remap.epoch)
    s_live, i_live = engines["port"].topk(users, 5)
    s_fresh, i_fresh = fresh.topk(users, 5)
    np.testing.assert_array_equal(i_live, i_fresh)
    np.testing.assert_array_equal(s_live, s_fresh)
    spilled = port.evictor.spilled_external_ids()
    assert spilled.size
    fs, fi = engines["port"]._snap.fallback_topk(5)
    bias = port.params.item_bias[:, 0] + port.params.global_mean
    want_s, want_i = torch.sort(bias, descending=True, stable=True)
    np.testing.assert_array_equal(fi, want_i[:5].numpy())
    np.testing.assert_array_equal(i_live[spilled], np.broadcast_to(fi, (spilled.size, 5)))
    np.testing.assert_array_equal(s_live[spilled], np.broadcast_to(want_s[:5].numpy(),
                                                                   (spilled.size, 5)))
    r_s, r_i = engines["ref"].topk(users, 5)
    np.testing.assert_array_equal(i_live, np.asarray(r_i))
    np.testing.assert_allclose(s_live, np.asarray(r_s), rtol=1e-5, atol=1e-5)


def test_delta_after_the_barrier_keeps_following(tmp_path):
    """The publish after a compaction is full; the next one, touching only
    resident users, is a delta again with the remap intact."""
    fields = _fields(8, m=20)
    _, port = _pair(tmp_path, fields, t=0.0, max_users=28, target=20)
    engine = ServingEngine(port.params, 0.0, 0.0, device="cpu")
    pub = publisher.SnapshotPublisher(engine, port)
    rng = np.random.default_rng(3)

    def batch(users):
        return stream.EventBatch(user=users.astype(np.int32),
                                 item=rng.integers(0, N, users.size).astype(np.int32),
                                 rating=rng.uniform(1, 5, users.size).astype(np.float32))

    port.apply(batch(rng.integers(0, 20, 16)))
    assert pub.publish().kind == "delta"
    port.apply(batch(rng.integers(0, 40, 16)))
    assert port.evictor.maybe_evict() is not None
    assert pub.publish().kind == "full"
    live_ext = np.flatnonzero(port.evictor.remap.ext_to_phys >= 0)
    port.apply(batch(rng.choice(live_ext, 16)))
    assert pub.publish().kind == "delta"
    assert engine.remap_epoch == port.evictor.remap.epoch == 1
    users = np.arange(port.evictor.remap.num_external, dtype=np.int32)
    ref = ServingEngine(port.params, port.t_p, port.t_q, device="cpu",
                        user_remap=port.evictor.remap.as_array(), remap_epoch=1)
    for a, b in zip(engine.topk(users, 5), ref.topk(users, 5)):
        np.testing.assert_array_equal(a, b)


class _OneRankMesh:
    """A (1, 1) ("data", "model") mesh of this process alone: what the port's
    mesh-backed updater reads of a ``DeviceMesh`` to cut its blocks."""

    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return 1

    def get_coordinate(self):
        return [0, 0]


def test_mesh_backed_updater_refuses_eviction_as_the_reference(tmp_path):
    """ROADMAP C8: neither package evicts on a mesh.  Both ``attach_evictor``
    hand the updater to ``UserEvictor.bind``, which raises ValueError
    ("single-host") for a mesh-backed updater, called through the updater
    or directly.  Both updaters stay unarmed, and the same evictor arms an
    updater without a mesh."""
    import jax
    from jax.sharding import Mesh

    fields = _fields(3, variant="funk")
    kw = dict(optimizer="sgd", lr=0.05, lam=0.02, batch_size=8)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    ref = jupdater.OnlineUpdater(
        jmf.MFParams(*(None if fields[n] is None else jnp.asarray(fields[n])
                       for n in jmf.MFParams._fields)), None, 0.05, 0.05, mesh=jmesh, **kw)
    port = updater.OnlineUpdater(mf.params_from_numpy(fields, device="cpu"), None, 0.05, 0.05,
                                 mesh=_OneRankMesh(), device="cpu", **kw)
    assert port.mesh is not None and tuple(port.params.p.shape) == (M, K)

    def evictor(module, name):
        return module.UserEvictor(module.EvictionConfig(
            max_users=30, spill_dir=str(tmp_path / name), target_users=20))

    with pytest.raises(ValueError, match="single-host"):
        ref.attach_evictor(evictor(jeviction, "ref"))
    ev = evictor(eviction, "port")
    with pytest.raises(ValueError, match="single-host"):
        port.attach_evictor(ev)
    with pytest.raises(ValueError, match="single-host"):
        ev.bind(port)
    assert port.evictor is None and ev.updater is None
    single = updater.OnlineUpdater(mf.params_from_numpy(fields, device="cpu"), None, 0.05, 0.05,
                                   device="cpu", **kw)
    single.attach_evictor(ev)
    assert single.evictor is ev and ev.updater is single
