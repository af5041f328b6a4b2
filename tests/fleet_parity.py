"""Shared inputs of the fleet, chaos and SLO parity tests
(``tests/test_torch_{fleet,chaos,slo}.py``): the same numpy factors and event
batches for the JAX reference and the port, messages drawn from each
package's updater, reference wire messages carried over to the port's
types, and the bitwise checks."""
import numpy as np
import jax.numpy as jnp

from repro.core import mf as jmf
from repro.online import EventBatch as JEventBatch
from repro.online import updater as jupdater
from repro_torch.core import mf
from repro_torch.distributed.compression import CompressedArray
from repro_torch.online import EventBatch
from repro_torch.online import updater
from repro_torch.serving import ServingEngine
from repro_torch.serving.fleet import bus

M, N, K = 40, 300, 8
CPU = {"device": "cpu"}


def fields(m=M, n=N, k=K, variant="bias", seed=0, scale=0.1):
    """Factor tables as numpy, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"p": rng.normal(0, scale, (m, k)).astype(np.float32),
           "q": rng.normal(0, scale, (n, k)).astype(np.float32),
           "user_bias": None, "item_bias": None, "global_mean": None, "implicit": None}
    if variant in ("bias", "svdpp"):
        out.update(user_bias=rng.normal(0, 0.1, (m, 1)).astype(np.float32),
                   item_bias=rng.normal(0, 0.1, (n, 1)).astype(np.float32),
                   global_mean=np.float32(3.5))
    if variant == "svdpp":
        y = rng.normal(0, scale, (n + 1, k)).astype(np.float32)
        y[n] = 0.0
        out["implicit"] = y
    return out


def ref_params(f):
    return jmf.MFParams(*(None if f[name] is None else jnp.asarray(f[name])
                          for name in jmf.MFParams._fields))


def port_params(f):
    return mf.params_from_numpy(f, device="cpu")


def np_params(params):
    return {name: None if v is None else np.asarray(v.numpy() if hasattr(v, "numpy") else v)
            for name, v in params._asdict().items()}


def assert_params_equal(got, want):
    """Every table bitwise equal (either package's params)."""
    g, w = np_params(got), np_params(want)
    for name in mf.MFParams._fields:
        assert (g[name] is None) == (w[name] is None), name
        if g[name] is not None:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def events(rng, m=M, n=N, size=24):
    """``(user, item, rating)`` numpy arrays of one batch."""
    return (rng.integers(0, m, size).astype(np.int32), rng.integers(0, n, size).astype(np.int32),
            rng.uniform(1, 5, size).astype(np.float32))


def batch(rng, m=M, n=N, size=24):
    u, i, r = events(rng, m, n, size)
    return EventBatch(user=u, item=i, rating=r)


def ref_batch(u, i, r):
    return JEventBatch(user=u, item=i, rating=r)


def port_updater(params, seed=0, **kw):
    return updater.OnlineUpdater(params, None, 0.0, 0.0, batch_size=32, seed=seed,
                                 device="cpu", **kw)


def ref_updater(params, seed=0, **kw):
    return jupdater.OnlineUpdater(params, None, 0.0, 0.0, batch_size=32, seed=seed, **kw)


def messages(n_publishes=3, m=M, n=N, seed=0, full_at=()):
    """The port's canonical wire sequence: ``n_publishes`` snapshots of a
    port updater as messages, and the updater."""
    rng = np.random.default_rng(seed)
    upd = port_updater(port_params(fields(m, n, seed=seed)), seed=seed)
    msgs = []
    for v in range(1, n_publishes + 1):
        upd.apply(batch(rng, m, n))
        msgs.append(bus.make_message(upd.snapshot(), v, v - 1, full=v in full_at))
    return msgs, upd


def to_port_message(jmsg) -> bus.DeltaMessage:
    """A reference wire message in the port's types (the bytes unchanged)."""
    tree = {key: CompressedArray(v.data, tuple(v.shape), v.dtype, v.codec)
            if hasattr(v, "codec") else np.asarray(v) for key, v in jmsg.tree.items()}
    kw = {name: getattr(jmsg, name) for name in bus.DeltaMessage.__dataclass_fields__}
    kw["tree"] = tree
    return bus.DeltaMessage(**kw)


def engine(params, t_p=0.0, t_q=0.0, **kw):
    return ServingEngine(params, t_p, t_q, device="cpu", **kw)


def assert_serves(engine_like, upd, topk=5):
    """``engine_like`` answers every user bitwise as a fresh port engine on
    the updater's tables and thresholds."""
    ref = engine(upd.params, upd.t_p, upd.t_q)
    users = np.arange(ref.num_users)
    s_ref, i_ref = ref.topk(users, topk)
    s, i = engine_like.topk(users, topk)
    np.testing.assert_array_equal(np.asarray(s), s_ref)
    np.testing.assert_array_equal(np.asarray(i), i_ref)
