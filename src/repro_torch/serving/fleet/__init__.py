"""Multi-replica serving fleet on one device: replicated engines behind a
cache-aware router, refreshed by compressed delta replication, supervised
for failure.

Counterpart of ``repro/serving/fleet``.  Layers (each its own module):

* :mod:`~repro_torch.serving.fleet.bus`: the wire format
  (:class:`~repro_torch.serving.fleet.bus.DeltaMessage`: the
  delta-checkpoint tree, flattened, losslessly compressed, CRC-stamped) and
  the per-replica :class:`~repro_torch.serving.fleet.bus.VersionGate`
  (idempotent, monotonic, out-of-order-safe; corrupt payloads NAKed before
  the gate);
* :mod:`~repro_torch.serving.fleet.replica`:
  :class:`~repro_torch.serving.fleet.replica.LocalReplica` (in-process) and
  :class:`~repro_torch.serving.fleet.replica.ProcessReplica` (a spawned
  child with its own CUDA context), one engine + queue + gate each; death
  surfaces as :class:`~repro_torch.serving.fleet.replica.ReplicaDiedError`,
  never a stranded future;
* :mod:`~repro_torch.serving.fleet.router`:
  :class:`~repro_torch.serving.fleet.router.Router` (queue-depth load
  balancing, hot-user affinity, priority classes, rolling refresh,
  health-aware failover) and the
  :class:`~repro_torch.serving.fleet.router.ServingFleet` facade;
* :mod:`~repro_torch.serving.fleet.supervisor`:
  :class:`~repro_torch.serving.fleet.supervisor.FleetSupervisor`: heartbeat
  probes, the replica state machine, respawn, convergence-gated
  readmission.

Import layering: this package may import :mod:`repro_torch.online` (the
publisher owns the delta format); nothing in :mod:`repro_torch.online` or
the core serving modules imports the fleet at module import.
"""
from repro_torch.serving.fleet.bus import (
    DeltaMessage,
    EngineDeltaSink,
    VersionGate,
    apply_message,
    make_message,
    payload_checksum,
    state_from_message,
    state_message,
    verify_message,
)
from repro_torch.serving.fleet.replica import (
    LocalReplica,
    ProcessReplica,
    ReplicaDiedError,
)
from repro_torch.serving.fleet.router import (
    NoHealthyReplicaError,
    Router,
    ServingFleet,
)
from repro_torch.serving.fleet.supervisor import (
    FleetSupervisor,
    Incident,
    ReplicaState,
)

__all__ = [
    "DeltaMessage",
    "EngineDeltaSink",
    "VersionGate",
    "apply_message",
    "make_message",
    "payload_checksum",
    "state_from_message",
    "state_message",
    "verify_message",
    "LocalReplica",
    "ProcessReplica",
    "ReplicaDiedError",
    "NoHealthyReplicaError",
    "Router",
    "ServingFleet",
    "FleetSupervisor",
    "Incident",
    "ReplicaState",
]
