"""Test-only instrumentation: the deterministic fault-injection harness.

Nothing under ``repro_torch.testing`` runs on the hot path in production:
every seam guards on a single module-attribute ``None`` check
(``faults._PLAN is None``) and does no further work when no plan is
installed.
"""
from repro_torch.testing.faults import (  # noqa: F401
    FaultAction,
    FaultError,
    FaultPlan,
    corrupt_message,
    delay_s,
    fire,
    install,
    installed,
    uninstall,
)
