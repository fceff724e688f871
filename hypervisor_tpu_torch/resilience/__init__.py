"""Resilience plane: WAL crash consistency, recovery, degraded mode.

The counterpart of `hypervisor_tpu.resilience`:

  * `wal` — the write-ahead intent log journaled around every
    state-mutating dispatch in `hypervisor_tpu_torch.state`.
  * `recovery` — restore = newest durable checkpoint + audit-chain
    verification + deterministic replay of the committed WAL suffix,
    onto a state on the caller's device (CUDA by default).
  * `policy` — the degraded-mode policy and the admission-rate sybil
    damper the state enforces at its dispatch sites.

  * `supervisor` — the retry ladder with backoff over injected chaos
    faults, watermarked periodic checkpoints, the degraded-mode switch
    driven by the health plane's events, and the restore rung.

`policy` is a leaf module (`state.py` imports it for enforcement);
`recovery` resolves lazily to avoid the state <-> recovery import cycle.
"""

from hypervisor_tpu_torch.resilience.policy import (
    AdmissionDamper,
    DegradedModeRefusal,
    DegradedPolicy,
    SybilShedRefusal,
)
from hypervisor_tpu_torch.resilience.wal import WalRecord, WriteAheadLog, scan

__all__ = [
    "AdmissionDamper",
    "DegradedModeRefusal",
    "DegradedPolicy",
    "SybilShedRefusal",
    "RecoveryError",
    "Supervisor",
    "WalRecord",
    "WriteAheadLog",
    "checkpoint_with_watermark",
    "latest_durable_checkpoint",
    "recover",
    "replay",
    "scan",
    "verify_audit_heads",
]


def __getattr__(name):
    # recovery imports HypervisorState (which imports this package for
    # the policy); resolve lazily to avoid the cycle.
    if name in (
        "RecoveryError",
        "checkpoint_with_watermark",
        "latest_durable_checkpoint",
        "recover",
        "replay",
        "verify_audit_heads",
    ):
        from hypervisor_tpu_torch.resilience import recovery

        return getattr(recovery, name)
    if name == "Supervisor":
        from hypervisor_tpu_torch.resilience.supervisor import Supervisor

        return Supervisor
    raise AttributeError(name)
