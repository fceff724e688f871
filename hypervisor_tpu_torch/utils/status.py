"""Per-lane status codes -> the reference's exception types.

Batched device ops never raise: every rejected lane carries an i8 status
code (`ops.admission.ADMIT_*`, `ops.pipeline.PIPE_*`,
`runtime.write_wave.WRITE_*`, `runtime.lock_wave.LOCK_*`). The per-call
facade reproduces the reference's exceptions through the host engines;
batch users get the same contract through this module: one table from
code to (exception class, message template), and `raise_for_status` to
surface the first failure of a wave as the exception the reference
would have raised (reference error surfaces: `session/__init__.py:85-113`,
`session/vector_clock.py:104-149`, `session/intent_locks.py:151-197`,
`security/rate_limiter.py:89-130`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from hypervisor_tpu_torch.ops import admission as _adm
from hypervisor_tpu_torch.session import SessionLifecycleError, SessionParticipantError
from hypervisor_tpu_torch.session.intent_locks import (
    DeadlockError,
    LockContentionError,
)
from hypervisor_tpu_torch.session.vector_clock import CausalViolationError
from hypervisor_tpu_torch.security.rate_limiter import RateLimitExceeded
from hypervisor_tpu_torch.liability.quarantine import QuarantineReason  # noqa: F401


class QuarantinedError(Exception):
    """Write refused: the agent is in read-only isolation."""


#: Admission wave codes (`ops.admission`).
ADMISSION_ERRORS: dict[int, tuple[type, str]] = {
    _adm.ADMIT_BAD_STATE: (
        SessionLifecycleError,
        "Session not accepting joins (state must be HANDSHAKING or ACTIVE)",
    ),
    _adm.ADMIT_DUPLICATE: (
        SessionParticipantError,
        "Agent {who} already in session",
    ),
    _adm.ADMIT_CAPACITY: (
        SessionParticipantError,
        "Session at max participants",
    ),
    _adm.ADMIT_SIGMA_LOW: (
        SessionParticipantError,
        "Agent {who} sigma_eff below session minimum",
    ),
}

def _write_errors() -> dict[int, tuple[type, str]]:
    from hypervisor_tpu_torch.runtime import write_wave as ww

    return {
        ww.WRITE_RATE_LIMITED: (RateLimitExceeded, "Rate limit exceeded for {who}"),
        ww.WRITE_CONFLICT: (CausalViolationError, "Causally stale write by {who}"),
        ww.WRITE_QUARANTINED: (
            QuarantinedError, "Writer {who} is quarantined (read-only)"),
        ww.WRITE_LOCK_REQUIRED: (
            LockContentionError,
            "SERIALIZABLE isolation: {who} holds no write lock on the path"),
    }


def _lock_errors() -> dict[int, tuple[type, str]]:
    from hypervisor_tpu_torch.runtime import lock_wave as lw

    return {
        lw.LOCK_CONTENTION: (LockContentionError, "Lock contention for {who}"),
        lw.LOCK_DEADLOCK: (
            DeadlockError, "Granting the lock to {who} would deadlock"),
    }


#: Write wave codes (`runtime.write_wave`), keyed by its constants.
WRITE_ERRORS: dict[int, tuple[type, str]] = _write_errors()

#: Lock wave codes (`runtime.lock_wave`), keyed by its constants.
LOCK_ERRORS: dict[int, tuple[type, str]] = _lock_errors()


def raise_for_status(
    status: Sequence[int] | np.ndarray,
    table: dict[int, tuple[type, str]] = ADMISSION_ERRORS,
    who: Optional[Sequence[str]] = None,
) -> None:
    """Raise the mapped exception for the FIRST non-zero lane, if any.

    `who` optionally names each lane (DIDs) for the message. Lanes with
    code 0 are successes; unknown codes raise RuntimeError so a new code
    added to an op cannot be silently swallowed.
    """
    arr = np.asarray(status)
    bad = np.nonzero(arr != 0)[0]
    if not len(bad):
        return
    lane = int(bad[0])
    code = int(arr[lane])
    name = who[lane] if who is not None else f"lane {lane}"
    entry = table.get(code)
    if entry is None:
        raise RuntimeError(f"unknown status code {code} for {name}")
    exc_type, template = entry
    raise exc_type(template.format(who=name))


def describe(
    status: Sequence[int] | np.ndarray,
    table: dict[int, tuple[type, str]] = ADMISSION_ERRORS,
) -> list[str]:
    """Human labels per lane ("ok" or the mapped exception name)."""
    out = []
    for code in np.asarray(status).tolist():
        if code == 0:
            out.append("ok")
        else:
            entry = table.get(int(code))
            out.append(entry[0].__name__ if entry else f"unknown({code})")
    return out
