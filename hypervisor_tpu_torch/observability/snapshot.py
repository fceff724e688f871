"""The ONE digest-over-rule-input-fields rule, shared.

Three planes freeze host-side snapshots and content-address them by
their rule inputs only: the autopilot's `SignalSnapshot`, the
fleet rollup's `FleetSnapshot`, and the incident bundles. Until this
module, each hand-rolled the same four steps —
`dataclasses.asdict`, pop the advisory fields, canonical-JSON the
remainder, sha256 — and a drift in any copy would silently fork the
replay contract (same seeded run, different digest) that gates 6j/6k
pin bit-for-bit.

The contract, stated once:

* **Rule inputs** are every field a deterministic decision/replay rule
  reads. They go into the digest.
* **Advisory fields** ride the same frozen structure for operators
  (wall-clock walls, burn states contaminated by measured latency,
  scrape errors) but are EXCLUDED — they may differ across replays of
  the same seeded trace without perturbing identity.
* **Quantization happens in the caller**, before digesting: each
  snapshot knows which of its floats carry measurement jitter (`now`
  to 6 decimals, floor distances to 1) and rounds them itself, because
  the rounding rule is part of that snapshot's schema, not of the
  encoding.

`rule_digest` is the encoding half: canonical JSON (sorted keys,
`default=list` so tuples/deques encode as arrays) piped into sha256.
Changing this function changes every digest in the system — treat it
as append-only like the registries hvlint guards.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping, Sequence


def canonical_blob(payload: Mapping[str, Any]) -> str:
    """The canonical JSON encoding every digest hashes: sorted keys,
    tuples/sets/deques coerced to arrays via `default=list`."""
    return json.dumps(payload, sort_keys=True, default=list)


def rule_digest(
    payload: Mapping[str, Any], advisory: Sequence[str] = ()
) -> str:
    """sha256 hexdigest over the canonical encoding of `payload` with
    the `advisory` keys popped. The caller quantizes jittery floats
    BEFORE calling (see module docstring)."""
    clean = dict(payload)
    for k in advisory:
        clean.pop(k, None)
    return hashlib.sha256(canonical_blob(clean).encode()).hexdigest()


def snapshot_digest(snap: Any, quantize=None) -> str:
    """Digest a frozen dataclass snapshot by the shared rule: asdict,
    pop `_ADVISORY_FIELDS`, apply the caller's `quantize(payload)`
    hook (mutates in place — this is where `now`/floor rounding
    lives), then `rule_digest`. The hook runs AFTER the advisory pop
    so it only ever sees rule-input fields."""
    payload = dataclasses.asdict(snap)
    advisory = getattr(snap, "_ADVISORY_FIELDS", ())
    for k in advisory:
        payload.pop(k, None)
    if quantize is not None:
        quantize(payload)
    return rule_digest(payload)


__all__ = ["canonical_blob", "rule_digest", "snapshot_digest"]
