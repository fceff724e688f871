"""Each tenant's answers to a call of the tenant arena, worked out plainly,
tenant by tenant.

A tenant of an arena cell is a lifecycle-wave deployment of its own with
no gateway. For call c, tenant t's answers are `facade.call_answers` at
that tenant's own sigma column, vouched lanes and delta bodies; besides,
its sessions' host Merkle frontiers hold their roots, its audit index
holds each session's chain digests in turn order, and its DeltaLog
cursor has advanced by every row its waves appended, one a session a
turn: (c + 1) x sessions x turns.

Each tenant is computed alone, from its own inputs (`gen`: the cell's
traffic, tenant by tenant). Nothing here knows the arena or a tenant's
neighbours, so an answer written into a neighbour's slice, or one
tenant's answers handed out as another's, fails the comparison.
"""

from __future__ import annotations

import functools
import types

import numpy as np

from hvbench.reference import FLOAT32, Precision
from hvbench.reference import facade
from hvbench.reference.audit import words_hex


def call_answers(config: dict, traffic: dict, gen, c: int, prec: Precision = FLOAT32) -> list:
    """Every tenant's answers to call c, in tenant order."""
    out = []
    for t in range(gen.n):
        solo = types.SimpleNamespace(sigma=gen.sigma[t], now=gen.now,
                                     bodies_of=functools.partial(gen.bodies_of, t))
        a = facade.call_answers(config, {**traffic, "vouched": gen.vouched[t]}, solo, c, prec)
        turns, k = a["chain"].shape[:2]
        a["frontier"] = [words_hex(r) for r in a["merkle_root"]]
        a["audit_counts"] = np.full(k, turns, np.int64)
        a["audit_digests"] = np.transpose(a["chain"], (1, 0, 2)).reshape(-1, 8)
        a["delta_cursor"] = (c + 1) * k * turns
        out.append(a)
    return out
