"""The plain reference that decides `correct`: NumPy and hashlib only.

It recomputes, from the inputs the harness hands both sides, every answer
the timed path produces: the admission lanes, the session walk, the saga
step, terminate and bond release, the delta chains and Merkle roots, the
action gateway's verdicts and the actors' gateway state, and the headline
pipeline's lanes and consensus sums. It imports nothing of the program
and takes nothing the program made.

Every float32 step takes a `Precision`: float32 is the reference itself;
bfloat16, each result rounded to the nearest bfloat16, is the control
that a lower-precision program would be and that the comparison must
fail.
"""

from __future__ import annotations

import numpy as np


class Precision:
    """Rounds each float result to the working precision."""

    def __init__(self, name: str) -> None:
        if name not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if self.name == "float32":
            return x
        u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
        r = ((u + np.uint64(0x7FFF) + ((u >> np.uint64(16)) & np.uint64(1))) >> np.uint64(16)) \
            << np.uint64(16)
        return r.astype(np.uint32).view(np.float32).reshape(x.shape)

    def scalar(self, x: float) -> np.float32:
        return np.float32(self.q(np.float32(x)))


FLOAT32 = Precision("float32")
BFLOAT16 = Precision("bfloat16")


def differ(got, want) -> np.ndarray:
    """bool per leading index: any element of the program's answer differs
    from the reference's, floats by their bits (exact, -0.0 apart from
    +0.0); a shape that differs fails every index."""
    a, b = np.asarray(got), np.asarray(want)
    if a.shape != b.shape:
        return np.ones(b.shape[:1] if b.ndim else (1,), bool)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        a, b = a.astype(np.float32).view(np.uint32), b.astype(np.float32).view(np.uint32)
    d = a.astype(np.int64) != b.astype(np.int64)
    return d.reshape(d.shape[0], -1).any(axis=1) if d.ndim > 1 else d.reshape(-1)
