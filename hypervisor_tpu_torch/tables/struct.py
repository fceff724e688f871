"""Table plumbing: dataclasses of tensors with packed virtual columns.

The torch counterpart of `hypervisor_tpu.tables.struct`. A table is a
dataclass whose fields are tensors; hot tables pack same-dtype columns
into one [N, W] block, and `@table(packed=..., slices=...)` installs a
read property per virtual column (`t.sigma_eff` is the view
`t.f32[:, 1]`), so the column order and dtypes match the JAX layout bit
for bit. `replace` folds virtual-column updates back into a COPY of
their block (functional, like the reference); the wave ops write the
blocks in place instead (see each op's docstring).
"""

from __future__ import annotations

import dataclasses
from typing import TypeVar

import torch

T = TypeVar("T")


def table(cls: type[T] | None = None, *, packed=None, slices=None):
    """Decorator: dataclass of tensors with optional virtual columns
    (`packed`: name -> (block, column)) and virtual multi-column slices
    (`slices`: name -> (block, start, stop))."""

    def wrap(c: type[T]) -> type[T]:
        c = dataclasses.dataclass(c)
        fields = {f.name for f in dataclasses.fields(c)}
        virtual = dict(packed or {})
        sliced = dict(slices or {})
        clash = (set(virtual) | set(sliced)) & fields
        if clash:
            raise ValueError(f"virtual names shadow real fields: {clash}")
        c._PACKED = virtual
        c._SLICES = sliced
        # Indexed from the last axis, so a table stacked over a leading
        # tenant axis ([T, N, W] blocks) reads [T, N] columns.
        for name, (block, idx) in virtual.items():
            setattr(
                c, name,
                property(lambda self, _b=block, _i=idx: getattr(self, _b)[..., _i]),
            )
        for name, (block, start, stop) in sliced.items():
            setattr(
                c, name,
                property(
                    lambda self, _b=block, _s=start, _e=stop:
                    getattr(self, _b)[..., _s:_e]
                ),
            )
        return c

    return wrap if cls is None else wrap(cls)


def replace(obj: T, **changes) -> T:
    """`dataclasses.replace` that understands virtual columns and slices:
    each virtual update is written into a copy of its block."""
    packed = getattr(type(obj), "_PACKED", {})
    sliced = getattr(type(obj), "_SLICES", {})
    real = {k: v for k, v in changes.items() if k not in packed and k not in sliced}
    blocks: dict[str, torch.Tensor] = {}
    for name, value in changes.items():
        if name in packed:
            block_name, start = packed[name]
            stop = start + 1
            target = (slice(None), start)
        elif name in sliced:
            block_name, start, stop = sliced[name]
            target = (slice(None), slice(start, stop))
        else:
            continue
        if block_name not in blocks:
            base = real.pop(block_name, getattr(obj, block_name))
            blocks[block_name] = base.clone()
        block = blocks[block_name]
        block[target] = torch.as_tensor(value, device=block.device).to(block.dtype)
    real.update(blocks)
    return dataclasses.replace(obj, **real)


def tensors(obj) -> dict[str, torch.Tensor]:
    """The table's real (stored) columns by field name, in field order."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def clone(obj: T) -> T:
    """A deep copy of every column (e.g. to keep a pre-wave snapshot of a
    table the wave is about to update in place)."""
    return dataclasses.replace(
        obj, **{k: v.clone() for k, v in tensors(obj).items()}
    )


def copy_into(dst: T, src: T) -> None:
    """Overwrite `dst`'s columns in place with `src`'s (same shapes)."""
    for name, t in tensors(src).items():
        getattr(dst, name).copy_(t)


def stack(objs: list[T]) -> T:
    """One table of the same class whose every column stacks the given
    tables' columns along a new leading axis (a new contiguous tensor
    each): the tenant arena's `[T, ...]` layout."""
    first = objs[0]
    return dataclasses.replace(
        first, **{k: torch.stack([tensors(o)[k] for o in objs]) for k in tensors(first)}
    )


def tenant_view(obj: T, t: int) -> T:
    """Tenant `t`'s slice of a stacked table: every column the view
    `col[t]`, contiguous, so writes through it land in the stack."""
    return dataclasses.replace(obj, **{k: v[t] for k, v in tensors(obj).items()})


def footprint(obj, capacity_rows: int) -> dict:
    """The shared health-plane `footprint()` protocol, one rule for every
    table and ring: the bytes of the dataclass's tensor fields plus the
    caller-named row capacity. Pure metadata (`numel` and element size),
    so it reads nothing from the device."""
    return {
        "bytes": int(sum(
            v.numel() * v.element_size()
            for v in (getattr(obj, f.name) for f in dataclasses.fields(obj))
            if isinstance(v, torch.Tensor)
        )),
        "capacity_rows": int(capacity_rows),
    }
