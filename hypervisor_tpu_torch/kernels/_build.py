"""Builds the port's CUDA sources into shared libraries and loads them.

Each `csrc/<name>.cu` compiles on first use with nvcc into
`hypervisor_tpu_torch/_build/<name>-<hash>.so` (a plain C interface,
bound with ctypes), where the hash covers the sources and the flags, so
an edited source rebuilds and an unchanged one is reused. `build_all`
starts one nvcc per source, all together. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("mtu", "wave", "sha256", "saga", "liability")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = BUILD_DIR / f"{name}.log"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return target, tmp, proc


def _finish(name: str, started) -> None:
    if started is None:
        return
    target, tmp, proc = started
    if proc.wait() != 0:
        log = (BUILD_DIR / f"{name}.log").read_text()
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, target)


def build_all() -> dict[str, str]:
    """Build every source that is out of date, one nvcc each, in
    parallel; returns {name: ptxas report} from each build log."""
    started = {name: _start(name) for name in SOURCES}
    for name, s in started.items():
        _finish(name, s)
    reports = {}
    for name in SOURCES:
        log = BUILD_DIR / f"{name}.log"
        reports[name] = log.read_text() if log.exists() else ""
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function `symbol` of csrc/<name>.cu with its argument types
    declared (every pointer and the stream as c_void_p)."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise when a C entry of csrc/<name>.cu returned a CUDA error (its
    cudaGetLastError after the launch): a refused launch never runs, and
    a later synchronize would not report it."""
    if err != 0:
        describe = getattr(library(name), f"hv_{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} ({describe(err).decode()})")
