"""Builds the port's C and CUDA sources into shared libraries and loads them.

Each `csrc/<name>.cu` compiles on first use with nvcc, and the host
runtime `csrc/hv_runtime.cpp` with g++, into
`hypervisor_tpu_torch/_build/<name>-<hash>.so` (a plain C interface,
bound with ctypes), where the hash covers the sources and the flags, so
an edited source rebuilds and an unchanged one is reused. Each build
writes a file of its own and renames it into place, so processes that
build at once never load a half-written library. `build_all` starts one
nvcc per CUDA source, all together. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("mtu", "wave", "sha256", "saga", "liability")
#: Host C++ sources, built with g++ (the reference's flags).
HOST_SOURCES = ("hv_runtime",)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
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


def _compiler(name: str) -> str:
    if name not in HOST_SOURCES:
        return _nvcc()
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host runtime needs a C++ compiler")
    return found


def _spec(name: str) -> tuple[tuple[str, ...], Path, list[Path]]:
    """(flags, source, headers the hash covers) for csrc/<name>."""
    if name in HOST_SOURCES:
        return GXX_FLAGS, CSRC / f"{name}.cpp", []
    return NVCC_FLAGS, CSRC / f"{name}.cu", sorted(CSRC.glob("*.cuh"))


def _target(name: str) -> Path:
    flags, source, headers = _spec(name)
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    for header in headers:
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = BUILD_DIR / f"{name}.log"
    flags, source, _ = _spec(name)
    cmd = [_compiler(name), *flags, "-o", str(tmp), str(source)]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return target, tmp, proc


def _finish(name: str, started) -> None:
    if started is None:
        return
    target, tmp, proc = started
    if proc.wait() != 0:
        tmp.unlink(missing_ok=True)
        log = (BUILD_DIR / f"{name}.log").read_text()
        raise RuntimeError(f"csrc/{_spec(name)[1].name} did not build:\n{log}")
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


#: Cumulative wall clock, ms, spent building and loading libraries at
#: first use (the health plane's compile telemetry reads it).
load_wall_ms = 0.0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    global load_wall_ms
    lib = _loaded.get(name)
    if lib is None:
        t0 = time.perf_counter()
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
        load_wall_ms += (time.perf_counter() - t0) * 1e3
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
