"""Build the port's CUDA kernels and host libraries and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``csrc/build/`` (listed in ``.gitignore``). The library file name carries a
hash of its source and of every header in ``csrc/`` (``*.cuh``), so an
edited kernel or header rebuilds and a stale library is never loaded.
``build()`` starts one ``nvcc`` per source, all at once.

A variant build compiles one source with compile-time defines (``-D``), so
that one source gives several libraries, as the decode kernel's stage cuts
(``SPTPU_DECODE_STAGE``) do. A variant's file name carries its defines
beside the hash, which covers them too, so it never collides with the
production library of the same source.

The grammar backend's host code (``csrc/fsm.cpp``, ``csrc/pda.cpp``: the
token walks that fill a grammar state's vocabulary mask) builds the same way
with the host compiler (``$CXX``, else ``g++``) into the same directory,
named by a hash of its source and flags (``build_host``, ``load_host``). A
failed build raises: the caller that asked for the native library gets no
quiet fallback.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine that has no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]
KERNEL_SOURCES = (
    "paged_decode_attention",
    "paged_extend_attention",
    "w4a8_matmul",
    "w4a16_matmul",
    "delta_matmul",
    "decode_ablate",
)

HOST_SOURCES = ("fsm", "pda")  # csrc/<name>.cpp
HOST_FLAGS = ["-O2", "-shared", "-fPIC"]

_loaded: dict[tuple, ctypes.CDLL] = {}
_host_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _define_flags(defines: dict) -> list[str]:
    return [f"-D{k}={v}" for k, v in sorted(defines.items())]


def _lib_path(name: str, defines: dict | None = None) -> Path:
    flags = NVCC_FLAGS + _define_flags(defines or {})
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.name.encode() + h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(flags).encode()).hexdigest()[:12]
    tag = "".join(f"-{k}={v}" for k, v in sorted((defines or {}).items()))
    return BUILD_DIR / f"lib{name}-{digest}{tag}.so"


def _target(t) -> tuple[str, dict]:
    return (t, {}) if isinstance(t, str) else (t[0], dict(t[1]))


def _target_label(t) -> str:
    name, defines = _target(t)
    return name + "".join(f" {k}={v}" for k, v in sorted(defines.items()))


def build(targets=KERNEL_SOURCES) -> dict[str, dict]:
    """Compile every target that has no up-to-date library, one ``nvcc``
    process per target, all started together. A target is a source name or
    a ``(name, {define: value})`` variant. Returns ``{label: {"seconds": s,
    "log": compiler stderr}}``, the label being the name and each define;
    raises if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for t in targets:
        name, defines = _target(t)
        out = _lib_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, *_define_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[_target_label(t)] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
            time.monotonic(),
        )
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.monotonic() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a half-written .so
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(
    name: str, functions: dict[str, tuple[list, object]], defines: dict | None = None
) -> ctypes.CDLL:
    """Load (building if needed) ``lib<name>``, or its variant built with
    ``defines``, declaring ``argtypes`` and ``restype`` for each entry of
    ``functions``."""
    key = (name, tuple(sorted((defines or {}).items())))
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    path = _lib_path(name, defines)
    if not path.exists():
        build([(name, defines or {})])
    lib = ctypes.CDLL(str(path))
    for fn_name, (argtypes, restype) in functions.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    _loaded[key] = lib
    return lib


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_same_device(q, *others) -> None:
    """Every input of a kernel wrapper on q's device: the wrapper picks the
    kernel or its plain version by q's device."""
    for t in others:
        if t.device != q.device:
            raise ValueError(f"inputs on {t.device} and {q.device}: one device expected")


# ------------------------------------------------------- host libraries


def host_compiler() -> str:
    return os.environ.get("CXX") or "g++"


def host_lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cpp").read_bytes()
    digest = hashlib.sha1(src + " ".join(HOST_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_host(names=HOST_SOURCES) -> dict[str, dict]:
    """Compile every host library of ``names`` that has no up-to-date
    build, one compiler process each, all started together; returns
    ``{name: {"seconds": s, "log": compiler output}}`` and raises if any
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = host_lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
        cmd = [host_compiler(), *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, out, time.monotonic())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.monotonic() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"{host_compiler()} failed for " + "\n".join(failed))
    return report


def load_host(name: str) -> ctypes.CDLL:
    """Load (building if needed) the host library ``lib<name>``; raises if
    it cannot be built or loaded."""
    key = ("host", name)
    with _host_lock:
        lib = _loaded.get(key)
        if lib is None:
            path = host_lib_path(name)
            if not path.exists():
                build_host([name])
            lib = _loaded[key] = ctypes.CDLL(str(path))
        return lib
