"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``<kernel>/csrc/<kernel>.cu`` under this package is compiled on
first use into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/<kernel>-<hash>.so <source>

The library lands in ``kernels/build/`` (ignored by git) under a name that
carries a hash of the source and the flags, so an edited source is never
served by a stale build. ``-Xptxas=-v`` output (registers, shared memory,
spills per kernel) is kept beside it as ``<kernel>-<hash>.log``.
Nothing here runs at import time, and only sources in this package are
compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = KERNELS / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(KERNELS.glob("*/csrc/*.cu"))


def _source(name: str) -> Path:
    src = KERNELS / name / "csrc" / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    return src


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels are built on a machine with "
                           "the CUDA toolkit")
    return nvcc


def target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(srcs: list[Path] | None = None) -> dict[str, Path]:
    """Compile each source whose library is missing, one nvcc process per
    source, all started together. -> {kernel name: library path}."""
    srcs = sources() if srcs is None else srcs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s.stem: target(s) for s in srcs}
    todo = [s for s in srcs if not out[s.stem].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = []
    for s in todo:
        tmp = Path(f"{out[s.stem]}.{os.getpid()}.tmp")
        log = open(out[s.stem].with_suffix(".log"), "wb")
        p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)],
                             stdout=log, stderr=subprocess.STDOUT)
        procs.append((s, tmp, log, p))
    failed = []
    for s, tmp, log, p in procs:
        rc = p.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out[s.stem])
        else:
            failed.append(f"{s}: nvcc exited {rc}:\n"
                          + out[s.stem].with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The compiler's report for kernel ``name`` (after ``build``)."""
    return target(_source(name)).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The shared library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([_source(name)])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
