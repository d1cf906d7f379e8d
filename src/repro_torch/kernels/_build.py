"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``<kernel>/csrc/<kernel>.cu`` under this package is compiled on
first use into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/<kernel>-<hash>.so <source>

The library lands in ``kernels/build/`` (ignored by git) under a name that
carries a hash of the source, of every header (``*.cuh``, ``*.h``) beside
it in ``csrc/`` and of the flags, so an edited source or header is never
served by a stale build. ``-Xptxas=-v`` output (registers, shared memory,
spills per kernel) is kept beside it as ``<kernel>-<hash>.log``;
``resources`` reads it, and ``tensor_core_ops`` counts the tensor-core
instructions in the library's SASS. Nothing here runs at import time, and
only sources in this package are compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


def headers(src: Path) -> list[Path]:
    """The headers a kernel's source may include: those in its csrc/."""
    return sorted([*src.parent.glob("*.cuh"), *src.parent.glob("*.h")])


def target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in headers(src):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
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


def _demangle(names: list[str]) -> dict[str, str]:
    filt = shutil.which("c++filt")
    if not filt or not names:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def parse_ptxas(log: str) -> dict[str, dict]:
    """{kernel function: {"registers", "smem_bytes", "spill_stores",
    "spill_loads"}} from a ``-Xptxas=-v`` report (shared memory is the
    static part; the kernels here take theirs dynamically)."""
    res: dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            cur = m.group(1)
            res.setdefault(cur, {"registers": 0, "smem_bytes": 0,
                                 "spill_stores": 0, "spill_loads": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            res[cur]["spill_stores"] = int(m.group(1))
            res[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            res[cur]["smem_bytes"] = int(m.group(1)) if m else 0
    return res


def resources(name: str) -> dict[str, dict]:
    """``parse_ptxas`` of kernel ``name``'s build log, by demangled
    function name (after ``build``)."""
    res = parse_ptxas(build_log(name))
    names = _demangle(sorted(res))
    return {names[k]: v for k, v in res.items()}


def count_tensor_core_ops(sass: str, kinds=("HMMA", "HGMMA")
                          ) -> dict[str, int]:
    """{function: tensor-core instructions of ``kinds``} in ``cuobjdump
    -sass`` text: HMMA (``mma.sync``) and HGMMA (``wgmma``) by default."""
    op = re.compile(r"\b(" + "|".join(kinds) + r")\b")
    counts: dict[str, int] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and op.search(line):
            counts[cur] += 1
    return counts


def tensor_core_ops(name: str, kinds=("HMMA", "HGMMA")
                    ) -> dict[str, int] | None:
    """``count_tensor_core_ops`` of kernel ``name``'s built library, by
    demangled function name; None where cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None
    lib = build([_source(name)])[name]
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = count_tensor_core_ops(sass, kinds)
    names = _demangle(sorted(counts))
    return {names[k]: v for k, v in counts.items()}


def load(name: str) -> ctypes.CDLL:
    """The shared library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([_source(name)])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
