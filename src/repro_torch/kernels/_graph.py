"""What a call launched on the card, as the CUDA driver recorded it: the
call captured once in a CUDA graph, the graph's kernel nodes read back
through the driver API (``cuGraphGetNodes``, ``cuGraphKernelNodeGetParams``,
``cuFuncGetName``). This witness observes the launches themselves, apart
from any record a kernel's own dispatch keeps about them; it needs no
profiler, whose device records can come back empty in a long process.

    names = launched_functions(lambda: flash_gqa(q, k, v))

``function_name`` strips a mangled C++ name to its function's
identifier, which is how the wrappers' ``BODY_KERNELS`` name them.
"""
from __future__ import annotations

import ctypes
import re

import torch

_KERNEL_NODE = 0                    # CU_GRAPH_NODE_TYPE_KERNEL
_driver = None


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _cuda() -> ctypes.CDLL:
    global _driver
    if _driver is None:
        _driver = ctypes.CDLL("libcuda.so.1")
    return _driver


def _check(res: int, what: str):
    if res:
        raise RuntimeError(f"{what}: CUresult {res}")


def _node_name(drv: ctypes.CDLL, node: ctypes.c_void_p) -> str:
    p = _KernelNodeParams()
    _check(drv.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
           "cuGraphKernelNodeGetParams_v2")
    name = ctypes.c_char_p()
    if p.func and not drv.cuFuncGetName(ctypes.byref(name),
                                        ctypes.c_void_p(p.func)):
        return name.value.decode()
    # a node launched through a CUkernel (the runtime's lazy loading)
    _check(drv.cuKernelGetName(ctypes.byref(name),
                               ctypes.c_void_p(p.kern or p.func)),
           "cuKernelGetName")
    return name.value.decode()


def graph_kernels(graph: int) -> list[str]:
    """The mangled names of the kernel nodes of CUDA graph ``graph`` (a
    ``cudaGraph_t``), in the driver's node order."""
    drv = _cuda()
    n = ctypes.c_size_t(0)
    _check(drv.cuGraphGetNodes(ctypes.c_void_p(graph), None,
                               ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(drv.cuGraphGetNodes(ctypes.c_void_p(graph), nodes,
                               ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        _check(drv.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value == _KERNEL_NODE:
            names.append(_node_name(drv, ctypes.c_void_p(node)))
    return names


def launched_functions(fn) -> list[str]:
    """The functions (``function_name`` of each kernel) that one call of
    ``fn`` launches on the current CUDA stream: ``fn`` runs once first (so
    that what it builds, copies or caches on its first call lies outside
    the capture), then once captured in a CUDA graph that is never
    replayed (``torch.cuda.graph`` captures on a stream of its own). The
    order is the driver's node order."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    torch.cuda.synchronize()
    return [function_name(n) for n in graph_kernels(g.raw_cuda_graph())]


_LENGTH = re.compile(r"(\d+)")


def function_name(mangled: str) -> str:
    """The identifier of the function a mangled C++ (Itanium ABI) name
    names, without its namespaces, template arguments and parameters:
    ``_Z19flash_gqa_fwd_wgmmaILi64ELi64EEvv...`` -> ``flash_gqa_fwd_wgmma``,
    ``_ZN12_GLOBAL__N_15splitEv`` -> ``split``. A name that is not mangled
    (an ``extern "C"`` kernel) is its own."""
    if not mangled.startswith("_Z"):
        return mangled
    nested = mangled.startswith("_ZN")
    i = 3 if nested else 2
    last = mangled
    while i < len(mangled):
        m = _LENGTH.match(mangled, i)
        if m is None:
            break
        n = int(m.group(1))
        last = mangled[m.end():m.end() + n]
        i = m.end() + n
        if not nested:
            break
    return last
