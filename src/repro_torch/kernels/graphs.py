"""What a captured CUDA graph holds, read from the graph itself.

Each generated kernel has a name of its own: :func:`name_kernel` renames
a source's ``k1_apply`` (K1) or ``k2_epoch`` (K2) to ``k1_apply_<tag>``,
the tag a hash of the source, and :func:`register` remembers the op each
source was generated for.  After ``torch.cuda.graph`` has captured a step
into ``torch.cuda.CUDAGraph(keep_graph=True)``, and before the graph is
instantiated, :func:`census` walks its nodes through CUDA's graph API in
``libcuda`` (which PyTorch has loaded; called through ``ctypes``) and
counts them: kernel nodes by their kernel's name, memcpy and memset
nodes, and nodes of any other type.  A :class:`GraphCensus` then tells
how many K1 and K2 launches a replay makes, how many of them belong to
given ops, and what else the graph launches.

Only :func:`census` needs a card; the rest runs anywhere.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import re
import threading
import weakref
from typing import Iterable, Optional

K1_KERNEL, K2_KERNEL = "k1_apply", "k2_epoch"
TAG_HEX = 16
_DEFINE = re.compile(rf"^#define ({K1_KERNEL}|{K2_KERNEL}) (\1_[0-9a-f]{{{TAG_HEX}}})$", re.M)

# CUgraphNodeType
_NODE_KERNEL, _NODE_MEMCPY, _NODE_MEMSET = 0, 1, 2


def name_kernel(lines: list, kernel: str) -> str:
    """Join the lines of a generated source whose kernel is ``kernel``,
    with a ``#define`` after its ``#include`` that names the kernel
    ``<kernel>_<tag>``, ``tag`` a hash of the lines."""
    tag = hashlib.sha256("\n".join(lines).encode()).hexdigest()[:TAG_HEX]
    at = next(i for i, line in enumerate(lines) if line.startswith("#include"))
    return "\n".join(lines[:at + 1] + [f"#define {kernel} {kernel}_{tag}"] + lines[at + 1:])


def kernel_name(source: str) -> str:
    """The name of a generated source's kernel (see :func:`name_kernel`)."""
    m = _DEFINE.search(source)
    if m is None:
        raise ValueError("not a generated K1 or K2 source: no kernel name")
    return m.group(2)


_OPS: dict = {}  # kernel name -> weak references to the ops of its source
_OPS_LOCK = threading.Lock()


def register(source: str, op) -> None:
    """Remember that ``source`` (a generated K1 or K2 source) was emitted
    for ``op`` (ops of two artifacts may share one source)."""
    with _OPS_LOCK:
        refs = _OPS.setdefault(kernel_name(source), [])
        refs[:] = [r for r in refs if r() is not None and r() is not op] + [weakref.ref(op)]


def ops_of(name: str) -> list:
    """The live ops whose generated source has a kernel called ``name``
    (as :func:`kernel_name` gives it, or mangled)."""
    m = re.search(rf"(?:{K1_KERNEL}|{K2_KERNEL})_[0-9a-f]{{{TAG_HEX}}}", name)
    with _OPS_LOCK:
        refs = list(_OPS.get(m.group(0), ())) if m else []
    return [op for op in (r() for r in refs) if op is not None]


@dataclasses.dataclass(frozen=True)
class GraphCensus:
    """The nodes of one captured graph: what one replay launches."""

    kernels: dict  # kernel name, as libcuda gives it -> kernel nodes
    memcpy: int = 0
    memset: int = 0
    other: dict = dataclasses.field(default_factory=dict)  # other node type -> nodes

    def _count(self, pred) -> int:
        return sum(n for name, n in self.kernels.items() if pred(name))

    @property
    def k1(self) -> int:
        """Launches of a generated K1 kernel."""
        return self._count(lambda s: f"{K1_KERNEL}_" in s)

    @property
    def k2(self) -> int:
        """Launches of a generated K2 kernel."""
        return self._count(lambda s: f"{K2_KERNEL}_" in s)

    def of(self, ops: Iterable) -> int:
        """Launches of the kernels generated for ``ops``."""
        ids = {id(op) for op in ops}
        return self._count(lambda s: any(id(op) in ids for op in ops_of(s)))

    @property
    def copies(self) -> int:
        """Memcpy nodes and launches of a copy kernel (PyTorch's
        ``copy_``, ``cat``)."""
        return self.memcpy + self._count(lambda s: "copy" in s.lower())

    @property
    def fills(self) -> int:
        """Memset nodes and launches of PyTorch's fill kernel."""
        return self.memset + self._count(lambda s: "FillFunctor" in s)

    def others(self) -> dict:
        """Kernel nodes that are none of K1, K2, a copy or a fill (an
        elementwise op evaluated by PyTorch, say), by name."""
        return {
            name: n for name, n in self.kernels.items()
            if f"{K1_KERNEL}_" not in name and f"{K2_KERNEL}_" not in name
            and "copy" not in name.lower() and "FillFunctor" not in name
        }


class _KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [
        ("func", ctypes.c_void_p),
        ("gridDimX", ctypes.c_uint), ("gridDimY", ctypes.c_uint), ("gridDimZ", ctypes.c_uint),
        ("blockDimX", ctypes.c_uint), ("blockDimY", ctypes.c_uint), ("blockDimZ", ctypes.c_uint),
        ("sharedMemBytes", ctypes.c_uint),
        ("kernelParams", ctypes.c_void_p),
        ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p),
        ("ctx", ctypes.c_void_p),
    ]


_LIBCUDA: Optional[ctypes.CDLL] = None


def _libcuda() -> ctypes.CDLL:
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        vp, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)
        for fn, argtypes in (
            ("cuGraphGetNodes", [vp, vp, ctypes.POINTER(ctypes.c_size_t)]),
            ("cuGraphNodeGetType", [vp, ctypes.POINTER(ctypes.c_int)]),
            ("cuGraphKernelNodeGetParams_v2", [vp, ctypes.POINTER(_KernelNodeParams)]),
            ("cuFuncGetName", [pp, vp]),
            ("cuKernelGetName", [pp, vp]),
        ):
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, ctypes.c_int
        _LIBCUDA = lib
    return _LIBCUDA


def _call(fn: str, *args) -> None:
    status = getattr(_libcuda(), fn)(*args)
    if status != 0:
        raise RuntimeError(f"{fn} failed with CUDA error {status}")


def _name(p: _KernelNodeParams) -> str:
    """The kernel's name: from its function handle, or its library kernel
    handle where the node holds no function."""
    name = ctypes.c_char_p()
    if p.func:
        _call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(p.func))
    else:
        _call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(p.kern))
    return name.value.decode()


def census(graph) -> GraphCensus:
    """Count the nodes of ``graph``, a ``torch.cuda.CUDAGraph`` captured
    with ``keep_graph=True`` and not yet instantiated (its
    ``raw_cuda_graph()`` is libcuda's graph)."""
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _call("cuGraphGetNodes", raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _call("cuGraphGetNodes", raw, nodes, ctypes.byref(n))
    kernels: dict = {}
    other: dict = {}
    copies = sets = 0
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        _call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value == _NODE_KERNEL:
            p = _KernelNodeParams()
            _call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(p))
            name = _name(p)
            kernels[name] = kernels.get(name, 0) + 1
        elif kind.value == _NODE_MEMCPY:
            copies += 1
        elif kind.value == _NODE_MEMSET:
            sets += 1
        else:
            other[kind.value] = other.get(kind.value, 0) + 1
    return GraphCensus(kernels, copies, sets, other)
