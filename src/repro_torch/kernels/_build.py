"""nvcc build, hashing and ctypes loading shared by every CUDA kernel module.

Each ``csrc/*.cu`` file is one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds).  A library is built at
first use with ``nvcc … -shared`` into ``build/`` at the repository
root, under a name keyed by a hash of its sources and flags, and loaded
with ctypes.  Nothing is built or loaded at import time.

Every source exports ``<name>_error_string(int)`` beside its launch
functions, and every launch function returns ``cudaGetLastError()`` of
its launch; `CudaLibrary.raise_on` turns a non-zero code into an error.
`LaunchCounter` holds a module's launch counts (`capturing_launches` and
`add_launches` move launches recorded by a CUDA-graph capture to the
graph's replays), `check_tensor` is the wrappers' argument check and
`refuse_grad` the dispatchers' refusal to cut an autograd graph at a
kernel without a backward, `refuse_dtensor` their refusal of a sharded
operand, `call_op` the call of the LM kernels' `torch.library` ops;
`ptxas_report` reads each kernel's registers
and spills from a build's compiler report.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Library name → {"path", "seconds" (0 when the hashed library already
# existed), "ptxas" (nvcc's register/spill report)}, filled at build time.
BUILD_INFO: Dict[str, Dict[str, Any]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


class CudaLibrary:
    """One ``.cu`` source: its build, its loaded handle and its entry points.

    ``declare(lib)`` sets ``argtypes``/``restype`` of the launch functions
    once the library is loaded.  ``headers`` are the ``csrc`` files the
    sources include: hashed into the library's name, not passed to nvcc.
    """

    def __init__(self, name: str, sources: Sequence[str],
                 declare: Callable[[ctypes.CDLL], None],
                 headers: Sequence[str] = ()):
        self.name = name
        self.sources = tuple(sources)
        self.headers = tuple(headers)
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the library for the sources, headers and current flags
        lives."""
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in self.sources + self.headers:
            h.update(src.encode())
            h.update((CSRC / src).read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def _command(self, out: Path) -> list:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out),
                *(str(CSRC / s) for s in self.sources)]

    def start_build(self) -> Optional[Tuple[subprocess.Popen, Path, float]]:
        """Start nvcc unless the hashed library exists (then None)."""
        so = self.path()
        if so.exists():
            if BUILD_INFO.get(self.name, {}).get("path") != str(so):
                BUILD_INFO[self.name] = {"path": str(so), "seconds": 0.0,
                                         "ptxas": ""}
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(self._command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        return proc, tmp, time.perf_counter()

    def finish_build(self, started: Optional[Tuple[subprocess.Popen, Path, float]]
                     ) -> Path:
        so = self.path()
        if started is None:
            return so
        proc, tmp, t0 = started
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.name} ({proc.returncode}):\n"
                               f"{' '.join(proc.args)}\n{err}")
        os.replace(tmp, so)                 # atomic: concurrent builds agree
        BUILD_INFO[self.name] = {"path": str(so),
                                 "seconds": time.perf_counter() - t0,
                                 "ptxas": err}
        return so

    def build(self) -> Path:
        return self.finish_build(self.start_build())

    def load(self) -> ctypes.CDLL:
        """Build (first use) and load the library, with typed entry points."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                err_fn = getattr(lib, f"{self.name}_error_string")
                err_fn.argtypes = [ctypes.c_int]
                err_fn.restype = ctypes.c_char_p
                self._declare(lib)
                self._lib = lib
            return self._lib

    def raise_on(self, err: int, kernel: str) -> None:
        if err != 0:
            msg = getattr(self.load(), f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def build_all(libraries: Sequence[CudaLibrary]) -> Dict[str, Dict[str, Any]]:
    """Build every library with one nvcc each, all started together, then
    load them; returns `BUILD_INFO` for those libraries.  Every nvcc is
    waited for before the first failure is raised."""
    started = [(lib, lib.start_build()) for lib in libraries]
    errors = []
    for lib, s in started:
        try:
            lib.finish_build(s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libraries:
        lib.load()
    return {lib.name: BUILD_INFO[lib.name] for lib in libraries}


def ptxas_report(text: str) -> Dict[str, Dict[str, int]]:
    """Each kernel of nvcc's ``-Xptxas -v`` report (a `BUILD_INFO`
    ``"ptxas"`` text): mangled entry name → {"registers", "spill_stores",
    "spill_loads"} (bytes of spills).  Empty when the library was not built
    in this process."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1) if m.group(1) in out else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


class LaunchCounter:
    """Launches per kernel of one module: a wrapper calls `add` where it
    launches its kernel, and nowhere else.  ``routes=True`` marks a
    module's second counter, which counts the same launches by route."""

    def __init__(self, *names: str, routes: bool = False):
        self.counts: Dict[str, int] = {n: 0 for n in names}
        self.routes = routes
        self._lock = threading.Lock()
        _COUNTERS.append(self)

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] += n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)

    def reset(self) -> None:
        with self._lock:
            for k in self.counts:
                self.counts[k] = 0


# Every LaunchCounter made, in the order the modules made them.
_COUNTERS: List[LaunchCounter] = []

# (counter, kernel or route name, launches): what a CUDA-graph capture
# recorded, added to the counters at each replay.
Launches = List[Tuple[LaunchCounter, str, int]]


@contextlib.contextmanager
def capturing_launches(captured: Launches) -> Iterator[None]:
    """Launches made inside the block are recorded by a CUDA-graph capture,
    not run: when the block ends (also by an error) they are taken back out
    of every counter and listed in ``captured``, and `add_launches` counts
    them once for each replay of the graph.  Launches made meanwhile by
    another thread would be listed too."""
    before = [c.snapshot() for c in _COUNTERS]
    try:
        yield
    finally:
        for c, was in zip(list(_COUNTERS), before):
            for name, n in c.snapshot().items():
                if n != was[name]:
                    c.add(name, was[name] - n)
                    captured.append((c, name, n - was[name]))


def add_launches(captured: Launches, times: int = 1) -> None:
    """Count a captured graph's launches ``times`` more times (its replays)."""
    for c, name, n in captured:
        c.add(name, n * times)


def refuse_grad(kernel: str, later: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if autograd would need a gradient through ``kernel``'s launch.

    A ctypes launch is invisible to autograd: without this check the graph
    would be cut there and every input below it would silently get no
    gradient.  Kernels with a backward (flash attention, the GMM, the SSD
    scan) go through their `torch.library` ops' autograd rules instead; ``later`` names the
    slice of the port that brings this kernel's."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} on the card has no backward yet ({later}); "
                           f"run it under torch.no_grad() or detach its inputs")


def call_op(op, needs_grad: bool, *args: Any):
    """``op(*args)``, through its autograd rule only when ``needs_grad``
    (grad mode on and an input requiring a gradient).  Otherwise the call
    goes straight to the device's implementation, as the autograd rule
    itself does on such a call, without the Python autograd kernel's cost
    on the host; dispatch modes (`FakeTensorMode`, `FlopCounterMode`) sit
    below autograd and see the op either way."""
    if needs_grad:
        return op(*args)
    with torch._C._AutoDispatchBelowAutograd():
        return op(*args)


def refuse_dtensor(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if a DTensor reaches ``kernel``: a launch (or its plain
    version) reads one block of memory, so a sharded operand must come as
    its local shard (`repro_torch.distributed.activations`), never
    unwrapped here."""
    from torch.distributed.tensor import DTensor

    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(f"{kernel} got a DTensor; pass its local shard "
                            f"(placements {t.placements})")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 device: torch.device, shape: Optional[tuple] = None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on the CUDA
    ``device`` (and of ``shape``, when given), and not a DTensor."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    refuse_dtensor(name, t)
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must lie on {device} (got {t.device})")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} (got {t.dtype})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape} (got {tuple(t.shape)})")
