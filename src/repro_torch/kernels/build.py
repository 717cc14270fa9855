"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, in ``build/repro_torch/`` at the
root of the checkout (listed in ``.gitignore``).  The library's file name
carries a hash of its sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  :func:`build` starts one
``nvcc`` per source, all at once, and waits for them together.

Nothing here runs when the module is imported: the CPU tests import every
module and this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("flash_attention", "quant_matmul", "packed_matmul",
           "paged_attention", "fake_quant", "binary_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every kernel of ``names`` whose library is missing, in
    parallel.  Returns per kernel ``{"path", "seconds", "cached",
    "ptxas"}`` (``ptxas`` is the compiler's register and shared-memory
    report).  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            out[name] = {"path": str(lib), "seconds": 0.0, "cached": True,
                         "ptxas": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = {"path": str(lib), "cached": False, "ptxas": log,
                     "seconds": time.perf_counter() - t0}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (built first if missing)."""
    return ctypes.CDLL(build([name])[name]["path"])


@dataclasses.dataclass
class LaunchCount:
    """Launches of one kernel: its wrapper adds one where it launches the
    kernel and nowhere else (the plain CPU version does not count).  A
    wrapper whose kernel takes several launch shapes also counts each
    launch under its route in ``routes`` (K2 and K3: ``skinny`` or a
    tensor-core route), so that a profiler trace can be read route by
    route."""
    name: str
    launches: int = 0
    routes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, route: str) -> None:
        self.launches += 1
        self.routes[route] = self.routes.get(route, 0) + 1

    def reset(self) -> None:
        self.launches = 0
        self.routes = {}


def bind(name: str, symbol: str, n_ptr: int, n_int: int,
         tail=()) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of kernel library ``name``: ``n_ptr``
    pointers, ``n_int`` ints, then the ``tail`` ctypes, then the stream."""
    fn = getattr(load(name), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int +
                   list(tail) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code (the value of
    ``cudaGetLastError()`` right after its launch)."""
    if err != 0:
        fn = lib.rt_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name}: CUDA error {err} at launch: "
                           f"{fn(err).decode()}")


def refuse_dtensor(kernel: str, *tensors) -> None:
    """Raise a TypeError naming ROADMAP.md A11 when any of ``tensors`` is
    a DTensor: a kernel takes plain local tensors, and a sharded path
    hands it its shards (``to_local()``), as ``models.layers`` does."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and type(t) is not torch.Tensor:
            from torch.distributed.tensor import DTensor
            if isinstance(t, DTensor):
                raise TypeError(
                    f"{kernel} takes no DTensor (ROADMAP.md A11): hand it "
                    "each rank's local shards (to_local()), as the sharded "
                    "paths in models/layers.py do")


def expect(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim`` dims
    on ``device``: what the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(f"{what}: expected {ndim}-d {dtype}, got "
                         f"{t.ndim}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """SMs of CUDA ``device``, read from the runtime once per card."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def launch(fn, t: torch.Tensor, *args) -> int:
    """``fn(*args, stream)``: a C entry point called with ``t``'s card
    current and PyTorch's current stream there as its last argument;
    returns the entry point's error code.  The card is switched only where
    it is not current already, and the stream is read as a raw pointer:
    a device guard and a ``torch.cuda.Stream`` object cost several
    microseconds of host time a call, which a decode step pays once for
    every kernel it launches."""
    idx = t.device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(idx):
        return fn(*args, stream)
