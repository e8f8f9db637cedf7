"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each source under ``SOURCES`` compiles on first use into
``build/kernels/<name>-<hash>.so`` at the root of the checkout, the hash
taken over the source, the ``.cuh`` headers of its directory (which it
may include) and the flags, so an edited source or header rebuilds and
an unchanged one loads at once.  A failed build raises with the compiler's
output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from ..device import same_device

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"

# kernel name -> source, relative to this package
SOURCES = {
    "fused_serve": "range_query/csrc/fused_serve.cu",
    "prune_tiles": "range_query/csrc/prune_tiles.cu",
    "leaf_scan": "range_query/csrc/leaf_scan.cu",
    "bitset_mm": "bitset_mm/csrc/bitset_mm.cu",
    "seg_mbr": "forest_build/csrc/seg_mbr.cu",
    "range_query": "range_query/csrc/range_query.cu",
    "segment_bag": "segment_bag/csrc/segment_bag.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from source on first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = _KERNELS / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Tuple[Path, str]:
    """Compile kernel ``name`` unless it is built already.  Returns its
    library path and the compiler's output, kept beside the library
    (``<library>.log``) for a library built earlier."""
    path = library_path(name)
    log = path.with_suffix(".log")
    if path.exists():
        return path, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_KERNELS / SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n{proc.stdout}")
    log.write_text(proc.stdout)
    os.replace(tmp, path)                # atomic: a racing build is harmless
    return path, proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)[0]))
        return lib


def call(name: str, fn: str, argtypes, device: torch.device, *args) -> None:
    """Call the C entry ``fn`` of kernel library ``name`` with ``args``
    and, last, the current stream of ``device``, with ``device`` current.
    Each entry launches on that stream without synchronising and returns
    ``cudaGetLastError()``; raise where it reports an error."""
    f = getattr(load(name), fn)
    f.argtypes = list(argtypes) + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = f(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_aligned(name: str, t: torch.Tensor, nbytes: int = 16) -> None:
    """Raise unless ``t``'s data starts on an ``nbytes`` boundary: what a
    kernel's vector loads and ``cp.async`` copies assume."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must start on a {nbytes}-byte boundary")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
                 device: torch.device) -> None:
    """Raise unless ``t`` lies on ``device`` with this dtype and shape,
    contiguous: what a kernel's raw pointer arithmetic assumes."""
    if not same_device(t.device, device):
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
