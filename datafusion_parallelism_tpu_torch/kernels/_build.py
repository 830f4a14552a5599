"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All sources under `csrc/` compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes): one
nvcc per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -I csrc -c csrc/<kernel>.cu -o <kernel>.cu.o   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o kernels/_build/libdfp_torch_kernels.so *.cu.o

The library is built at first CUDA use into `kernels/_build/` (listed in
.gitignore) and rebuilt when a hash of the sources changes. A failed build
raises with nvcc's stderr; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "kernels", "_build")
_LIB = os.path.join(_BUILD, "libdfp_torch_kernels.so")
_STAMP = _LIB + ".sha256"

P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> float:
    """Compile the library if it is missing or stale; returns the seconds
    the build took (0.0 when it was up to date)."""
    digest = _source_hash()
    if os.path.exists(_LIB) and os.path.exists(_STAMP):
        with open(_STAMP) as f:
            if f.read().strip() == digest:
                return 0.0
    work = os.path.join(_BUILD, f"objects.{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-I", _CSRC]
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    objects, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = os.path.join(work, os.path.basename(src) + ".o")
        cmd = [_nvcc(), *flags, "-c", src, "-o", obj]
        objects.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    tmp = os.path.join(work, "libdfp_torch_kernels.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objects]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, _LIB)
    shutil.rmtree(work, ignore_errors=True)
    with open(_STAMP, "w") as f:
        f.write(digest)
    return time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built if needed."""
    build()
    return ctypes.CDLL(_LIB)


@functools.cache
def function(name: str, argtypes: tuple, restype=ctypes.c_int):
    """A C entry point of the library with its signature declared: every
    pointer and the stream as c_void_p, sizes as c_int / c_int64."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def check(err: int, name: str) -> None:
    """Raise if a C launcher returned a nonzero cudaGetLastError()."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
            device: torch.device = None, contiguous: bool = True) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this dtype (and shape
    and device, where given): what every kernel of the library takes (a
    kernel that reads through strides checks them itself: contiguous=False)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream(device: torch.device) -> int:
    """The current CUDA stream of `device`, as the C launchers take it."""
    return torch.cuda.current_stream(device).cuda_stream


class DeviceLimits(ctypes.Structure):
    """The device properties launches are planned by (csrc/device_limits.cu)."""
    _fields_ = [("smem_block", ctypes.c_longlong), ("smem_sm", ctypes.c_longlong),
                ("l2_bytes", ctypes.c_longlong), ("sms", ctypes.c_longlong)]


@functools.cache
def _device_limits(index: int) -> DeviceLimits:
    out = DeviceLimits()
    check(function("dfp_device_limits", (I32, P))(index, ctypes.byref(out)), "device_limits")
    return out


def device_limits(device: torch.device) -> DeviceLimits:
    """Shared memory a block may opt into and an SM holds, L2 bytes and SMs
    of a CUDA device, read from it once."""
    return _device_limits(device.index if device.index is not None
                          else torch.cuda.current_device())
