"""Native (C++) host components, loaded through ctypes.

Copied from the JAX package's `native/`: the `.tbl` parser
(`tbl_parser.cpp`) and the TPC-H generator that writes the binary columnar
format (`tpch_datagen.cpp`). Both are host code; the device work is the
CUDA kernels under `csrc/`. A library is compiled with g++ at its first
use into `native/_build/` (never at import) and loaded with ctypes;
`tbl_library()` returns None when no toolchain is available, and the
`.tbl` loader then parses in Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "_build")
_LIBS = {}


def _compile(src: str, out: str) -> None:
    """g++ into a temporary file beside `out`, then renamed over it: a
    process loading the library never sees a half-written one."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
               src, "-o", tmp, "-pthread"]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(name: str) -> ctypes.CDLL:
    """Load lib<name>.so, compiling <name>.cpp when it is missing or older
    than its source."""
    if name in _LIBS:
        return _LIBS[name]
    src = os.path.join(_DIR, f"{name}.cpp")
    out = os.path.join(_BUILD, f"lib{name}.so")
    if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
        _compile(src, out)
    lib = ctypes.CDLL(out)
    _LIBS[name] = lib
    return lib


def loaded_path(name: str) -> Optional[str]:
    """The file lib<name> was loaded from in this process, None if it was
    not loaded."""
    lib = _LIBS.get(name)
    return None if lib is None else lib._name


def tbl_library() -> Optional[ctypes.CDLL]:
    """The .tbl parser library, or None when no toolchain is available."""
    try:
        lib = load_library("tbl_parser")
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return None
    lib.tbl_count_rows.restype = ctypes.c_int64
    lib.tbl_count_rows.argtypes = [ctypes.c_char_p]
    lib.tbl_parse.restype = ctypes.c_void_p
    lib.tbl_parse.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                              ctypes.POINTER(ctypes.c_int32),
                              ctypes.POINTER(ctypes.c_void_p),
                              ctypes.c_int64]
    lib.tbl_dict_size.restype = ctypes.c_int64
    lib.tbl_dict_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.tbl_dict_bytes.restype = ctypes.c_int64
    lib.tbl_dict_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.tbl_dict_fetch.restype = None
    lib.tbl_dict_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                   ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.tbl_free.restype = None
    lib.tbl_free.argtypes = [ctypes.c_void_p]
    return lib
