"""On-demand g++ build + ctypes loader for the native grid evaluator.

The library is host code, not a kernel: g++ builds it with the
reference's flags, at first use, into the package's build directory
(engine/build.py build_dir(): build/torch_kernels/ at the repository
root, or CYCLONUS_TORCH_BUILD_DIR), named by a digest of fast_oracle.cpp
and the flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing is written into the package directory.  No pybind11:
the C ABI boundary is a single function over flat buffers, loaded with
ctypes.
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
from typing import Optional

_SRC = Path(__file__).resolve().parent / "fast_oracle.cpp"

GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
#: linked after the source, as the reference's command line has it
GXX_LINK = ("-pthread",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock
_error: Optional[str] = None  # guarded-by: _lock


class NativeUnavailable(Exception):
    """g++ missing or the shared library failed to build/load."""


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    from ..engine.build import build_dir

    flags = " ".join(GXX_FLAGS + GXX_LINK).encode()
    digest = hashlib.sha256(_SRC.read_bytes() + flags).hexdigest()[:16]
    return build_dir() / f"libfast_oracle-{digest}.so"


def build() -> float:
    """Compile the library unless it is present.  Returns the seconds
    the build took (0.0 when it was already built); raises
    NativeUnavailable when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return 0.0
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeUnavailable("g++ not found on PATH")
    from ..engine.build import temp_path

    out.parent.mkdir(parents=True, exist_ok=True)
    # pid-unique temp so concurrent builders can't interleave writes; the
    # final os.replace is atomic
    tmp = temp_path(out)
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(_SRC), *GXX_LINK]
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except subprocess.TimeoutExpired as e:
            raise NativeUnavailable(f"g++ build timed out: {e}") from e
        if proc.returncode != 0:
            raise NativeUnavailable(f"g++ build failed:\n{proc.stderr[-2000:]}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """Build (if absent) and load the library; raises NativeUnavailable.
    A failure is remembered: later calls raise it without another g++."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise NativeUnavailable(_error)
        try:
            # holding _lock across the build is the point: concurrent
            # callers wait for the library rather than race a second g++
            build()
            path = library_path()
            lib = ctypes.CDLL(str(path))
            fn = lib.cyclonus_evaluate_grid
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8),
            ]
            _lib = lib
            return lib
        except NativeUnavailable as e:
            _error = str(e)
            raise
        except OSError as e:
            _error = f"failed to load the native library: {e}"
            raise NativeUnavailable(_error) from e
