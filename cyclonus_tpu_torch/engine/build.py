"""Build and load the package's CUDA kernels.

Each source under cyclonus_tpu_torch/csrc/ compiles with nvcc for
sm_90a into a shared library with a plain C interface, loaded with
ctypes (no PyTorch headers: a build takes seconds, not minutes).  The
library lands in build/torch_kernels/ at the repository root (git
ignores it; CYCLONUS_TORCH_BUILD_DIR overrides), named by a digest of
its source, the headers under csrc/ and the flags, so an edited source or
header rebuilds and an unchanged one is reused.

Nothing here runs at import time; the first launch builds.

note_trace feeds cyclonus_tpu_kernel_traces_total: the reference counts
one Pallas trace per (kernel, static shape), and the port counts the
first run of each (kernel, device type, operand shapes) in the process,
so that "dispatches - traces = hits" keeps its meaning.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Set, Tuple

_CSRC = Path(__file__).resolve().parents[1] / "csrc"

#: kernel library name -> its source under csrc/
SOURCES = {"packed_counts": "packed_counts.cu", "dense_counts": "dense_counts.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}

#: (kernel label, device type, operand shapes) already run in this process
_TRACED: Set[Tuple] = set()


def note_trace(kernel: str, device_type: str, shapes: Tuple) -> None:
    """Count KERNEL_TRACES{kernel} at the first run of this kernel label
    at this device type and these operand shapes."""
    key = (kernel, device_type, shapes)
    if key in _TRACED:
        return
    _TRACED.add(key)
    from ..telemetry import instruments as ti

    ti.KERNEL_TRACES.inc(kernel=kernel)


def build_dir() -> Path:
    env = os.environ.get("CYCLONUS_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = tuple(SOURCES), verbose: bool = False) -> Dict[str, float]:
    """Compile every library in `names` that is not built yet, one nvcc
    process per source, all started together.  Returns the seconds each
    build took (0.0 for a library already present); raises with nvcc's
    output when a build fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(_CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
            time.perf_counter(),
        )
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        if verbose and log:
            print(log, end="")
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
