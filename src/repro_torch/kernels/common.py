"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file under ``src/repro_torch/csrc/`` with a
plain C entry point.  It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/`` at the repository root -- at the first
call that needs it, never at import -- and loaded with ``ctypes``.  The
library's file name carries a hash of its source, so an edited source
is rebuilt and a stale library is never loaded.

Every launching wrapper owns a :class:`LaunchCounter` and adds one to it
where it launches its kernel, and nowhere else, and calls its C entry
through :func:`launch`.
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
from typing import Dict, Sequence

import torch

PACKAGE_ROOT = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_ROOT / "csrc"
BUILD_DIR = PACKAGE_ROOT.parents[1] / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
#: each library built or found by :func:`build`, by kernel name (kept
#: beside the library, so a library built by an earlier process has it).
build_logs: Dict[str, str] = {}


class LaunchCounter:
    """A plain count of kernel launches by one wrapper."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0


def launch(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)``: a C entry called with the raw handle of
    PyTorch's current stream on ``dev``, with ``dev`` the current device
    for the call (a kernel launches on the current device).  Returns what
    ``fn`` returns, a ``cudaError_t``.  The device is switched only when
    it is not the current one already, which keeps the host's share of a
    small launch small."""
    current = torch.cuda.current_device()
    if dev.index is None or dev.index == current:
        return fn(*args, torch._C._cuda_getCurrentRawStream(current))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels are "
            "built from source at first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library for the current source lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one ``nvcc``
    process per source, all started together.  Returns the seconds each
    build took (0.0 for a library already on disk); raises with
    nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            if out.with_suffix(".log").exists():
                build_logs[name] = out.with_suffix(".log").read_text()
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.monotonic())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
