"""Device resolution and the build of the CUDA kernel library.

Two jobs, both explicit:

- ``resolve_device``: every entry point of the package (``Pipeline.compile``,
  ``CompiledPipeline``, ``EtlJob``, ``DLRM``, ``train_loop``) runs on
  ``cuda`` unless its caller passes ``device="cpu"``.  A caller that asks
  for nothing on a host without a CUDA device gets a ``RuntimeError`` — the
  package never carries on silently on the CPU.
- ``load_library``: on first use, compile ``csrc/*.cu`` with ``nvcc`` for
  ``sm_90a`` into a shared library with a plain C interface under
  ``build/repro_torch/`` at the checkout root (the file name carries a hash
  of the sources and flags, so an edit rebuilds), and load it with
  ``ctypes``.  No torch headers and no ``ninja`` are needed, so a build takes
  seconds.  Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Union

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# no --use_fast_math: it flushes denormals and swaps log1pf for a cheaper
# approximation, and the kernels hold bit/rtol parity with the plain versions
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-shared")


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda`` — and a ``RuntimeError`` when ``cuda`` is meant but absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, "
                           "/usr/local/cuda and $PATH)")
    return found


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdataflow_{h.hexdigest()[:16]}.so"


def build_library(verbose: bool = False) -> Path:
    """Compile the kernel sources unless a library for them exists."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    sources = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *sources]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        if verbose and proc.stderr:
            print(proc.stderr, flush=True)
        os.replace(tmp, out)  # atomic publish: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; one per process."""
    lib = ctypes.CDLL(str(build_library()))
    for fn in ("launch_dataflow_apply", "launch_dataflow_fit"):
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.dataflow_error_string.argtypes = [ctypes.c_int]
    lib.dataflow_error_string.restype = ctypes.c_char_p
    lib.dataflow_program_size.argtypes = []
    lib.dataflow_program_size.restype = ctypes.c_int
    return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str,
                 device: Optional[torch.device] = None) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if code != 0:
        msg = lib.dataflow_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed on {device}: "
                           f"cudaError {code} ({msg})")
