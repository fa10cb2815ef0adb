"""Device resolution, the build of the CUDA kernel library, launch counts.

Three jobs, all explicit:

- ``resolve_device``: every entry point of the package (``Pipeline.compile``,
  ``CompiledPipeline``, ``EtlJob``, ``DLRM``, ``train_loop``) runs on
  ``cuda`` unless its caller passes ``device="cpu"``.  A caller that asks
  for nothing on a host without a CUDA device gets a ``RuntimeError`` — the
  package never carries on silently on the CPU.
- ``load_library``: on first use, compile each ``csrc/*.cu`` with its own
  ``nvcc`` for ``sm_90a`` (all started together), link the objects into one
  shared library with a plain C interface under ``build/repro_torch/`` at
  the checkout root (the file name carries a hash of the sources and flags,
  so an edit rebuilds), and load it with ``ctypes``.  No torch headers and
  no ``ninja`` are needed, so a build takes seconds.  Nothing is built or
  loaded at import time.
- ``LAUNCHES``: one count per kernel, which its wrapper raises by one
  (``count_launch``) where it launches the CUDA kernel and nowhere else;
  ``reset_launch_counts`` zeroes them.  Both take one lock, so the counts
  stay exact while several threads launch at once (each executor's
  transform thread, a trainer's refits).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Union

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# no --use_fast_math: it flushes denormals and swaps log1pf for a cheaper
# approximation, and the kernels hold bit/rtol parity with the plain versions
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC")

LAUNCHES = {name: 0 for name in (
    "group_dataflow", "output_dataflow", "fit_dataflow", "fused_stage",
    "packer", "vocab_build_chunk", "vocab_lookup", "embedding_bag",
    "embedding_bag_cached")}


_LAUNCH_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to ``LAUNCHES[name]`` (a read-modify-write: under the lock,
    no increment from another thread is lost)."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


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


def _run(cmd: list) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(procs: list, verbose: bool) -> None:
    """Wait for every process; raise with the first failure's output."""
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{err}")
        elif verbose and err:
            print(err, flush=True)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_library(verbose: bool = False) -> Path:
    """Compile the kernel sources unless a library for them exists: one
    ``nvcc`` per source, all at once, then one link."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = str(Path(tmp, src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, _run(cmd)))
        _wait(procs, verbose)
        lib = str(Path(tmp, "lib.so"))
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        _wait([(cmd, _run(cmd))], verbose)
        os.replace(lib, out)  # atomic publish: concurrent builders agree
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; one per process."""
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        "launch_dataflow_apply": [ptr, i32, ptr],
        "launch_dataflow_fit": [ptr, i32, ptr],
        "launch_fused_stage": [ptr, ptr],
        "launch_packer": [ptr, i32, ptr],
        "launch_vocab_build": [ptr, ptr, i32, i32, ptr],
        "launch_vocab_lookup": [ptr, ptr, ptr, i64, i32, i32, ptr],
        "launch_embedding_bag": [ptr, ptr, i64, ptr, i32, i32, i32, i32, i32,
                                 i32, ptr],
        "launch_embedding_bag_cached": [ptr, ptr, ptr, i64, ptr, i64, ptr,
                                        i32, i32, i32, i32, i32, i32, i32,
                                        ptr],
        "launch_embedding_bag_cached_stacked": [
            ptr, i64, ptr, i64, ptr, i64, i64, ptr, i64, i64, ptr, i32, i32,
            i32, i32, i32, i32, i32, ptr],
        "dataflow_program_size": [i32],
        "stage_args_size": [],
        "pack_args_size": [i32],
    }
    for name, args in signatures.items():
        f = getattr(lib, name)
        f.argtypes = args
        f.restype = ctypes.c_int
    lib.dataflow_error_string.argtypes = [ctypes.c_int]
    lib.dataflow_error_string.restype = ctypes.c_char_p
    return lib


def on_cpu(x: torch.Tensor) -> bool:
    """A wrapper's route: True for a CPU tensor (the plain version), False
    for a CUDA tensor (the kernel); any other device raises."""
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"the kernels take CPU or CUDA tensors, not "
                         f"{x.device}")
    return True


def require(x: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor (the kernels
    take raw pointers)."""
    if x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{what}: want a contiguous {dtype} tensor, got "
                         f"{x.dtype}{list(x.shape)} "
                         f"(contiguous={x.is_contiguous()})")


def stream_of(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (read
    without building a ``torch.cuda.Stream``: it is on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_launch(lib: ctypes.CDLL, code: int, what: str,
                 device: Optional[torch.device] = None) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if code != 0:
        msg = lib.dataflow_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed on {device}: "
                           f"cudaError {code} ({msg})")
