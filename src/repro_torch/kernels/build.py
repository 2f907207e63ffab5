"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` process per
source, all started together, and the objects are linked into one shared
library with a plain C interface that :func:`library` loads with
``ctypes``.  The build runs at first use, from the sources in this
package only, into ``kernels/_build/`` (git-ignored), under a name that
hashes the sources and flags, so an edited source is never served by a
stale library.

No fast-math flag is passed: the sampler's ``expf``/``logf`` must stay
accurate (events are argmins of products of them), and so must the SSD
decays ``expf(cum_i - cum_j)``.
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
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("runtime.cu", "tte_sample.cu", "flash_attention.cu",
           "paged_attention.cu", "ssd_intra.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# what the last build did (seconds, ptxas report), for chip_smoke.py
last_build: Dict[str, object] = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``, else
    the one on ``PATH``.  Raises when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if not built yet) and return the shared library's path."""
    lib_path = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib_path.exists():
        last_build.update(seconds=0.0, cached=True, log="")
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        exe = nvcc()
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name),
                   "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"--- {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [exe, "-shared", "-o", str(tmp_lib)] + [str(o) for _, o, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    last_build.update(seconds=time.perf_counter() - t0, cached=False,
                      log="\n".join(logs))
    return lib_path


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


_first_build = threading.Lock()


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call in a process).
    Threads that reach the first call together (a serving engine's loop
    and a request handler) wait on one build."""
    with _first_build:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.repro_cuda_error_string.argtypes = [_I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.tte_sample_launch.argtypes = [_P, _P, _LL, _LL, _I, _I, _P, _P, _I,
                                      _I, _P]
    lib.tte_sample_launch.restype = _I
    lib.tte_sample_plan.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.tte_sample_plan.restype = _I
    lib.flash_attention_launch.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_LL), _I, _I, _I, _I, _I,
        _I, _F, _I, _I, _P]
    lib.flash_attention_launch.restype = _I
    lib.paged_decode_launch.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]
    lib.paged_decode_launch.restype = _I
    lib.ssd_intra_launch.argtypes = [
        _I, _I, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_LL), _I, _I, _I, _I,
        _I, _I, _P]
    lib.ssd_intra_launch.restype = _I
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")


def stream_ptr(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor, kernel: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{kernel} takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]
