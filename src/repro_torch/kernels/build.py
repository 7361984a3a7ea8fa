"""Builds the CUDA sources under ``csrc/`` into one shared library and loads
it with ctypes.

Each ``.cu`` file has a plain C interface (no PyTorch headers), so ``nvcc``
takes seconds. The sources compile in parallel, one ``nvcc`` process each,
and link into ``build/repro_torch_kernels/librepro_torch_kernels-<hash>.so``
at the root of the checkout. The hash covers the sources and the flags, so
an edited source builds anew and an unchanged one loads the library already
built. Any failure raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or /usr/local/cuda/bin/nvcc)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _compile(lib: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, _run([nvcc, *ARCH_FLAGS, *CFLAGS, "-c",
                                     str(src), "-o", str(obj)])))
        logs = []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        staged = Path(tmp) / lib.name
        link = _run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged),
                     *map(str, objs)])
        out, _ = link.communicate()
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{out}")
        lib.with_suffix(".log").write_text("".join(logs))
        os.replace(staged, lib)          # atomic: readers never see half a file


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernels library."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            lib = library_path()
            if not lib.exists():
                t0 = time.perf_counter()
                _compile(lib)
                build_seconds = time.perf_counter() - t0
            _lib = ctypes.CDLL(str(lib))
            _declare(_lib)
        return _lib


def build_log() -> str:
    """nvcc's ``-Xptxas -v`` report (registers, shared memory, spills)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_flash_attention_fwd.argtypes = [
        p, p, p, p,                 # q, k, v, out
        i,                          # dtype: 0 float32, 1 bfloat16
        i, i, i, i, i, i,           # B, Sq, Sk, N, K, H
        f, i, i, f,                 # scale, causal, window (<=0: none), softcap (<=0: none)
        p]                          # cudaStream_t
    lib.repro_flash_attention_fwd.restype = i
    lib.repro_ssd_fwd.argtypes = [
        p, p, p, p, p, p,           # x, dt, A, B, C, D
        p, p, p,                    # y, final state, C.B^T scratch
        i,                          # x/y dtype: 0 float32, 1 bfloat16
        i, i, i, i, i, i,           # Bsz, S, H, P, N, chunk
        p]                          # cudaStream_t
    lib.repro_ssd_fwd.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
