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

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
#: guards the bindings' launch counters: serving engines on two threads
#: launch through one binding, and ``launches += 1`` on a module global can
#: lose an update between threads
counter_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0
#: the binding modules whose launch counters ``counts`` reads, by name
BINDINGS = ("flash_attention", "ssd", "decode_attention", "gmm", "adamw",
            "mamba_front")
#: per thread: the launches recorded into the CUDA graph being captured
_recording = threading.local()


def _binding(name: str):
    return sys.modules[f"{__package__}.{name}"]


def count(name: str, kernel: str | None) -> None:
    """One launch of binding ``name`` (its kernel ``kernel``; None for a
    binding that counts calls only), called by the binding where it launches.
    Under ``counter_lock``: engines on several threads launch through one
    binding. On a thread inside ``recording`` it goes to the recorded delta
    instead: a call captured into a CUDA graph launches nothing until the
    graph is replayed (``add_counts``)."""
    delta = getattr(_recording, "delta", None)
    if delta is not None:
        n, by_kernel = delta.get(name, (0, {}))
        if kernel is not None:
            by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
        delta[name] = (n + 1, by_kernel)
        return
    mod = _binding(name)
    with counter_lock:
        mod.launches += 1
        if kernel is not None:
            mod.kernel_launches[kernel] += 1


def counts() -> dict[str, tuple[int, dict[str, int]]]:
    """A snapshot of every binding's ``launches`` and ``kernel_launches``
    (empty for SSD, which counts calls only), by binding name."""
    with counter_lock:
        return {name: (_binding(name).launches,
                       dict(getattr(_binding(name), "kernel_launches", {})))
                for name in BINDINGS}


def add_counts(delta: dict[str, tuple[int, dict[str, int]]]) -> None:
    """Add a recorded delta (``recording``) to the bindings' counters, under
    ``counter_lock``: what one replay of a captured graph launches."""
    with counter_lock:
        for name, (n, by_kernel) in delta.items():
            mod = _binding(name)
            mod.launches += n
            for kernel, k in by_kernel.items():
                mod.kernel_launches[kernel] += k


@contextlib.contextmanager
def recording():
    """Inside, the launches counted on this thread go to the yielded delta
    ({binding: (launches, {kernel: launches})}), not to the counters: a
    CUDA graph's capture records its launches, each replay adds them."""
    if getattr(_recording, "delta", None) is not None:
        raise RuntimeError("already recording launches on this thread")
    _recording.delta = {}
    try:
        yield _recording.delta
    finally:
        _recording.delta = None


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
    lib.repro_flash_wgmma_stages.argtypes = [i]     # head_dim
    lib.repro_flash_wgmma_stages.restype = i
    lib.repro_ssd_fwd.argtypes = [
        p, p, p, p, p, p,           # x, dt, A, B, C, D
        p, p,                       # y, final state
        p, p, p, p,                 # scratch: C.B^T, local and entering states, decays
        i,                          # x/y dtype: 0 float32, 1 bfloat16
        i, i, i, i, i, i,           # Bsz, S, H, P, N, chunk
        p]                          # cudaStream_t
    lib.repro_ssd_fwd.restype = i
    lib.repro_decode_attention_fwd.argtypes = [
        p, p, p, p, p,              # q (fp32), k cache, v cache, pos (int32), out
        p, p,                       # split partials: acc, (m, l)
        i, i,                       # q dtype, cache dtype: 0 float32, 1 bfloat16
        i, i, i, i, i,              # B, S, N, K, H
        i, i,                       # splits, keys per tile
        f, i, f,                    # scale, window (<=0: none), softcap (<=0: none)
        p]                          # cudaStream_t
    lib.repro_decode_attention_fwd.restype = i
    lib.repro_decode_attention_mma_fwd.argtypes = [
        p, p, p, p, p,              # q, k cache, v cache, pos (int32), out (bf16)
        p, p,                       # split partials (fp32), merge tickets (int32); null at 1 split
        i, i, i, i, i,              # B, S, N, K, H
        i,                          # splits
        f, i, f,                    # scale, window (<=0: none), softcap (<=0: none)
        p]                          # cudaStream_t
    lib.repro_decode_attention_mma_fwd.restype = i
    lib.repro_gmm_fwd.argtypes = [
        p, p, p, p,                 # x, w, group sizes (int32), out
        p,                          # split partials [splits, T, F] fp32 (or null)
        i,                          # dtype: 0 float32, 1 bfloat16
        i, i, i, i,                 # T, D, F, E
        i,                          # splits of D (bf16, with partials)
        p]                          # cudaStream_t
    lib.repro_gmm_fwd.restype = i
    lib.repro_adamw_fwd.argtypes = [
        p, p, p, p,                 # p, g, m, v
        ctypes.c_int64, i,          # n, p dtype: 0 float32, 1 bfloat16
        p, p, p, p,                 # lr, b1c, b2c, clip scale (or null), on the device
        f, f, f, f, f, f,           # b1, 1 - b1, b2, 1 - b2, eps, weight decay
        p]                          # cudaStream_t
    lib.repro_adamw_fwd.restype = i
    lib.repro_mamba_front_fwd.argtypes = [
        p, ctypes.c_int64, ctypes.c_int64,  # zxbcdt, its batch and row strides
        i, i,                       # offsets of (x|B|C) and dt in a row
        p, p, p,                    # conv_w, conv_b, dt_bias
        p, p, p, p,                 # x, B, C, dt
        i, i,                       # zxbcdt dtype, conv_w/conv_b dtype: 0 float32, 1 bfloat16
        i, i, i, i, i, i,           # Bsz, S, d_inner, N, H, K
        p]                          # cudaStream_t
    lib.repro_mamba_front_fwd.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p


class DTensorInputError(TypeError):
    """A DTensor given to a kernel binding: the kernel reads raw pointers,
    which a DTensor's shard is not the whole of."""


def check_inputs(kernel: str, *tensors) -> None:
    """Raise on an input ``kernel`` cannot take: a DTensor
    (``DTensorInputError``), or one that needs a backward through the
    kernel (RuntimeError): no CUDA kernel here has one, and its output is a
    fresh tensor without a graph, so the gradients of everything upstream
    would silently be lost."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise DTensorInputError(
            f"{kernel}: a DTensor input; the CUDA kernel takes plain tensors "
            f"(gather with full_tensor(), or run impl='torch' on a mesh)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and the CUDA kernel has no "
            f"backward pass; training goes through impl='torch' "
            f"(attn_impl='torch', ssm_impl='torch', moe_impl='einsum'), and a "
            f"kernel call runs under torch.no_grad() or inference_mode")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
