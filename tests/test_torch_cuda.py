"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here but the launch-counter test (which needs no card) is marked
``cuda`` and skips with "no CUDA" on a machine without a GPU. The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed (the repository's conftest imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are the reference's (tests/test_kernels.py): atol = rtol = 3e-5
for float32 attention, 2e-2 for bfloat16, 3e-4 for the SSD scan against the
sequential definition. The bfloat16 flash kernel is held against the plain
version computed in float32 on the same bfloat16 inputs, drawn so that the
scaled scores are tens (where a softcap of 50 bends them), and must also
keep its relative L2 error within ``BF16_REL_L2``: it rounds twice (the
probabilities before the PV product, and the output), each by at most the
bfloat16 unit roundoff 2**-8.
"""
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

# cuBLAS is deterministic only with a fixed workspace, set before its first
# use: the mesh step is held bit for bit to the mesh-less one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from repro_torch.kernels import adamw as adamw_mod
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gmm as gmm_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as ssd_mod

FLASH_CASES = [
    # (b, sq, n, kv, h, window, softcap): tests/test_kernels.py's list, and
    # gemma2-2b's full-width layer (head_dim 256, window, softcap)
    (1, 32, 2, 2, 16, None, None),
    (2, 40, 4, 2, 16, None, None),
    (1, 130, 8, 1, 32, None, None),
    (2, 64, 4, 4, 64, None, 50.0),
    (1, 96, 4, 2, 32, 17, None),
    (1, 128, 8, 2, 64, 64, 30.0),
    (1, 300, 8, 4, 256, 100, 50.0),
    (1, 200, 4, 2, 128, None, None),
    # the wgmma kernel's edges: two batches apart in one tensor map, ragged
    # S, a window cutting mid-tile and a softcap; a group of 16; S shorter
    # than one 128-row query tile
    (2, 777, 8, 4, 256, 300, 50.0),
    (1, 1000, 64, 4, 128, None, None),
    (1, 40, 8, 4, 256, None, 50.0),
    # head dims 96 (phi-3-vision) and 160 (zamba2's shared block): 64-byte
    # swizzled chunks, groups of 1 and 4, with and without window and softcap
    (1, 300, 4, 4, 96, 100, 50.0),
    (2, 257, 8, 2, 96, None, None),
    (1, 300, 4, 4, 160, 77, 30.0),
    (2, 257, 8, 2, 160, None, None),
    (1, 1000, 4, 1, 160, 300, 50.0),
]

#: the three kernels of csrc/ssd.cu, each launched once by an SSD call
SSD_KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel")

SSD_CASES = [
    # (b, s, h, p, n, chunk)
    (1, 32, 2, 8, 16, 8),
    (2, 48, 3, 8, 16, 16),
    (1, 100, 2, 16, 32, 32),
    (2, 64, 4, 32, 64, 64),
    (1, 512, 4, 64, 128, 256),              # mamba2-130m's head and state
    (2, 60, 3, 6, 5, 20),                   # padded by the binding: chunk, N, P
    (1, 512, 80, 64, 64, 256),              # zamba2-2.7b's heads and state
]

DECODE_CASES = [
    # (b, s, n, kv, h, window, softcap): tests/test_kernels.py's list, then
    # softcaps, windows that cut mid-tile and ragged caches
    (2, 64, 4, 2, 16, None, None),
    (3, 100, 8, 8, 32, None, None),
    (1, 96, 8, 1, 64, 20, None),
    (2, 256, 4, 4, 64, 128, None),
    (3, 1000, 8, 4, 256, 100, 50.0),
    (2, 777, 4, 1, 128, 37, None),
    (3, 333, 16, 2, 64, None, 30.0),
    (2, 300, 16, 1, 64, None, None),        # groups of 16
    (1, 200, 32, 2, 16, 50, 30.0),
    (2, 150, 16, 1, 128, 70, None),
    # head dims 96 and 160, groups of 1 and 4
    (2, 300, 4, 4, 96, 100, 50.0),
    (3, 700, 16, 4, 96, None, None),
    (2, 300, 4, 4, 160, 77, 30.0),
    (3, 700, 16, 4, 160, None, None),
    (2, 333, 16, 1, 96, None, 30.0),        # a group of 16 at 96
]

# the full-width GQA shapes: (label, s, n, kv, h, window, softcap)
DECODE_FULL = [
    ("gemma2-2b local", 5120, 8, 4, 256, 4096, 50.0),
    ("gemma2-2b global", 5120, 8, 4, 256, None, 50.0),
    ("gemma-2b", 8192, 8, 1, 256, None, None),
    ("qwen1.5-4b", 4096, 20, 20, 128, None, None),
    ("qwen3-moe", 1056, 64, 4, 128, None, None),     # a group of 16
    ("phi-3-vision", 1056, 32, 32, 96, None, None),
    ("zamba2-2.7b shared", 1056, 32, 32, 160, None, None),
]

GMM_CASES = [
    # (t, d, f, e): tests/test_kernels.py's list, ragged tiles, and
    # qwen3-moe's decode shape (8 rows over 128 experts, most empty)
    (16, 8, 16, 2), (37, 16, 24, 4), (100, 32, 64, 8), (64, 16, 48, 16),
    (300, 136, 200, 5), (8, 4096, 1536, 128),
]

TOL = {torch.float32: dict(atol=3e-5, rtol=3e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
BF16_REL_L2 = 2 * 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, sq, n, kv, h, win, cap = case
    rng = np.random.default_rng(7)
    # q and k of standard deviation 4 give scaled scores of deviation 16
    amp = 4.0 if dtype == torch.bfloat16 else 1.0
    q, k, v = (torch.from_numpy(a * rng.standard_normal(shape, np.float32))
               .to(cuda, dtype) for a, shape in
               ((amp, (b, sq, n, h)), (amp, (b, sq, kv, h)), (1.0, (b, sq, kv, h))))
    before = fa.launches
    got = ops.flash_attention(q, k, v, window=win, softcap=cap)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = ref.attention(q.float(), k.float(), v.float(), window=win,
                         softcap=cap)
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    if dtype == torch.bfloat16:
        rel = float((got.float() - want).norm() / want.norm())
        assert rel <= BF16_REL_L2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(cuda, case, dtype):
    b, s, h, p, n, ch = case
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p), np.float32))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, s, h), np.float32)))
    A = -torch.exp(0.5 * torch.from_numpy(rng.standard_normal(h).astype(np.float32)))
    B, C = (torch.from_numpy(rng.standard_normal((b, s, n), np.float32))
            for _ in range(2))
    D = torch.full((h,), 0.5)
    args = [x.to(cuda, dtype)] + [t.to(cuda) for t in (dt, A, B, C, D)]
    before = ssd_mod.launches
    y, fin = ops.ssd(*args, chunk=ch)
    torch.cuda.synchronize()
    assert ssd_mod.launches == before + 1
    assert y.dtype == dtype and fin.dtype == torch.float32
    y_seq, fin_seq = ref.ssd(*args)
    tol = TOL[torch.bfloat16] if dtype == torch.bfloat16 else dict(atol=3e-4,
                                                                   rtol=3e-4)
    np.testing.assert_allclose(_np(y), _np(y_seq), **tol)
    np.testing.assert_allclose(_np(fin), _np(fin_seq), atol=3e-4, rtol=3e-4)


# (chunk, p, n) at 16 chunks of a batch of 2: the pass over the chunks runs
# at depth, and dt is small enough that the state carries across them
SSD_DEEP = [(ch, p, n) for ch in (32, 64, 128, 256) for p, n in ((16, 32), (64, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk, p, n", SSD_DEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_at_depth_matches_chunked(cuda, chunk, p, n, dtype):
    b, h, s = 2, 3, 16 * chunk
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p), np.float32))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, s, h), np.float32)) - 4.0)
    A = -torch.exp(0.5 * torch.from_numpy(rng.standard_normal(h).astype(np.float32)))
    B, C = (torch.from_numpy(rng.standard_normal((b, s, n), np.float32))
            for _ in range(2))
    D = torch.full((h,), 0.5)
    args = [x.to(cuda, dtype)] + [t.to(cuda) for t in (dt, A, B, C, D)]
    before = ssd_mod.launches
    y, fin = ssd_mod.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_mod.launches == before + 1
    # by the profiler's kernel names: each of the three kernels once a call
    kernels = _kernel_names(lambda: ssd_mod.ssd(*args, chunk=chunk))
    assert {name: sum(c for k, c in kernels.items() if name in k)
            for name in SSD_KERNELS} == dict.fromkeys(SSD_KERNELS, 1), kernels
    y_ref, fin_ref = ref.ssd_chunked(*args, chunk=chunk)
    tol = TOL[torch.bfloat16] if dtype == torch.bfloat16 else dict(atol=3e-4,
                                                                   rtol=3e-4)
    np.testing.assert_allclose(_np(y), _np(y_ref), **tol)
    np.testing.assert_allclose(_np(fin), _np(fin_ref), atol=3e-4, rtol=3e-4)


# the served shapes (b, s, h, p, n, chunk): mamba2-130m's and zamba2-2.7b's
SSD_SERVED = [(1, 1024, 24, 64, 128, 256), (1, 1024, 80, 64, 64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_SERVED, ids=["mamba2-130m", "zamba2-2.7b"])
def test_ssd_kernel_bf16_at_served_shapes(cuda, case):
    """bf16 x at the served shapes (the two-term products with x) against
    the chunked definition in float32 on the same x."""
    b, s, h, p, n, ch = case
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p), np.float32))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, s, h), np.float32)) - 4.0)
    A = -torch.linspace(1.0, 16.0, h)
    B, C = (torch.from_numpy(rng.standard_normal((b, s, n), np.float32))
            for _ in range(2))
    D = torch.ones((h,))
    args = [x.to(cuda, torch.bfloat16)] + [t.to(cuda) for t in (dt, A, B, C, D)]
    y, fin = ops.ssd(*args, chunk=ch)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    y_ref, fin_ref = ref.ssd_chunked(args[0].float(), *args[1:], chunk=ch)
    np.testing.assert_allclose(_np(y), _np(y_ref), **TOL[torch.bfloat16])
    np.testing.assert_allclose(_np(fin), _np(fin_ref), atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
def test_ssd_kernel_float32_needs_every_split_term(cuda):
    """float32 x, B and C with full mantissas and outputs in the hundreds,
    over four chunks that carry the state (slow decay): a product that left
    out one TF32 piece of an operand (2^-11 of it) misses the 3e-4 bound
    by tens of times, wherever the output is small beside its terms."""
    b, s, h, p, n, ch = 1, 1024, 2, 64, 128, 256
    rng = np.random.default_rng(23)
    x = torch.from_numpy(4 * rng.standard_normal((b, s, h, p), np.float32))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, s, h), np.float32)) - 4.0)
    A = torch.tensor([-0.05, -0.2])
    B, C = (torch.from_numpy(2 * rng.standard_normal((b, s, n), np.float32))
            for _ in range(2))
    D = torch.full((h,), 0.5)
    args = [t.to(cuda) for t in (x, dt, A, B, C, D)]
    y, fin = ops.ssd(*args, chunk=ch)
    torch.cuda.synchronize()
    y_ref, fin_ref = ref.ssd_chunked(*args, chunk=ch)
    # the state crosses the chunks and the outputs are large
    assert float(fin_ref.abs().mean()) > 1.0
    assert float(y_ref.abs().mean()) > 50.0
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(_np(fin), _np(fin_ref), atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
def test_ssd_kernel_dt0_padding_leaves_state_exactly(cuda):
    """Chunks of dt = 0 positions decay by exp(0) = 1 and add nothing."""
    rng = np.random.default_rng(3)
    b, s, h, p, n, ch = 1, 64, 2, 16, 32, 32
    x, B, C = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(cuda)
               for shape in ((b, 2 * s, h, p), (b, 2 * s, n), (b, 2 * s, n)))
    dt = torch.rand((b, 2 * s, h), device=cuda)
    dt[:, s:] = 0.0
    A = -torch.ones(h, device=cuda)
    D = torch.ones(h, device=cuda)
    y1, f1 = ops.ssd(x[:, :s], dt[:, :s], A, B[:, :s], C[:, :s], D, chunk=ch)
    y2, f2 = ops.ssd(x, dt, A, B, C, D, chunk=ch)
    torch.cuda.synchronize()
    assert torch.equal(f1, f2)
    assert torch.equal(y1, y2[:, :s])


def _decode_inputs(rng, b, s, n, kv, h, dtype, device):
    amp = 4.0 if dtype == torch.bfloat16 else 1.0
    q, k, v = (torch.from_numpy(a * rng.standard_normal(shape, np.float32))
               .to(device, dtype) for a, shape in
               ((amp, (b, n, h)), (amp, (b, s, kv, h)), (1.0, (b, s, kv, h))))
    return q, k, v


def _check_decode(q, k, v, pos, win, cap):
    before = dec.launches
    kernel = dec.kernel_for(q.dtype, k.dtype)
    by_kernel = dict(dec.kernel_launches)
    got = ops.decode_attention(q, k, v, pos, window=win, softcap=cap)
    torch.cuda.synchronize()
    assert dec.launches == before + 1
    by_kernel[kernel] += 1
    assert dec.kernel_launches == by_kernel
    want = ref.decode_attention(q.float(), k.float(), v.float(), pos,
                                window=win, softcap=cap)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[q.dtype])
    if q.dtype == torch.bfloat16:
        rel = float((got.float() - want).norm() / want.norm())
        assert rel <= BF16_REL_L2, rel
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda, case, dtype):
    b, s, n, kv, h, win, cap = case
    rng = np.random.default_rng(13)
    q, k, v = _decode_inputs(rng, b, s, n, kv, h, dtype, cuda)
    pos = torch.from_numpy(rng.integers(0, s, (b,)).astype(np.int32)).to(cuda)
    _check_decode(q, k, v, pos, win, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_FULL, ids=[c[0] for c in DECODE_FULL])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_full_width(cuda, shape, dtype):
    """At pos 0, one tile - 1, mid-cache and S - 1."""
    _, s, n, kv, h, win, cap = shape
    rng = np.random.default_rng(17)
    q, k, v = _decode_inputs(rng, 1, s, n, kv, h, dtype, cuda)
    for p in (0, dec.TILE - 1, s // 2 + 13, s - 1):
        _check_decode(q, k, v, torch.tensor([p], dtype=torch.int32,
                                            device=cuda), win, cap)


@pytest.mark.cuda
def test_decode_kernel_ignores_stale_rows(cuda):
    """Rows past pos hold 999 / -999: the output is bit for bit the same."""
    rng = np.random.default_rng(19)
    q, k, v = _decode_inputs(rng, 3, 700, 8, 4, 256, torch.bfloat16, cuda)
    pos = torch.tensor([5, 300, 699], dtype=torch.int32, device=cuda)
    clean = _check_decode(q, k, v, pos, 256, 50.0)
    for i, p in enumerate(pos.tolist()):
        k[i, p + 1:] = 999.0
        v[i, p + 1:] = -999.0
    stale = ops.decode_attention(q, k, v, pos, window=256, softcap=50.0)
    torch.cuda.synchronize()
    assert torch.equal(clean, stale)


@pytest.mark.cuda
def test_decode_kernel_fp32_q_over_bf16_cache(cuda):
    """An fp32 model over the default bf16 cache: the kernel reads each in
    its own dtype and matches the plain version, which promotes."""
    rng = np.random.default_rng(23)
    q, _, _ = _decode_inputs(rng, 2, 300, 8, 4, 256, torch.float32, cuda)
    _, k, v = _decode_inputs(rng, 2, 300, 8, 4, 256, torch.bfloat16, cuda)
    pos = torch.tensor([17, 299], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, pos, window=100, softcap=50.0)
    want = ref.decode_attention(q, k, v, pos, window=100, softcap=50.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL[torch.float32])
    with pytest.raises(ValueError, match="dtypes"):
        dec.decode_attention(q.to(torch.bfloat16), k.float(), v.float(), pos)


@pytest.mark.cuda
def test_decode_kernel_refuses_a_cache_it_would_have_to_copy(cuda):
    q = torch.zeros((1, 4, 64), device=cuda)
    k = torch.zeros((1, 64, 4, 128), device=cuda)[..., :64]   # strided
    pos = torch.zeros((1,), dtype=torch.int32, device=cuda)
    before = dec.launches
    with pytest.raises(ValueError, match="contiguous"):
        dec.decode_attention(q, k, k, pos)
    with pytest.raises(ValueError, match="group"):
        dec.decode_attention(torch.zeros((1, 12, 64), device=cuda),
                             k.contiguous(), k.contiguous(), pos)
    assert dec.launches == before


# bf16 shapes whose calls split over several blocks and merge in the same
# launch: (label, s, n, kv, h, window, softcap, pos)
DECODE_MERGED = [
    ("gemma2-2b global", 5120, 8, 4, 256, None, 50.0, [4640]),
    ("qwen3-moe", 1056, 64, 4, 128, None, None, [1040]),
    ("phi-3-vision", 1056, 32, 32, 96, None, None, [1040]),
    ("zamba2-2.7b shared", 1056, 32, 32, 160, None, None, [1040]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_MERGED, ids=[c[0] for c in DECODE_MERGED])
def test_decode_bf16_kernel_is_bit_repeatable(cuda, case):
    """The last block of each (sequence, KV head) merges the splits in split
    order, whatever order the blocks finished in: two calls agree bit for
    bit."""
    _, s, n, kv, h, win, cap, p = case
    assert dec.num_splits(1, kv, s, win, n // kv, h) > 1
    rng = np.random.default_rng(29)
    q, k, v = _decode_inputs(rng, 1, s, n, kv, h, torch.bfloat16, cuda)
    pos = torch.tensor(p, dtype=torch.int32, device=cuda)
    first = _check_decode(q, k, v, pos, win, cap)
    for _ in range(3):
        again = ops.decode_attention(q, k, v, pos, window=win, softcap=cap)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_MERGED, ids=[c[0] for c in DECODE_MERGED])
def test_decode_bf16_kernel_replays_in_a_cuda_graph(cuda, case):
    """One bf16 call captured at one pos, replayed after the cache and pos
    were changed in place, equals an eager call at the new pos: the merge
    counters are back at zero after every call and nothing of the call
    lives on the host."""
    _, s, n, kv, h, win, cap, p = case
    rng = np.random.default_rng(31)
    q, k, v = _decode_inputs(rng, 1, s, n, kv, h, torch.bfloat16, cuda)
    pos = torch.tensor([p[0] - 500], dtype=torch.int32, device=cuda)
    run = lambda: ops.decode_attention(q, k, v, pos, window=win, softcap=cap)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                                    # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    for step, new_pos in enumerate((p[0], p[0] - 1, 7)):
        q2, k2, v2 = _decode_inputs(np.random.default_rng(37 + step), 1, s, n,
                                    kv, h, torch.bfloat16, cuda)
        q.copy_(q2)
        k.copy_(k2)
        v.copy_(v2)
        pos.fill_(new_pos)
        graph.replay()
        torch.cuda.synchronize()
        eager = _check_decode(q, k, v, pos, win, cap)
        assert torch.equal(out, eager), new_pos


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_MERGED, ids=[c[0] for c in DECODE_MERGED])
def test_decode_bf16_call_runs_one_kernel(cuda, case):
    """By the profiler's kernel names: one bf16 call is one launch of the
    mma kernel, and neither fp32 kernel runs."""
    _, s, n, kv, h, win, cap, p = case
    rng = np.random.default_rng(41)
    q, k, v = _decode_inputs(rng, 1, s, n, kv, h, torch.bfloat16, cuda)
    pos = torch.tensor(p, dtype=torch.int32, device=cuda)
    kernels = _kernel_names(
        lambda: ops.decode_attention(q, k, v, pos, window=win, softcap=cap))
    assert len(kernels) == 1 and sum(kernels.values()) == 1, kernels
    assert "decode_mma_kernel" in next(iter(kernels)), kernels


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_MERGED[:2],
                         ids=[c[0] for c in DECODE_MERGED[:2]])
def test_decode_bf16_from_two_threads_on_two_streams(cuda, case):
    """Two threads, each on its own stream, decode at once through the mma
    kernel at a shape that splits and merges: each stream counts into its
    own merge tickets, so every output equals bit for bit the same call
    made in turn. Each stream sleeps on the device while its thread queues
    the calls, so that the two streams' kernels run side by side."""
    _, s, n, kv, h, win, cap, p = case
    assert dec.num_splits(1, kv, s, win, n // kv, h) > 1
    inputs = []
    for i in range(2):
        rng = np.random.default_rng(47 + i)
        q, k, v = _decode_inputs(rng, 1, s, n, kv, h, torch.bfloat16, cuda)
        inputs.append((q, k, v, torch.tensor(p, dtype=torch.int32,
                                             device=cuda)))
    run = lambda i: ops.decode_attention(*inputs[i], window=win, softcap=cap)
    want = [run(i) for i in range(2)]
    torch.cuda.synchronize()
    assert not torch.equal(want[0], want[1])
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    reps = 50
    start = threading.Barrier(2, timeout=60)
    before = dec.kernel_launches["mma"]

    def work(i):
        with torch.cuda.stream(streams[i]):
            start.wait()
            torch.cuda._sleep(10_000_000)
            outs = [run(i) for _ in range(reps)]
            streams[i].synchronize()
        return outs

    with ThreadPoolExecutor(max_workers=2) as pool:
        got = list(pool.map(work, range(2), timeout=300))
    for i, outs in enumerate(got):
        for out in outs:
            assert torch.equal(out, want[i])
    assert dec.kernel_launches["mma"] == before + 2 * reps
    keys = {(torch.cuda.current_device(), st.cuda_stream) for st in streams}
    assert keys <= set(dec._tickets)


@pytest.mark.cuda
def test_decode_bf16_group_of_16_at_head_dim_256(cuda):
    """The mma kernel takes a group of 16 at head_dim 256 (the fp32 kernel
    still refuses it), at one block and at several, with a window and a
    softcap."""
    rng = np.random.default_rng(43)
    for b, s, n, kv, win, cap in ((2, 700, 64, 4, 300, 50.0),
                                  (1, 5120, 16, 1, None, None)):
        q, k, v = _decode_inputs(rng, b, s, n, kv, 256, torch.bfloat16, cuda)
        for p in (0, s // 2 + 13, s - 1):
            pos = torch.full((b,), p, dtype=torch.int32, device=cuda)
            _check_decode(q, k, v, pos, win, cap)
    with pytest.raises(ValueError, match="group of 16"):
        dec.decode_attention(q.float(), k, v, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma-2b", "qwen1.5-4b", "gemma2-2b",
                                  "mamba2-130m"])
def test_decode_step_launches_the_kernel_once_a_layer(cuda, arch):
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    lm = M.LM(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), device=cuda,
                           dtype=torch.int32)
    cache = lm.init_cache(2, 16, torch.float32)
    logits, cache = lm.prefill(tokens, cache)
    dec.launches = 0
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    dlogits, _ = lm.decode_step(nxt, cache, torch.full((2,), 12, device=cuda,
                                                       dtype=torch.int32))
    want, _ = lm(torch.cat([tokens, nxt], 1))
    attn_layers = 0 if cfg.family == "ssm" else cfg.num_layers
    assert dec.launches == attn_layers
    np.testing.assert_allclose(_np(dlogits[:, 0]), _np(want[:, -1]),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 256, 4, 2, 64, None, None),
                                  (2, 256, 4, 4, 256, 100, 30.0),
                                  (1, 384, 8, 2, 128, 50, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_noncausal_matches_plain(cuda, case, dtype):
    """Non-causal attention (block-aligned, as ops requires), with a window
    that masks the older keys only and skips whole tiles below it."""
    b, s, n, kv, h, win, cap = case
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda, dtype) for shape in
               ((b, s, n, h), (b, s, kv, h), (b, s, kv, h)))
    got = ops.flash_attention(q, k, v, causal=False, window=win, softcap=cap)
    want = ref.attention(q.float(), k.float(), v.float(), causal=False,
                         window=win, softcap=cap)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    if dtype == torch.bfloat16:
        rel = float((got.float() - want).norm() / want.norm())
        assert rel <= BF16_REL_L2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("h", fa.WGMMA_HEAD_DIMS)
def test_flash_bf16_launches_the_wgmma_kernel(cuda, h):
    rng = np.random.default_rng(h)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 150, 4, h), np.float32))
               .to(cuda, torch.bfloat16) for _ in range(3))
    before = dict(fa.kernel_launches)
    got = ops.flash_attention(q, k, v)
    ops.flash_attention(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert fa.kernel_launches == {"wgmma": before["wgmma"] + 1,
                                  "fp32": before["fp32"] + 1}
    want = ref.attention(q.float(), k.float(), v.float())
    np.testing.assert_allclose(_np(got), _np(want), **TOL[torch.bfloat16])


def _kernel_names(fn):
    """The device kernels ``fn`` runs (after one warm-up call), by the
    profiler's names, with their counts. The call waits 20 ms inside the
    profiling window first: kernels launched right after the profiler
    starts can be missing from its records (in whole-file runs on the card,
    a call's first kernels, or its only one, were sometimes absent)."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}


@pytest.mark.cuda
@pytest.mark.parametrize("h", [96, 160])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_call_runs_its_head_dim_instance(cuda, h, dtype):
    """By the profiler's kernel names: one call is one launch of the
    kernel instance of its head dim (no padded head dim, no copy of q, k,
    v), wgmma for bfloat16 and the CUDA-core kernel for float32."""
    rng = np.random.default_rng(h)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 200, 4, h), np.float32))
               .to(cuda, dtype) for _ in range(3))
    kernels = _kernel_names(lambda: fa.flash_attention(q, k, v))
    name = "flash_wgmma_kernel" if dtype == torch.bfloat16 else "flash_f32_kernel"
    assert len(kernels) == 1 and sum(kernels.values()) == 1, kernels
    assert f"{name}<{h}>" in next(iter(kernels)), kernels
    if dtype == torch.bfloat16:
        assert fa.wgmma_stages(h) == (2 if h == 160 else 4)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 16, 2, 24), device=cuda)              # head_dim 24
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q16 = torch.zeros((1, 16, 2, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q16, q16, q16)


@pytest.mark.cuda
def test_served_models_launch_the_kernels(cuda):
    """A served call (a graph replay, after the first call captured it)
    launches each layer's kernel once, by the counters."""
    from repro_torch.launch.serve import build_handle
    h_att = build_handle("gemma2-2b", "ctx", layers=2)
    h_ssm = build_handle("mamba2-130m", "kws", layers=2)
    tokens = torch.zeros((1, 16), dtype=torch.int32, device=cuda)
    for h in (h_att, h_ssm):
        h.fn(h.params, tokens)                   # captures
    fa.launches = ssd_mod.launches = 0
    for h in (h_att, h_ssm):
        out = h.fn(h.params, tokens)
        assert torch.isfinite(out).all()
    assert (fa.launches, ssd_mod.launches) == (2, 2)


def _flash_ssd_smoke(device):
    """A smoke-width bf16 flash call (GQA, window, softcap) and a float32 SSD
    call at mamba2's head and state sizes, as zero-argument functions."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a * rng.standard_normal(shape, np.float32))
               .to(device, torch.bfloat16) for a, shape in
               ((4.0, (1, 256, 4, 64)), (4.0, (1, 256, 2, 64)),
                (1.0, (1, 256, 2, 64))))
    x = torch.from_numpy(rng.standard_normal((1, 512, 4, 64), np.float32))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((1, 512, 4), np.float32)))
    A = -torch.exp(torch.from_numpy(rng.standard_normal(4).astype(np.float32)))
    B, C = (torch.from_numpy(rng.standard_normal((1, 512, 128), np.float32))
            for _ in range(2))
    args = [t.to(device) for t in (x, dt, A, B, C, torch.full((4,), 0.5))]
    return (lambda: ops.flash_attention(q, k, v, window=100, softcap=50.0),
            lambda: ops.ssd(*args, chunk=256))


@pytest.mark.cuda
def test_flash_and_ssd_from_two_threads_on_two_streams(cuda):
    """The fleet's concurrency: a flash call and an SSD call repeated on two
    streams from two threads at once give outputs equal bit for bit to the
    same calls made one after the other, and the locked launch counters
    hold exactly the calls made."""
    calls = _flash_ssd_smoke(cuda)
    want = [calls[0](), calls[1]()[0]]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in calls]
    reps = 50
    start = threading.Barrier(len(calls), timeout=60)
    fa.launches = ssd_mod.launches = 0
    fa.kernel_launches = dict.fromkeys(fa.kernel_launches, 0)

    def work(i):
        with torch.cuda.stream(streams[i]):
            cur = torch.cuda.current_stream(cuda)
            assert cur == streams[i] != torch.cuda.default_stream(cuda)
            start.wait()
            outs = [calls[i]() for _ in range(reps)]
            streams[i].synchronize()
        return [o if i == 0 else o[0] for o in outs]

    with ThreadPoolExecutor(max_workers=len(calls)) as pool:
        got = list(pool.map(work, range(len(calls)), timeout=300))
    for i, outs in enumerate(got):
        for out in outs:
            assert torch.equal(out, want[i])
    assert (fa.launches, ssd_mod.launches) == (reps, reps)
    assert fa.kernel_launches == {"wgmma": reps, "fp32": 0}


class _YieldingInt(int):
    """A counter stub: its addition hands the interpreter to the other
    thread (``time.sleep(0)`` releases the GIL) between a counter's read and
    its write, so an unlocked ``+=`` loses every update the other thread
    makes in between."""

    def __add__(self, other):
        time.sleep(0)
        return _YieldingInt(int(self) + other)


@pytest.mark.parametrize("mod,kernel", [(fa, "wgmma"), (ssd_mod, None),
                                        (dec, "mma"), (gmm_mod, "wgmma"),
                                        (adamw_mod, None)],
                         ids=["flash", "ssd", "decode", "gmm", "adamw"])
def test_launch_counters_lose_no_update_between_threads(mod, kernel):
    """More threads than cores raising one binding's counters, as serving
    engines on several threads do, through the function each wrapper calls
    where it launches its kernel, with the counters replaced by stubs that
    yield mid-update and the switch interval shortened: the lock must keep
    every update."""
    n = 1000
    workers = (os.cpu_count() or 1) + 1
    saved = (mod.launches, dict(getattr(mod, "kernel_launches", {})))
    mod.launches = _YieldingInt(0)
    if kernel is not None:
        mod.kernel_launches = {k: _YieldingInt(0)
                               for k in mod.kernel_launches}
    count = (lambda: mod._count(kernel)) if kernel else mod._count
    start = threading.Barrier(workers, timeout=60)

    def hammer(_):
        start.wait()
        for _ in range(n):
            count()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(hammer, range(workers), timeout=120))
        got = (mod.launches,
               mod.kernel_launches[kernel] if kernel else workers * n)
    finally:
        sys.setswitchinterval(interval)
        mod.launches = saved[0]
        if kernel is not None:
            mod.kernel_launches = saved[1]
    assert got == (workers * n, workers * n)


def _gmm_inputs(rng, t, d, f, e, dtype, device, sizes=None):
    if sizes is None:
        sizes = np.bincount(rng.integers(0, e, t), minlength=e)
    x = rng.standard_normal((t, d), np.float32)
    w = rng.standard_normal((e, d, f), np.float32) / np.sqrt(d)
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(w).to(device, dtype),
            torch.from_numpy(np.asarray(sizes, np.int32)).to(device))


def _check_gmm(x, w, sizes):
    before = gmm_mod.launches
    by_kernel = dict(gmm_mod.kernel_launches)
    by_kernel[gmm_mod.kernel_for(x.dtype, x.shape[0])] += 1
    got = ops.gmm(x, w, sizes)
    torch.cuda.synchronize()
    assert gmm_mod.launches == before + 1
    assert gmm_mod.kernel_launches == by_kernel
    want = ref.gmm(x.float(), w.float(), sizes)
    assert got.dtype == x.dtype and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[x.dtype])
    if x.dtype == torch.bfloat16:
        rel = float((got.float() - want).norm() / want.norm())
        assert rel <= BF16_REL_L2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("case", GMM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_matches_plain(cuda, case, dtype):
    _check_gmm(*_gmm_inputs(np.random.default_rng(19), *case, dtype, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [[5, 0, 0, 3], [0, 0, 0, 70], [70, 0, 0, 0],
                                   [1, 64, 0, 65]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_empty_groups_and_tile_edges(cuda, sizes, dtype):
    """Empty experts, one expert with every row, and groups that end one
    row into a tile or fill one exactly."""
    rng = np.random.default_rng(23)
    _check_gmm(*_gmm_inputs(rng, sum(sizes), 72, 80, 4, dtype, cuda, sizes))


# the wgmma kernel's edges: T not a multiple of the 128-row tile; D not a
# multiple of 64 (TMA zero-fills the depth tail); F not a multiple of 256; an
# expert of 300 rows (three tiles) starting at row 3; empty experts; runs
# starting at odd rows
GMM_TILE_EDGES = [
    # (d, f, sizes)
    (72, 264, [1, 299]),
    (200, 80, [0, 3, 300, 0, 30]),
    (136, 520, [65, 0, 127, 1, 64, 0, 0]),
    (4088, 8, [129, 0, 256]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GMM_TILE_EDGES)
def test_gmm_wgmma_kernel_tile_edges(cuda, case):
    d, f, sizes = case
    _check_gmm(*_gmm_inputs(np.random.default_rng(29), sum(sizes), d, f,
                            len(sizes), torch.bfloat16, cuda, sizes))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 8, gmm_mod.SPLIT_MAX_ROWS,
                               gmm_mod.SPLIT_MAX_ROWS + 1])
def test_gmm_split_path_at_decode_sizes(cuda, t):
    """Up to 64 rows D is split over several blocks (here 4096 over 4-16
    steps of 64 a split) and the partial sums added; one row more takes the
    wgmma kernel without a split."""
    d, f, e = 4096, 520, 16
    if t <= gmm_mod.SPLIT_MAX_ROWS:
        assert gmm_mod.splits_for(t, d, f) > 1
    _check_gmm(*_gmm_inputs(np.random.default_rng(31), t, d, f, e,
                            torch.bfloat16, cuda))


@pytest.mark.cuda
def test_gmm_kernel_refuses_what_it_does_not_take(cuda):
    x, w, sizes = _gmm_inputs(np.random.default_rng(0), 16, 8, 16, 2,
                              torch.float32, cuda)
    before = gmm_mod.launches
    with pytest.raises(ValueError, match="CUDA"):
        gmm_mod.gmm(x.cpu(), w, sizes)
    with pytest.raises(ValueError, match="dtypes"):
        gmm_mod.gmm(x.to(torch.bfloat16), w, sizes)
    with pytest.raises(ValueError, match="dtypes"):
        gmm_mod.gmm(x.half(), w.half(), sizes)
    with pytest.raises(ValueError, match="match"):
        gmm_mod.gmm(x, w[:, :4].contiguous(), sizes)
    with pytest.raises(ValueError, match="match"):
        gmm_mod.gmm(x, w, sizes[:1])
    with pytest.raises(ValueError, match="multiples of 8"):
        gmm_mod.gmm(x[:, :6].contiguous(), w[:, :6].contiguous(), sizes)
    with pytest.raises(ValueError, match="contiguous"):
        gmm_mod.gmm(x, w.transpose(1, 2).contiguous().transpose(1, 2), sizes)
    with pytest.raises(ValueError, match="int32"):
        gmm_mod.gmm(x, w, sizes.float())
    assert gmm_mod.launches == before


@pytest.mark.cuda
def test_moe_gmm_makes_no_host_sync_on_the_card(cuda):
    """The sort dispatch and its three kernel launches run with CUDA's
    sync debug mode set to raise on any synchronising call."""
    from repro_torch.models import moe
    cfg = moe.MoEConfig(d_model=64, d_ff=128, num_experts=8, top_k=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = moe.moe_init(gen, cfg)
    x = torch.randn((2, 12, 64), generator=gen, device=cuda)
    want, want_aux = moe.moe_gmm({k: v.cpu() for k, v in params.items()},
                                 cfg, x.cpu())
    before = gmm_mod.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = moe.moe_gmm(params, cfg, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert gmm_mod.launches == before + 3
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"])
def test_moe_decode_step_launches_gmm_three_times_a_layer(cuda, arch):
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    lm = M.LM(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), device=cuda,
                           dtype=torch.int32)
    cache = lm.init_cache(2, 16, torch.float32)
    logits, cache = lm.prefill(tokens, cache)
    gmm_mod.launches = 0
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    dlogits, _ = lm.decode_step(nxt, cache, torch.full((2,), 12, device=cuda,
                                                       dtype=torch.int32))
    assert gmm_mod.launches == 3 * cfg.num_layers
    want, _ = lm(torch.cat([tokens, nxt], 1))
    np.testing.assert_allclose(_np(dlogits[:, 0]), _np(want[:, -1]),
                               atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# training on the card (the torch path; the kernels refuse to be trained)
# ---------------------------------------------------------------------------

TRAIN_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TRAIN_STATE_TOL = dict(atol=1e-5, rtol=1e-4)


def _train_cfg(arch, dtype):
    import dataclasses
    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config(arch), vocab_size=128, dtype=dtype)


def _train_batch(device, vocab=128):
    from repro_torch.data import SyntheticLMData
    b = SyntheticLMData(vocab_size=vocab, seq_len=16, global_batch=4,
                        seed=3).batch(0)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _mid_run(state, seed=7):
    """m, v and the step of a run under way (see tests/test_torch_training.py
    for why a first step from zeros is not compared)."""
    from repro_torch.models import model as M
    g = torch.Generator().manual_seed(seed)
    state["opt"]["m"] = M.tree_map(
        lambda p: 1e-2 * torch.randn(p.shape, generator=g), state["params"])
    state["opt"]["v"] = M.tree_map(
        lambda p: 1e-5 + 9e-5 * torch.rand(p.shape, generator=g),
        state["params"])
    state["opt"]["step"] = torch.tensor(10, dtype=torch.int32)
    return state


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mamba2-130m"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    from repro_torch.models import model as M
    from repro_torch.training import (OptimConfig, TrainConfig,
                                      build_grad_fn, build_train_step,
                                      init_train_state)
    cfg = _train_cfg(arch, "float32")
    tcfg = TrainConfig(optim=OptimConfig(learning_rate=1e-2, warmup_steps=2,
                                         total_steps=20))
    cpu = _mid_run(init_train_state(torch.Generator().manual_seed(0), cfg,
                                    tcfg, "cpu"))
    card = M.tree_map(lambda t: t.to(cuda), cpu)
    bc, bg = _train_batch("cpu"), _train_batch(cuda)
    gc, mc = build_grad_fn(cfg, tcfg)(cpu["params"], bc)
    gg, mg = build_grad_fn(cfg, tcfg)(card["params"], bg)
    for (name, a), (_, b) in zip(_flat(gg), _flat(gc)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                   **TRAIN_GRAD_TOL, err_msg=name)
    step = build_train_step(cfg, tcfg)
    _, mc = step(cpu, bc)
    _, mg = step(card, bg)
    for k in mc:
        np.testing.assert_allclose(float(mg[k]), float(mc[k]), rtol=1e-5,
                                   err_msg=k)
    for (name, a), (_, b) in zip(_flat(card), _flat(cpu)):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                   **TRAIN_STATE_TOL, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,needs", [
    ("gemma2-2b", ("attn/wq", "attn/wk", "attn/wv")),
    ("mamba2-130m", ("ssm/in_proj",)),
    ("phi3.5-moe-42b-a6.6b", ("attn/wq", "attn/wk", "attn/wv", "moe/router")),
])
def test_bf16_train_step_gives_every_leaf_a_gradient(cuda, arch, needs):
    """A kernel output without a graph would leave every weight upstream of
    it with a zero gradient: every leaf's must be finite and nonzero."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gmm_mod
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.training import (TrainConfig, build_grad_fn,
                                      build_train_step, init_train_state)
    cfg = _train_cfg(arch, "bfloat16")
    tcfg = TrainConfig()
    state = init_train_state(torch.Generator(device=cuda).manual_seed(0), cfg,
                             tcfg, cuda)
    batch = _train_batch(cuda)
    mods = (fa, ssd_mod, dec, gmm_mod)
    before = [m.launches for m in mods]
    grads, _ = build_grad_fn(cfg, tcfg)(state["params"], batch)
    names = [name for name, _ in _flat(grads)]
    for need in needs:
        assert any(need in n for n in names), need
    for name, g in _flat(grads):
        assert g.dtype == torch.float32, name
        assert torch.isfinite(g).all(), name
        assert g.abs().max() > 0, f"{name}: zero gradient"
    _, metrics = build_train_step(cfg, tcfg)(state, batch)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert [m.launches for m in mods] == before     # no kernel on this path


@pytest.mark.cuda
def test_bf16_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    from repro_torch.distributed import CheckpointManager
    tree = {"w": torch.randn((5, 7), device=cuda).to(torch.bfloat16),
            "b": {"x": torch.arange(6, dtype=torch.float32, device=cuda)},
            "step": torch.tensor(3, dtype=torch.int32, device=cuda)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree)
    step, got, _ = mgr.restore(device=cuda)
    assert step == 3
    for (name, a), (_, b) in zip(_flat(got), _flat(tree)):
        assert a.device.type == "cuda" and a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert torch.equal(got["w"].view(torch.int16), tree["w"].view(torch.int16))


def _grad_inputs(name, device):
    """Small inputs of each kernel's ``ops`` wrapper on the card, bf16 where
    the kernel takes it; the first one will require grad."""
    g = torch.Generator(device=device).manual_seed(0)
    bf = torch.bfloat16

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=device).to(dtype)
    if name == "flash_attention":
        return (r(1, 64, 2, 64, dtype=bf), r(1, 64, 2, 64, dtype=bf),
                r(1, 64, 2, 64, dtype=bf)), {}
    if name == "ssd":
        return ((r(1, 64, 2, 16, dtype=bf),
                 torch.rand((1, 64, 2), generator=g, device=device),
                 -torch.ones(2, device=device), r(1, 64, 16), r(1, 64, 16),
                 torch.ones(2, device=device)), {"chunk": 32})
    if name == "decode_attention":
        return ((r(1, 2, 64, dtype=bf), r(1, 128, 2, 64, dtype=bf),
                 r(1, 128, 2, 64, dtype=bf),
                 torch.tensor([70], dtype=torch.int32, device=device)), {})
    return ((r(96, 64, dtype=bf), r(2, 64, 64, dtype=bf),
             torch.tensor([40, 56], dtype=torch.int32, device=device)), {})


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "ssd", "decode_attention",
                                  "gmm"])
def test_kernels_raise_on_inputs_that_require_grad(cuda, name):
    from repro_torch.kernels import ops
    args, kw = _grad_inputs(name, cuda)
    fn = getattr(ops, name)
    want = fn(*args, **kw)                  # plain tensors: the kernel runs
    args = (args[0].clone().requires_grad_(),) + args[1:]
    with pytest.raises(RuntimeError, match="no backward pass"):
        fn(*args, **kw)
    with torch.no_grad():                   # and no_grad lets it run again
        got = fn(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step on a one-device DeviceMesh (DTensor on the card's torch)
# ---------------------------------------------------------------------------


MESH_ARCHS = ["gemma-2b", "qwen1.5-4b", "gemma2-2b", "mamba2-130m",
              "phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "zamba2-2.7b",
              "phi-3-vision-4.2b", "musicgen-large", "minitron-8b"]


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_step_equals_the_meshless_step_on_the_card(cuda, arch, accum):
    """Two float32 steps at smoke width through ``Trainer`` on a one-device
    CUDA ``DeviceMesh`` (a one-rank NCCL group) equal the mesh-less
    ``Trainer``'s bit for bit, under deterministic algorithms: every op of
    the DTensor step has a rule in the card's torch (accum 2 adds the
    microbatch loop and the int8 compression)."""
    import dataclasses
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import smoke_config
    from repro_torch.distributed import CompressionConfig
    from repro_torch.distributed.sharding import full_tree
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import model as M
    from repro_torch.training import OptimConfig, TrainConfig, Trainer

    cfg = dataclasses.replace(smoke_config(arch), vocab_size=512,
                              dtype="float32")
    tcfg = TrainConfig(optim=OptimConfig(learning_rate=1e-2, warmup_steps=2,
                                         total_steps=20), accum=accum,
                       compression=CompressionConfig() if accum > 1 else None)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        t = rng.integers(0, 512, (4, 33)).astype(np.int32)
        b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        if cfg.frontend:
            b["frontend"] = rng.standard_normal(
                (4, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        batches.append(b)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        runs = []
        for m in (None, mesh):
            t = Trainer(cfg=cfg, tcfg=tcfg, data=iter(batches), mesh=m,
                        rules=rules_for(cfg, mesh) if m is not None else None,
                        log_every=1000, device="cuda")
            t.init_or_resume(resume="never")
            runs.append((t.run(2), full_tree(t.state)))
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    assert runs[0][0] == runs[1][0]
    for a, b in zip(M.tree_leaves(runs[0][1]), M.tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# CUDA graphs (repro_torch.graphs): the served forward and decode_step
# ---------------------------------------------------------------------------

SERVED = [("gemma-2b", 2), ("qwen1.5-4b", 2), ("gemma2-2b", 4),
          ("mamba2-130m", 2)]


def _tokens(seed, shape, vocab=128):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, shape).astype(
        np.int32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", SERVED, ids=[a for a, _ in SERVED])
def test_graphed_handle_equals_eager_bit_for_bit(cuda, arch, layers):
    """``build_handle`` on CUDA replays a graph whose logits equal the eager
    forward's bit for bit, and a call's logits are its own: a second call
    on other tokens leaves the first call's unchanged."""
    from repro_torch import graphs
    from repro_torch.launch.serve import build_handle
    h = build_handle(arch, "m", layers=layers)
    assert isinstance(h.fn, graphs.GraphedForward)
    t1, t2 = _tokens(1, (1, 32)), _tokens(2, (1, 32))
    first = h.fn(h.params, t1)
    kept = first.clone()
    second = h.fn(h.params, t2)
    torch.cuda.synchronize()
    assert len(h.fn.graphs) == 1
    assert torch.equal(first, h.fn.eager(h.params, t1))
    assert torch.equal(second, h.fn.eager(h.params, t2))
    assert torch.equal(first, kept) and not torch.equal(first, second)


@pytest.mark.cuda
def test_graphed_handle_captures_again_on_a_new_shape_or_new_params(cuda):
    """As ``jax.jit`` retraces: a new tokens shape or new params (other
    storage) capture a graph of their own; the same key replays."""
    from repro_torch.launch.serve import build_handle
    from repro_torch.models import model as M
    h = build_handle("gemma2-2b", "ctx", layers=2)
    t32, t16 = _tokens(3, (1, 32)), _tokens(4, (1, 16))
    h.fn(h.params, t32)
    h.fn(h.params, t32)
    assert len(h.fn.graphs) == 1
    assert torch.equal(h.fn(h.params, t16), h.fn.eager(h.params, t16))
    assert len(h.fn.graphs) == 2
    other = M.tree_map(lambda t: (t * 1.5).to(t.dtype), h.params)
    got = h.fn(other, t32)
    assert len(h.fn.graphs) == 3
    assert torch.equal(got, h.fn.eager(other, t32))
    assert not torch.equal(got, h.fn(h.params, t32))
    assert len(h.fn.graphs) == 3


@pytest.mark.cuda
def test_graphed_replay_adds_the_capture_s_launches(cuda):
    """The capture records the launches of its calls and each replay adds
    them to the counters: one flash launch a layer, one SSD call a layer."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import build_handle
    for arch, layers, want in (
            ("gemma2-2b", 4, {"flash_attention": (4, {"wgmma": 4})}),
            ("mamba2-130m", 3, {"ssd": (3, {})})):
        h = build_handle(arch, "m", layers=layers)
        tokens = _tokens(5, (1, 32))
        h.fn(h.params, tokens)
        (graph,) = h.fn.graphs.values()
        assert graph.launches == want
        before = build.counts()
        for _ in range(3):
            h.fn(h.params, tokens)
        after = build.counts()
        for name, (n, by_kernel) in before.items():
            dn, dk = want.get(name, (0, {}))
            assert after[name] == (n + 3 * dn, {
                k: v + 3 * dk.get(k, 0) for k, v in by_kernel.items()})


def _decode_model(arch, seed=0):
    from repro_torch.configs import smoke_config
    from repro_torch.convert import to_compute_dtype
    from repro_torch.models import model as M
    cfg = smoke_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = to_compute_dtype(M.init_params(gen, cfg, "cuda"),
                              M.compute_dtype(cfg))
    return cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m",
                                  "qwen3-moe-235b-a22b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_graphed_decode_equals_eager_bit_for_bit(cuda, arch):
    """bf16 prefill, then five greedy steps eagerly and through
    ``GraphedDecode`` from a copy of the same cache, fed the same tokens at
    the same positions (one each sequence): every step's logits and the
    final caches equal bit for bit."""
    from repro_torch import graphs
    from repro_torch.models import model as M
    cfg, params = _decode_model(arch)
    b, s, steps = 2, 12, 5
    with torch.inference_mode():
        cache = M.init_cache(cfg, b, 24, torch.bfloat16, "cuda")
        logits, cache = M.prefill(params, cfg, _tokens(6, (b, s), 256), cache)
        gcache = M.tree_map(torch.clone, cache)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        feed, want = [], []
        for i in range(steps):
            pos = torch.tensor([s + i, s - 3 + i], dtype=torch.int32,
                               device=cuda)
            logits, cache = M.decode_step(params, cfg, nxt, cache, pos)
            feed.append((nxt, pos))
            want.append(logits)
            nxt = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
    step = graphs.GraphedDecode(params, cfg, gcache)
    for (tok, pos), w in zip(feed, want):
        got, out_cache = step(tok, pos)
        assert out_cache is gcache and torch.equal(got, w)
    assert len(step.graphs) == 1
    for a, c in zip(M.tree_leaves(gcache), M.tree_leaves(cache)):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_graphed_decode_on_two_streams_at_once_equals_replays_in_turn(cuda):
    """Two ``GraphedDecode``s (two caches, one model), each captured and
    replayed on its own stream by its own thread at once, behind a device
    sleep so that the replays run side by side, at a shape whose global
    layers split and merge on tickets: every output equals the same step
    replayed in turn, bit for bit. Each graph's decode calls own their
    tickets."""
    from repro_torch import graphs
    from repro_torch.models import model as M
    cfg, params = _decode_model("gemma2-2b")
    s = 2048
    assert dec.num_splits(1, cfg.num_kv_heads, s, None,
                          cfg.num_heads // cfg.num_kv_heads,
                          cfg.head_dim) > 1
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    steps, args = [], []
    for i in range(2):
        gen = torch.Generator(device="cuda").manual_seed(60 + i)
        cache = M.tree_map(
            lambda t: torch.randn(t.shape, generator=gen, device="cuda").to(
                t.dtype), M.init_cache(cfg, 1, s, torch.bfloat16, "cuda"))
        steps.append(graphs.GraphedDecode(params, cfg, cache))
        args.append((_tokens(61 + i, (1, 1), 256),
                     torch.tensor([1500 - 200 * i], dtype=torch.int32,
                                  device=cuda)))
    want = []
    for i in range(2):                       # capture, then in turn
        with torch.cuda.stream(streams[i]):
            steps[i](*args[i])
            want.append(steps[i](*args[i])[0])
            streams[i].synchronize()
    assert not torch.equal(want[0], want[1])
    reps = 30
    start = threading.Barrier(2, timeout=60)

    def work(i):
        with torch.cuda.stream(streams[i]):
            start.wait()
            torch.cuda._sleep(10_000_000)
            outs = [steps[i](*args[i])[0] for _ in range(reps)]
            streams[i].synchronize()
        return outs

    with ThreadPoolExecutor(max_workers=2) as pool:
        got = list(pool.map(work, range(2), timeout=300))
    for i, outs in enumerate(got):
        assert len(steps[i].graphs) == 1
        for out in outs:
            assert torch.equal(out, want[i])


@pytest.mark.cuda
def test_a_failed_capture_raises_and_falls_back_to_nothing(cuda):
    """A function that synchronises the device cannot be captured: the
    graphed call raises, the function ran only its warm-up calls and the
    capture (no eager call after), nothing is kept, the caller's stream is
    current again, and the next capture works."""
    from repro_torch import graphs
    calls = []

    def bad(p, t):
        calls.append(t)
        torch.cuda.synchronize()
        return t * p["w"]

    params = {"w": torch.full((4,), 2.0, device=cuda)}
    t = torch.ones(4, device=cuda)
    g = graphs.GraphedForward(bad)
    with pytest.raises(RuntimeError):
        g(params, t)
    assert len(calls) == graphs.WARMUP_CALLS + 1 and g.graphs == {}
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    ok = graphs.GraphedForward(lambda p, x: x * p["w"])
    assert torch.equal(ok(params, t), t * 2) and len(ok.graphs) == 1


# ---------------------------------------------------------------------------
# the train step: the AdamW kernel and the graphed step (GraphedTrainStep)
# ---------------------------------------------------------------------------

#: leaf sizes the AdamW kernel is held to its plain version at: one element,
#: either side of a block of 256 threads, and past a million
ADAMW_SIZES = [1, 255, 257, 2 ** 20 + 3]


def _adamw_inputs(n, dtype, seed=0):
    """p (``dtype``), g, m, v and the device scalars of a mid-run step."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(n, generator=g, device="cuda").to(dtype)
    grad = 3 * torch.randn(n, generator=g, device="cuda")
    m = 0.1 * torch.randn(n, generator=g, device="cuda")
    v = 1e-2 * torch.rand(n, generator=g, device="cuda")
    step = torch.tensor(7, dtype=torch.int32, device="cuda")
    from repro_torch.training import OptimConfig, lr_at
    cfg = OptimConfig(learning_rate=1e-2, warmup_steps=3, total_steps=20)
    scalars = dict(lr=lr_at(cfg, step), b1c=1.0 - cfg.b1 ** step.float(),
                   b2c=1.0 - cfg.b2 ** step.float())
    return (p, grad, m, v), scalars, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("n", ADAMW_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("decay", [0.0, 0.1])
def test_adamw_kernel_equals_plain_bit_for_bit(cuda, n, dtype, clip, decay):
    """One launch of ``csrc/adamw.cu`` against ``ref.adamw`` on copies of
    the same inputs: p, m and v equal bit for bit, g untouched."""
    leaf, scalars, cfg = _adamw_inputs(n, dtype)
    scale = (torch.clamp(0.5 / (torch.linalg.vector_norm(leaf[1]) + 1e-9),
                         max=1.0) if clip else None)
    kw = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=decay)
    want = [t.clone() for t in leaf]
    got = [t.clone() for t in leaf]
    before = adamw_mod.launches
    ref.adamw(*want, **scalars, scale=scale, **kw)
    ops.adamw(*got, **scalars, scale=scale, **kw)
    torch.cuda.synchronize()
    assert adamw_mod.launches == before + 1
    assert torch.equal(got[1], leaf[1])
    for name, a, b in zip("pgmv", got, want):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), (name, float((a.float() - b.float())
                                              .abs().max()))
    assert not torch.equal(got[0], leaf[0])


@pytest.mark.cuda
def test_adamw_kernel_refuses_what_it_does_not_take(cuda):
    leaf, scalars, cfg = _adamw_inputs(64, torch.float32)
    kw = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=0.0)
    p, g, m, v = leaf
    with pytest.raises(ValueError, match="contiguous"):
        adamw_mod.adamw(p.reshape(8, 8).t(), g.reshape(8, 8), m.reshape(8, 8),
                        v.reshape(8, 8), *scalars.values(), None, **kw)
    with pytest.raises(ValueError, match="shape"):
        adamw_mod.adamw(p, g[:32], m, v, *scalars.values(), None, **kw)
    with pytest.raises(ValueError, match="float32"):
        adamw_mod.adamw(p, g, m.to(torch.bfloat16), v, *scalars.values(),
                        None, **kw)
    with pytest.raises(ValueError, match="one value"):
        adamw_mod.adamw(p, g, m, v, g, scalars["b1c"], scalars["b2c"], None,
                        **kw)


def _graph_train_cfg(arch, dtype, accum=2, **opt):
    from repro_torch.distributed import CompressionConfig
    from repro_torch.training import OptimConfig, TrainConfig
    opt = dict(dict(learning_rate=1e-2, warmup_steps=2, total_steps=20), **opt)
    return (_train_cfg(arch, dtype),
            TrainConfig(optim=OptimConfig(**opt), accum=accum,
                        compression=CompressionConfig()))


def _graph_batches(steps, seq=16, batch=4, seed=3):
    from repro_torch.data import SyntheticLMData
    data = SyntheticLMData(vocab_size=128, seq_len=seq, global_batch=batch,
                           seed=seed)
    return [data.batch(i) for i in range(steps)]


def _eager_loop(cfg, tcfg, batches, seed=0):
    """``build_train_step`` called in a loop on a fresh state of ``seed``:
    the eager control of a graphed run. (metrics as ``Trainer`` keeps them,
    final state)."""
    from repro_torch.training import build_train_step, init_train_state
    state = init_train_state(torch.Generator(device="cuda").manual_seed(seed),
                             cfg, tcfg, "cuda")
    step = build_train_step(cfg, tcfg)
    hist = []
    for i, b in enumerate(batches):
        _, m = step(state, {k: torch.as_tensor(v).cuda() for k, v in b.items()})
        hist.append({k: float(v) for k, v in m.items()} | {"step": i + 1})
    return hist, state


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mamba2-130m"])
def test_graphed_trainer_equals_the_eager_loop_bit_for_bit(cuda, arch, dtype):
    """``Trainer`` on CUDA replays a ``GraphedTrainStep`` after its two
    eager warm-up steps: six steps with accum 2 and int8 compression give
    the eager loop's metrics and final state (params, m, v, step, err) bit
    for bit under deterministic algorithms; one graph, and every step after
    the capture launches the AdamW kernel through the replay."""
    from repro_torch import graphs
    from repro_torch.models import model as M
    from repro_torch.training import Trainer
    cfg, tcfg = _graph_train_cfg(arch, dtype)
    batches = _graph_batches(6)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want_hist, want = _eager_loop(cfg, tcfg, batches)
        t = Trainer(cfg=cfg, tcfg=tcfg, data=iter(batches), log_every=1000,
                    device="cuda")
        assert isinstance(t._step_fn, graphs.GraphedTrainStep)
        t.init_or_resume(resume="never")
        ptrs = [x.data_ptr() for x in M.tree_leaves(t.state)]
        before = adamw_mod.launches
        hist = t.run(6)
    finally:
        torch.use_deterministic_algorithms(False)
    n_leaves = len(M.tree_leaves(t.state["params"]))
    assert adamw_mod.launches - before == 6 * n_leaves
    assert len(t._step_fn.graphs) == 1
    assert [x.data_ptr() for x in M.tree_leaves(t.state)] == ptrs
    assert hist == want_hist
    for a, b in zip(M.tree_leaves(t.state), M.tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graphed_train_step_captures_again_on_a_new_shape_or_state(cuda,
                                                                   tmp_path):
    """As ``jax.jit`` retraces: a new batch shape, and a state restored
    from a checkpoint (new addresses), each warm up and capture a graph of
    their own, and every step still equals the eager loop's bit for bit."""
    from repro_torch import graphs
    from repro_torch.distributed import CheckpointManager
    from repro_torch.models import model as M
    from repro_torch.training import build_train_step, init_train_state
    cfg, tcfg = _graph_train_cfg("qwen1.5-4b", "float32")
    short, long_ = _graph_batches(4), _graph_batches(4, seq=24, seed=4)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want_hist, want = _eager_loop(cfg, tcfg, short + long_)
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                 cfg, tcfg, "cuda")
        step = graphs.GraphedTrainStep(build_train_step(cfg, tcfg))
        hist = []
        for i, b in enumerate(short + long_):
            _, m = step(state, {k: torch.as_tensor(v).cuda()
                                for k, v in b.items()})
            hist.append({k: float(v) for k, v in m.items()} | {"step": i + 1})
            if i == 3:
                assert len(step.graphs) == 1
        assert len(step.graphs) == 2 and hist == want_hist
        for a, b in zip(M.tree_leaves(state), M.tree_leaves(want)):
            assert torch.equal(a, b)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(8, state)
        _, restored, _ = mgr.restore(device="cuda")
        more = _graph_batches(3, seed=9)
        for b in more:
            bt = {k: torch.as_tensor(v).cuda() for k, v in b.items()}
            _, mr = step(restored, bt)
            _, mw = build_train_step(cfg, tcfg)(want, bt)
            assert {k: float(v) for k, v in mr.items()} == \
                {k: float(v) for k, v in mw.items()}
        assert len(step.graphs) == 3
        for a, b in zip(M.tree_leaves(restored), M.tree_leaves(want)):
            assert torch.equal(a, b)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_graphed_train_step_replays_add_the_capture_s_launches(cuda):
    """The capture records one AdamW launch a params leaf and each replay
    adds it to the counters; the forward kernels launch nothing."""
    from repro_torch import graphs
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.training import build_train_step, init_train_state
    cfg, tcfg = _graph_train_cfg("mamba2-130m", "bfloat16")
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, tcfg, "cuda")
    n_leaves = len(M.tree_leaves(state["params"]))
    step = graphs.GraphedTrainStep(build_train_step(cfg, tcfg))
    batches = [{k: torch.as_tensor(v).cuda() for k, v in b.items()}
               for b in _graph_batches(6)]
    before = build.counts()
    for b in batches[:graphs.WARMUP_CALLS + 1]:
        step(state, b)
    (graph,) = step.graphs.values()
    assert graph.launches == {"adamw": (n_leaves, {})}
    mid = build.counts()
    for b in batches[graphs.WARMUP_CALLS + 1:]:
        step(state, b)
    after = build.counts()
    replays = len(batches) - graphs.WARMUP_CALLS
    assert mid["adamw"][0] - before["adamw"][0] == \
        (graphs.WARMUP_CALLS + 1) * n_leaves
    assert after["adamw"][0] - before["adamw"][0] == \
        (graphs.WARMUP_CALLS + replays) * n_leaves
    for name in ("flash_attention", "ssd", "decode_attention", "gmm"):
        assert after[name] == before[name]


@pytest.mark.cuda
def test_graphed_lr_schedule_crosses_the_capture_like_the_eager_run(cuda):
    """The learning rate is computed on the device inside the graph and
    read by the kernel from there: over a warm-up of 4 steps and a cosine
    decay, every step's lr (the eager warm-up steps, the capture's replay
    and the later replays) equals the eager run's, and no two steps share
    one."""
    from repro_torch.training import Trainer
    cfg, tcfg = _graph_train_cfg("qwen1.5-4b", "float32", accum=1,
                                 warmup_steps=4, total_steps=8)
    batches = _graph_batches(7)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want_hist, _ = _eager_loop(cfg, tcfg, batches)
        t = Trainer(cfg=cfg, tcfg=tcfg, data=iter(batches), log_every=1000,
                    device="cuda")
        t.init_or_resume(resume="never")
        hist = t.run(7)
    finally:
        torch.use_deterministic_algorithms(False)
    lrs = [m["lr"] for m in hist]
    assert lrs == [m["lr"] for m in want_hist]
    assert len(set(lrs)) == len(lrs)
    assert hist == want_hist


@pytest.mark.cuda
def test_a_failed_train_step_capture_raises_and_restores_the_stream(cuda):
    """A step that synchronises the device cannot be captured: its two
    warm-up steps run, the third call raises, nothing is kept, the caller's
    stream is current again, and nothing fell back to the eager step."""
    from repro_torch import graphs
    from repro_torch.training import build_train_step, init_train_state
    cfg, tcfg = _graph_train_cfg("qwen1.5-4b", "float32")
    eager = build_train_step(cfg, tcfg)
    calls = []

    def bad(state, batch):
        calls.append(1)
        torch.cuda.synchronize()
        return eager(state, batch)

    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, tcfg, "cuda")
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in _graph_batches(1)[0].items()}
    step = graphs.GraphedTrainStep(bad)
    for _ in range(graphs.WARMUP_CALLS):
        step(state, batch)
    done = int(state["opt"]["step"])
    with pytest.raises(RuntimeError):
        step(state, batch)
    assert len(calls) == graphs.WARMUP_CALLS + 1 and step.graphs == {}
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert int(state["opt"]["step"]) == done == graphs.WARMUP_CALLS


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_train_step_makes_no_host_sync(cuda, arch):
    """One eager step of each architecture at smoke width (accum 2, int8
    compression, deterministic algorithms, whose embedding backward sorts)
    under ``torch.cuda.set_sync_debug_mode("error")``: a step that read a
    value back to the host could not be captured."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.training import build_train_step, init_train_state
    cfg = dataclasses.replace(smoke_config(arch), vocab_size=512,
                              dtype="bfloat16")
    _, tcfg = _graph_train_cfg(arch, "bfloat16")
    rng = np.random.default_rng(5)
    t = rng.integers(0, 512, (4, 33)).astype(np.int32)
    b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if cfg.frontend:
        b["frontend"] = rng.standard_normal(
            (4, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, tcfg, "cuda")
    step = build_train_step(cfg, tcfg)
    step(state, batch)                      # lazy set-up outside the check
    torch.cuda.synchronize()
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_mesh_trainer_with_the_kernel_on_shards_equals_the_graphed_one(cuda):
    """Five float32 steps (accum 2, int8 compression) through ``Trainer`` on
    a one-device CUDA mesh, whose AdamW kernel runs on each rank's local
    shards, equal the mesh-less ``Trainer``'s bit for bit under
    deterministic algorithms; both graph their step (the steps after the
    second replay a CUDA graph) and launch the kernel once a leaf a step."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import graphs
    from repro_torch.distributed.sharding import full_tree
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import model as M
    from repro_torch.training import Trainer
    cfg, tcfg = _graph_train_cfg("qwen1.5-4b", "float32")
    batches = _graph_batches(5)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        runs = []
        for m in (None, mesh):
            t = Trainer(cfg=cfg, tcfg=tcfg, data=iter(batches), mesh=m,
                        rules=rules_for(cfg, mesh) if m is not None else None,
                        log_every=1000, device="cuda")
            assert isinstance(t._step_fn, graphs.GraphedTrainStep)
            t.init_or_resume(resume="never")
            before = adamw_mod.launches
            hist = t.run(5)
            runs.append((hist, full_tree(t.state),
                         adamw_mod.launches - before))
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    n_leaves = len(M.tree_leaves(runs[0][1]["params"]))
    assert runs[0][2] == runs[1][2] == 5 * n_leaves
    assert runs[0][0] == runs[1][0]
    for a, b in zip(M.tree_leaves(runs[0][1]), M.tree_leaves(runs[1][1])):
        assert torch.equal(a, b)
