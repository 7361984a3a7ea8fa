"""The port's kernels against the JAX package's, on shared numpy inputs.

On the CPU the port's ``ops`` wrappers run the plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode, as tests/test_kernels.py
does. Tolerances are the reference's: atol = rtol = 3e-5 in float32 and 2e-2
in bfloat16 for attention, 3e-4 for the SSD scan against the sequential
definition (the chunked form sums in another order). The CUDA kernels are
held to the plain versions on the card in tests/test_torch_cuda.py.
"""
import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gmm as gmm_mod
from repro_torch.kernels import mamba_front as front_mod
from repro_torch.kernels import ssd as ssd_mod

FLASH_CASES = [
    # (b, sq, n, kv, h, window, softcap) -- tests/test_kernels.py's list
    (1, 32, 2, 2, 16, None, None),          # MHA baseline
    (2, 40, 4, 2, 16, None, None),          # GQA, non-aligned seq
    (1, 130, 8, 1, 32, None, None),         # MQA, ragged seq
    (2, 64, 4, 4, 64, None, 50.0),          # softcap (gemma2 attn)
    (1, 96, 4, 2, 32, 17, None),            # sliding window
    (1, 128, 8, 2, 64, 64, 30.0),           # window + softcap
]

SSD_CASES = [
    # (b, s, h, p, n, chunk)
    (1, 32, 2, 8, 16, 8),
    (2, 48, 3, 8, 16, 16),
    (1, 100, 2, 16, 32, 32),                # ragged vs chunk
    (2, 64, 4, 32, 64, 64),
]

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=3e-5, rtol=3e-5)


def _both(a: np.ndarray, dtype: str = "float32"):
    """The same numpy array on both sides, cast to ``dtype`` (both casts
    round to nearest even, so the bfloat16 inputs agree bit for bit)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(rng, b, sq, n, kv, h):
    return (rng.standard_normal((b, sq, n, h), np.float32),
            rng.standard_normal((b, sq, kv, h), np.float32),
            rng.standard_normal((b, sq, kv, h), np.float32))


def _ssd_inputs(rng, b, s, h, p, n):
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), np.float32)))
    A = -np.exp(0.5 * rng.standard_normal((h,), np.float32))
    B = rng.standard_normal((b, s, n), np.float32)
    C = rng.standard_normal((b, s, n), np.float32)
    D = np.full((h,), 0.5, np.float32)
    return x, dt.astype(np.float32), A.astype(np.float32), B, C, D


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_kernel(case, dtype):
    b, sq, n, kv, h, win, cap = case
    arrays = _qkv(np.random.default_rng(7), b, sq, n, kv, h)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in arrays)
    want = jops.flash_attention(jq, jk, jv, window=win, softcap=cap,
                                block_q=32, block_k=32, interpret=True)
    got = ops.flash_attention(tq, tk, tv, window=win, softcap=cap,
                              block_q=32, block_k=32)
    assert got.dtype == DTYPES[dtype][1] and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("case", FLASH_CASES[3:])
def test_ref_attention_matches_jax_ref(case, q_offset):
    b, sq, n, kv, h, win, cap = case
    arrays = _qkv(np.random.default_rng(3), b, sq, n, kv, h)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in arrays)
    want = jref.attention(jq, jk, jv, window=win, softcap=cap,
                          q_offset=q_offset)
    got = ref.attention(tq, tk, tv, window=win, softcap=cap, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)


def test_flash_attention_block_size_invariance():
    """Padding to other block sizes must not change the result (the padded
    keys are masked for real queries by causality)."""
    b, s, n, kv, h = 1, 130, 4, 2, 32
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(1), b, s, n, kv, h))
    outs = [ops.flash_attention(q, k, v, window=20, block_q=bq, block_k=bk)
            for bq, bk in [(16, 16), (32, 64), (128, 128)]]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), atol=3e-5,
                                   rtol=3e-5)


def test_flash_attention_noncausal_requires_aligned_blocks():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(1), 1, 40, 2, 2, 16))
    with pytest.raises(AssertionError, match="block-aligned"):
        ops.flash_attention(q, k, v, causal=False, block_q=32, block_k=32)
    full = ops.flash_attention(q, k, v, causal=False, block_q=40, block_k=40)
    want = ref.attention(q, k, v, causal=False)
    np.testing.assert_allclose(full.numpy(), want.numpy(), atol=3e-5, rtol=3e-5)


# ---------------------------------------------------------------------------
# ssd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_matches_jax_kernel_and_sequential_oracle(case):
    b, s, h, p, n, ch = case
    arrays = _ssd_inputs(np.random.default_rng(11), b, s, h, p, n)
    jx, tx = zip(*(_both(a) for a in arrays))
    y_k, fin_k = jops.ssd(*jx, chunk=ch, interpret=True)
    y_seq, fin_seq = jref.ssd(*jx)
    y, fin = ops.ssd(*tx, chunk=ch)
    assert y.shape == (b, s, h, p) and fin.shape == (b, h, n, p)
    for got, want in ((y, y_k), (fin, fin_k), (y, y_seq), (fin, fin_seq)):
        np.testing.assert_allclose(_np(got), _np(want), atol=3e-4, rtol=3e-4)


def test_ssd_sequential_matches_jax_sequential():
    arrays = _ssd_inputs(np.random.default_rng(5), 2, 24, 3, 8, 16)
    jx, tx = zip(*(_both(a) for a in arrays))
    for got, want in zip(ref.ssd(*tx), jref.ssd(*jx)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_ssd_chunked_matches_sequential():
    tx = [torch.from_numpy(a) for a in
          _ssd_inputs(np.random.default_rng(2), 1, 64, 2, 8, 16)]
    y1, f1 = ref.ssd(*tx)
    for chunk in (4, 16, 64):
        y2, f2 = ref.ssd_chunked(*tx, chunk=chunk)
        np.testing.assert_allclose(y2.numpy(), y1.numpy(), atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(f2.numpy(), f1.numpy(), atol=2e-4, rtol=2e-4)


def test_ssd_bf16_x_keeps_fp32_state():
    """x in bfloat16 with fp32 dt/B/C (the model's mixed dtypes): y comes
    back in bfloat16, the state in float32, both as the JAX kernel gives."""
    arrays = list(_ssd_inputs(np.random.default_rng(4), 1, 32, 2, 8, 16))
    jx = [jnp.asarray(arrays[0], jnp.bfloat16)] + [jnp.asarray(a) for a in arrays[1:]]
    tx = [torch.from_numpy(arrays[0]).to(torch.bfloat16)] + \
        [torch.from_numpy(a) for a in arrays[1:]]
    y_k, fin_k = jops.ssd(*jx, chunk=8, interpret=True)
    y, fin = ops.ssd(*tx, chunk=8)
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(y_k), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(fin), _np(fin_k), atol=3e-4, rtol=3e-4)


def test_ssd_carries_state_across_chunks():
    """A long-decay head must propagate influence beyond one chunk."""
    b, s, h, p, n = 1, 32, 1, 4, 8
    x = torch.zeros((b, s, h, p))
    x[0, 0] = 1.0                                        # impulse at t=0
    dt = 0.1 * torch.ones((b, s, h))
    A = torch.tensor([-0.01])                            # slow decay
    B = torch.ones((b, s, n))
    C = torch.ones((b, s, n))
    D = torch.zeros((h,))
    y, _ = ops.ssd(x, dt, A, B, C, D, chunk=8)
    assert float(y[0, -1].abs().max()) > 1e-3            # crossed 4 chunks


def test_ssd_dt0_padding_is_a_no_op():
    """Positions with dt = 0 leave the state as it was: exactly in the
    sequential definition, to rounding in the chunked wrapper."""
    b, s, h, p, n, ch = 1, 40, 2, 8, 16, 16
    rng = np.random.default_rng(9)
    tx = [torch.from_numpy(a) for a in _ssd_inputs(rng, b, s, h, p, n)]
    x, dt, A, B, C, D = tx
    extra = 24
    xp = torch.cat([x, torch.from_numpy(
        rng.standard_normal((b, extra, h, p), np.float32))], 1)
    dtp = torch.cat([dt, torch.zeros((b, extra, h))], 1)
    Bp = torch.cat([B, torch.from_numpy(
        rng.standard_normal((b, extra, n), np.float32))], 1)
    Cp = torch.cat([C, torch.from_numpy(
        rng.standard_normal((b, extra, n), np.float32))], 1)
    _, fin = ref.ssd(x, dt, A, B, C, D)
    _, fin_p = ref.ssd(xp, dtp, A, Bp, Cp, D)
    assert torch.equal(fin, fin_p)
    y, fin = ops.ssd(x, dt, A, B, C, D, chunk=ch)
    y_p, fin_p = ops.ssd(xp, dtp, A, Bp, Cp, D, chunk=ch)
    np.testing.assert_allclose(y_p[:, :s].numpy(), y.numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(fin_p.numpy(), fin.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_ssd_kernel_names_are_the_roofline_readers():
    """Every kernel of csrc/ssd.cu has a name that the benchmark's
    ``ssd_roofline`` reader sums device time by: a kernel under another
    name would drop out of the share's denominator."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "ssd_roofline", root / "rtmmbench" / "metrics" / "ssd_roofline.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    src = (root / "src" / "repro_torch" / "kernels" / "csrc" / "ssd.cu").read_text()
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert names and set(names) <= set(reader.KERNELS), names


# ---------------------------------------------------------------------------
# Mamba2's front
# ---------------------------------------------------------------------------


def _front_case(arch: str, b: int, s: int, dtype, weights: str, seed=0):
    """(ssm config, params, zxbcdt) at ``arch``'s smoke width: weights as
    ``ssm_init`` draws them, conv_w and conv_b in float32 or, as the
    benchmark serves them, in ``dtype``."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    cfg = M.ssm_cfg_for(smoke_config(arch))
    gen = torch.Generator().manual_seed(seed)
    p = ssm.ssm_init(gen, cfg)
    p["conv_b"] = 0.1 * torch.randn(p["conv_b"].shape, generator=gen)
    if weights == "compute":
        p["conv_w"], p["conv_b"] = p["conv_w"].to(dtype), p["conv_b"].to(dtype)
    zx = torch.randn((b, s, cfg.proj_out), generator=gen).to(dtype)
    return cfg, p, zx


def _front_before(p, cfg, zxbcdt):
    """What ``ssm_full`` ran between in_proj and the scan before the front
    was one op, as it was written there."""
    di = cfg.d_inner
    xbc = zxbcdt[..., di: di + cfg.conv_channels]
    dt = zxbcdt[..., di + cfg.conv_channels:]
    k, c = p["conv_w"].shape
    w = p["conv_w"].to(xbc.dtype).t().reshape(c, 1, k)
    xt = torch.nn.functional.pad(xbc.transpose(1, 2), (k - 1, 0))
    conv = torch.nn.functional.conv1d(xt, w, groups=c).transpose(1, 2)
    xbc = torch.nn.functional.silu(conv + p["conv_b"].to(xbc.dtype))
    x = xbc[..., :di]
    bmat = xbc[..., di: di + cfg.state].float()
    cmat = xbc[..., di + cfg.state:].float()
    dt = torch.nn.functional.softplus(dt.float() + p["dt_bias"][None, None, :])
    return (x.reshape(*x.shape[:2], cfg.heads, cfg.head_dim), bmat, cmat, dt)


def _front_kw(cfg):
    return dict(xbc_at=cfg.d_inner, dt_at=cfg.d_inner + cfg.conv_channels,
                state=cfg.state)


@pytest.mark.parametrize("weights", ["float32", "compute"])
@pytest.mark.parametrize("b, s", [(2, 19), (1, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_ref_mamba_front_is_the_sequence_it_replaced(arch, dtype, b, s,
                                                     weights):
    """The plain version, and ``ops.mamba_front`` on CPU tensors (which
    launches nothing), equal the operations ``ssm_full`` ran one by one
    bit for bit, S shorter than the conv's taps included."""
    cfg, p, zx = _front_case(arch, b, s, dtype, weights)
    want = _front_before(p, cfg, zx)
    args = (zx, p["conv_w"], p["conv_b"], p["dt_bias"])
    before = front_mod.launches
    for got in (ref.mamba_front(*args, **_front_kw(cfg)),
                ops.mamba_front(*args, **_front_kw(cfg))):
        assert [t.dtype for t in got] == [dtype] + [torch.float32] * 3
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert front_mod.launches == before


def test_mamba_front_on_meta_tensors_gives_the_shapes():
    """The dry-run's meta tensors take the plain version: shapes and
    dtypes only, no launch."""
    cfg, p, zx = _front_case("mamba2-130m", 2, 7, torch.bfloat16, "float32")
    meta = [t.to("meta") for t in (zx, p["conv_w"], p["conv_b"],
                                   p["dt_bias"])]
    before = front_mod.launches
    x, bmat, cmat, dt = ops.mamba_front(*meta, **_front_kw(cfg))
    assert x.device.type == "meta"
    assert (x.shape, x.dtype) == ((2, 7, cfg.heads, cfg.head_dim),
                                  torch.bfloat16)
    assert [(t.shape, t.dtype) for t in (bmat, cmat, dt)] == [
        ((2, 7, cfg.state), torch.float32)] * 2 + [((2, 7, cfg.heads),
                                                    torch.float32)]
    assert front_mod.launches == before


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values, contiguous, one element past an aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _odd_stride(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t``'s values in a view whose stride along ``dim`` (batch or row)
    is one element longer, so odd: the kernel loads channel pairs as one
    word, which such rows would split."""
    shape = list(t.shape)
    shape[dim + 1:] = [math.prod(shape[dim + 1:]) + 1]
    out = torch.empty(shape, dtype=t.dtype)[..., :-1].unflatten(
        -1, t.shape[dim + 1:])
    out.copy_(t)
    return out


FRONT_REFUSED = {
    "zxbcdt dtype": lambda zx, w, b, d, kw: ((zx.half(), w, b, d), kw),
    "conv_w dtype": lambda zx, w, b, d, kw: ((zx, w.half(), b, d), kw),
    "dt_bias must be float32": lambda zx, w, b, d, kw: ((zx, w, b, d.double()),
                                                        kw),
    "conv taps": lambda zx, w, b, d, kw: ((zx, w[:3], b, d), kw),
    "must be even": lambda zx, w, b, d, kw: ((zx, w, b, torch.zeros(5)),
                                             kw | {"state": 15}),
    "xbc offset": lambda zx, w, b, d, kw: (
        (zx, w, b, d), kw | {"xbc_at": zx.shape[-1] - w.shape[1] + 1}),
    "dt offset": lambda zx, w, b, d, kw: (
        (zx, w, b, d), kw | {"dt_at": zx.shape[-1] - d.shape[0] + 1}),
    "stride 1": lambda zx, w, b, d, kw: (
        (zx.transpose(1, 2).contiguous().transpose(1, 2), w, b, d), kw),
    "aligned to a pair": lambda zx, w, b, d, kw: ((zx, _misaligned(w), b, d),
                                                  kw),
    "address is not": lambda zx, w, b, d, kw: ((_misaligned(zx), w, b, d), kw),
    "batch stride is not": lambda zx, w, b, d, kw: ((_odd_stride(zx, 0), w, b,
                                                    d), kw),
    "row stride is not": lambda zx, w, b, d, kw: ((_odd_stride(zx, 1), w, b,
                                                  d), kw),
    "xbc offset is not": lambda zx, w, b, d, kw: (
        (zx, w, b, d), kw | {"xbc_at": kw["xbc_at"] + 1}),
    "CUDA": lambda zx, w, b, d, kw: ((zx, w, b, d), kw),
}


@pytest.mark.parametrize("match", list(FRONT_REFUSED))
def test_mamba_front_binding_refuses_what_it_does_not_take(match):
    """The binding raises before the device on what the kernel does not
    take (the last case: valid inputs, but on the CPU)."""
    cfg, p, zx = _front_case("mamba2-130m", 2, 9, torch.bfloat16, "float32")
    args, kw = FRONT_REFUSED[match](zx, p["conv_w"], p["conv_b"],
                                    p["dt_bias"], _front_kw(cfg))
    before = front_mod.launches
    with pytest.raises(ValueError, match=match):
        front_mod.mamba_front(*args, **kw)
    assert front_mod.launches == before


def test_mamba_front_kernel_is_no_roofline_readers_kernel():
    """The benchmark's roofline readers sum device time by kernel names
    (whole words): the front's kernel must be none of them, or it would
    count as the SSD's, flash's or gmm's."""
    root = Path(__file__).resolve().parents[1]
    src = (root / "src" / "repro_torch" / "kernels" / "csrc" /
           "mamba_front.cu").read_text()
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert names == ["mamba_front_kernel"]
    for reader in ("ssd_roofline", "flash_roofline", "gmm_roofline"):
        spec = importlib.util.spec_from_file_location(
            reader, root / "rtmmbench" / "metrics" / f"{reader}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        words = re.compile(r"\b(" + "|".join(map(re.escape, mod.KERNELS))
                           + r")\b")
        assert not any(words.search(n) for n in names), (reader, names)


# ---------------------------------------------------------------------------
# wrappers, counters and the build
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    fa.launches = ssd_mod.launches = 0
    by_kernel = dict(fa.kernel_launches)
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(1), 1, 16, 2, 1, 16))
    ops.flash_attention(q, k, v)
    ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    ops.ssd(*[torch.from_numpy(a) for a in
              _ssd_inputs(np.random.default_rng(1), 1, 16, 2, 8, 16)], chunk=8)
    assert (fa.launches, ssd_mod.launches) == (0, 0)
    assert fa.kernel_launches == by_kernel


@pytest.mark.parametrize("h", fa.HEAD_DIMS)
def test_flash_kernel_for_names_the_kernel_of_each_dtype(h):
    assert h in fa.WGMMA_HEAD_DIMS
    assert fa.kernel_for(torch.bfloat16, h) == "wgmma"
    assert fa.kernel_for(torch.float32, h) == "fp32"


@pytest.mark.parametrize("dtype, h", [(torch.float16, 64),
                                      (torch.bfloat16, 24),
                                      (torch.float32, 512)])
def test_flash_kernel_for_refuses_what_no_kernel_takes(dtype, h):
    with pytest.raises(ValueError, match="no flash kernel"):
        fa.kernel_for(dtype, h)


def test_kernel_bindings_refuse_cpu_tensors():
    before = (fa.launches, ssd_mod.launches)
    q = torch.zeros((1, 16, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    tx = [torch.from_numpy(a) for a in
          _ssd_inputs(np.random.default_rng(1), 1, 16, 2, 8, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_mod.ssd(*tx, chunk=8)
    assert (fa.launches, ssd_mod.launches) == before


@pytest.mark.parametrize("t, kernel", [(1, "wgmma_splitk"), (2, "wgmma_splitk"),
                                       (64, "wgmma_splitk"), (65, "wgmma"),
                                       (8192, "wgmma")])
def test_gmm_kernel_for_names_the_kernel_of_each_dtype_and_size(t, kernel):
    assert gmm_mod.kernel_for(torch.bfloat16, t) == kernel
    assert gmm_mod.kernel_for(torch.float32, t) == "fp32"


def test_gmm_kernel_for_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="no gmm kernel"):
        gmm_mod.kernel_for(torch.float16, 8)


@pytest.mark.parametrize("t, d, f", [(1, 64, 8), (2, 4096, 6400),
                                     (2, 6400, 4096), (8, 4096, 1536),
                                     (8, 1536, 4096), (64, 4096, 1536),
                                     (64, 8, 8), (3, 72, 520), (1, 8192, 256)])
def test_gmm_splits_of_d_leave_no_split_empty(t, d, f):
    """The CUDA side takes ceil(steps / splits) steps a split and refuses a
    count that leaves the last split empty; a split keeps 4 steps of 64."""
    splits = gmm_mod.splits_for(t, d, f)
    steps = -(-d // 64)
    per = -(-steps // splits)
    assert splits >= 1 and -(-steps // per) == splits
    assert splits == 1 or per >= 4


def test_gmm_splits_of_d_only_at_decode_sizes():
    # phi3.5-moe's wi at 2 rows: 2 x 25 column tiles of 64 steps; 6 splits
    # of 11 steps give 300 blocks, two waves or more on 132 SMs
    assert gmm_mod.splits_for(2, 4096, 6400) == 6
    assert gmm_mod.splits_for(gmm_mod.SPLIT_MAX_ROWS + 1, 4096, 6400) == 1


def test_gmm_binding_refuses_what_it_does_not_take_before_the_device():
    x = torch.zeros((16, 8), dtype=torch.bfloat16)
    w = torch.zeros((2, 8, 16), dtype=torch.bfloat16)
    sizes = torch.tensor([10, 6], dtype=torch.int32)
    before = (gmm_mod.launches, dict(gmm_mod.kernel_launches))
    refused = [
        ("need", (x[None], w, sizes)),
        ("match", (x, w[:, :4], sizes)),
        ("match", (x, w, sizes[:1])),
        ("dtypes", (x.float(), w, sizes)),
        ("dtypes", (x.half(), w.half(), sizes)),
        ("multiples of 8", (x[:, :6], w[:, :6], sizes)),
        ("contiguous", (x, w.transpose(1, 2).contiguous().transpose(1, 2),
                        sizes)),
        ("int32", (x, w, sizes.float())),
        ("CUDA", (x, w, sizes)),
        ("CUDA", (torch.zeros((80, 8), dtype=torch.bfloat16), w,
                  torch.tensor([40, 40]))),
    ]
    for match, args in refused:
        with pytest.raises(ValueError, match=match):
            gmm_mod.gmm(*args)
    assert (gmm_mod.launches, gmm_mod.kernel_launches) == before


def test_ssd_binding_refuses_what_it_does_not_take_before_the_device():
    x, dt, A, B, C, D = (torch.from_numpy(a) for a in
                         _ssd_inputs(np.random.default_rng(1), 1, 16, 2, 8, 16))
    before = ssd_mod.launches
    refused = [
        ("dtype", (x.half(), dt, A, B, C, D), 8),
        ("float32", (x, dt.double(), A, B, C, D), 8),
        ("shape", (x, dt, A, B[:, :8], C, D), 8),
        ("multiple of chunk", (x, dt, A, B, C, D), 5),
        ("CUDA", (x, dt, A, B, C, D), 8),
    ]
    for match, args, chunk in refused:
        with pytest.raises(ValueError, match=match):
            ssd_mod.ssd(*args, chunk=chunk)
    assert ssd_mod.launches == before


def test_ssd_binding_pads_chunks_exactly():
    """The CUDA binding pads a chunk to a multiple of 8 positions (dt = 0 at
    the end of each chunk), N to 4 and P to 8 (zero columns): the chunked
    scan on the padded inputs gives the same outputs and final state."""
    b, s, h, p, n, ch = 2, 30, 3, 6, 5, 10
    x, dt, A, B, C, D = (torch.from_numpy(a) for a in
                         _ssd_inputs(np.random.default_rng(5), b, s, h, p, n))
    nc, lp, np_, pp = s // ch, 16, 8, 8
    pad = ssd_mod._pad_chunks
    y, fin = ref.ssd_chunked(pad(x, nc, ch, lp, (h, pp)),
                             pad(dt, nc, ch, lp, (h,)), A,
                             pad(B, nc, ch, lp, (np_,)),
                             pad(C, nc, ch, lp, (np_,)), D, chunk=lp)
    y = y.reshape(b, nc, lp, h, pp)[:, :, :ch, :, :p].reshape(b, s, h, p)
    want_y, want_fin = ref.ssd_chunked(x, dt, A, B, C, D, chunk=ch)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(fin[:, :, :n, :p].numpy(), want_fin.numpy(),
                               atol=3e-5, rtol=3e-5)


def test_build_failure_raises(tmp_path, monkeypatch):
    """nvcc failing on a source raises, naming the source; nothing is
    loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cu").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="broken.cu"):
        build._compile(build.library_path())
    assert not build.library_path().exists()


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build.library_path()
    (csrc / "a.cu").write_text("// two\n")
    assert build.library_path() != first


def test_flops_count_only_the_unmasked_pairs():
    # 4 queries, causal: 1 + 2 + 3 + 4 pairs; window 2: 1 + 2 + 2 + 2
    assert fa.flops(1, 4, 4, 1, 1, causal=True) == 4 * 10
    assert fa.flops(1, 4, 4, 1, 1, causal=True, window=2) == 4 * 7
    assert fa.flops(1, 4, 4, 1, 1, causal=False) == 4 * 16
