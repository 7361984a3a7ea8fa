"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips with "no CUDA" on a machine
without a GPU. The file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed (the repository's conftest imports JAX):

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
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
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
]

SSD_CASES = [
    # (b, s, h, p, n, chunk)
    (1, 32, 2, 8, 16, 8),
    (2, 48, 3, 8, 16, 16),
    (1, 100, 2, 16, 32, 32),
    (2, 64, 4, 32, 64, 64),
    (1, 512, 4, 64, 128, 256),              # mamba2-130m's head and state
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
    from repro_torch.launch.serve import build_handle
    h_att = build_handle("gemma2-2b", "ctx", layers=2)
    h_ssm = build_handle("mamba2-130m", "kws", layers=2)
    fa.launches = ssd_mod.launches = 0
    for h in (h_att, h_ssm):
        out = h.fn(h.params, torch.zeros((1, 16), dtype=torch.int32,
                                         device=cuda))
        assert torch.isfinite(out).all()
    assert (fa.launches, ssd_mod.launches) == (2, 2)
