"""The port's CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and skip without one. They import torch
only, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: the kernel and the plain version do the same f32 arithmetic (the
int8 products are exact integers in both), so candidate scores agree to
1e-5 relative and ids are equal except among tied scores."""

import numpy as np
import pytest
import torch

from jsa_rag_tpu_torch.ops import mips_topt as tp2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _assert_same_candidates(ks, ki, ps, pi):
    ks, ki, ps, pi = (x.cpu().numpy() for x in (ks, ki, ps, pi))
    np.testing.assert_allclose(ks, ps, rtol=1e-5, atol=0)
    # a differing id is allowed only where its score ties another
    # candidate of the same (tile, row) list
    for nt, r, p in np.argwhere(ki != pi):
        assert np.isclose(ks[nt, r], ks[nt, r, p], rtol=1e-5,
                          atol=0).sum() > 1, (nt, r, p)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,nv,d,k_sel,tile", [
    (64, 8192, 8000, 1024, 400, 256),
    (5, 4099, 3000, 1024, 4096, 256),
    (40, 1000, 1000, 256, 64, 128),
    (33, 777, 700, 80, 50, 128),  # d not a multiple of the 128-byte stage
])
def test_kernel_matches_plain(cuda, b, n, nv, d, k_sel, tile):
    g = torch.Generator(device=cuda).manual_seed(b + n)
    v1, s1, _, _ = tp2.quantize_int8_residual(
        torch.randn((n, d), generator=g, device=cuda))
    qv1, qs1, qv2, qs2 = tp2.quantize_int8_residual(
        torch.randn((b, d), generator=g, device=cuda))
    t = tp2._pool_t(k_sel, nv, tile, 4)
    args = (qv1, qs1, qv2, qs2, v1, s1.reshape(1, -1), nv, tile, t)
    before = tp2.scan_topt_int8r2.launches
    ks, ki = tp2.scan_topt_int8r2(*args)
    ps, pi = tp2.scan_topt_int8r2_plain(*args)
    torch.cuda.synchronize()
    assert tp2.scan_topt_int8r2.launches == before + 1
    assert ks.shape == (-(-n // tile), b, t) and ki.dtype == torch.int32
    assert int(ki.max()) < nv
    _assert_same_candidates(ks, ki, ps, pi)


@pytest.mark.cuda
def test_kernel_grid_past_65535_index_tiles(cuda):
    """More index tiles than a grid's y dimension holds (65,535): the 1-D
    grid reaches them all, with two query tiles so the block index splits
    into both parts. A short d keeps the 8.4M-row plane at 134 MB."""
    tile, d, b = 128, 16, 40
    n = 65_536 * tile + 300
    nv = n - 5
    g = torch.Generator(device=cuda).manual_seed(11)
    v1, s1, _, _ = tp2.quantize_int8_residual(
        torch.randn((n, d), generator=g, device=cuda))
    qv1, qs1, qv2, qs2 = tp2.quantize_int8_residual(
        torch.randn((b, d), generator=g, device=cuda))
    t = tp2._pool_t(400, nv, tile, 4)
    args = (qv1, qs1, qv2, qs2, v1, s1.reshape(1, -1), nv, tile, t)
    ks, ki = tp2.scan_topt_int8r2(*args)
    ps, pi = tp2.scan_topt_int8r2_plain(*args)
    torch.cuda.synchronize()
    assert ks.shape == (-(-n // tile), b, t)
    assert int(ki[65_535:].min()) >= 65_535 * tile
    assert int(ki.max()) < nv
    _assert_same_candidates(ks, ki, ps, pi)


@pytest.mark.cuda
def test_search_on_card_matches_cpu(cuda):
    """The whole scan-merge-refine on the card returns what the CPU path
    (plain scan) returns for the same planes."""
    g = torch.Generator().manual_seed(3)
    n, d, b, k = 5000, 512, 9, 50
    e = torch.randn((n, d), generator=g)
    v1, s1, v2, s2 = tp2.quantize_int8_residual(e)
    q = e[:b] + 0.05 * torch.randn((b, d), generator=g)
    planes = (v1, s1.reshape(1, -1), v2, s2.reshape(1, -1))
    cs, ci = tp2.mips_topk_int8r_t(q, planes[0], planes[1], k,
                                   res_rows=planes[2], res_scale=planes[3],
                                   valid_n=4900)
    gs, gi = tp2.mips_topk_int8r_t(
        q.to(cuda), *(p.to(cuda) for p in planes[:2]), k,
        res_rows=planes[2].to(cuda), res_scale=planes[3].to(cuda),
        valid_n=4900)
    np.testing.assert_allclose(gs.cpu().numpy(), cs.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (gi[:, 0].cpu() == torch.arange(b)).all()
    assert int(gi.max()) < 4900
