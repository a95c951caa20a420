"""The port's CUDA kernels against their plain PyTorch versions, on a card.
Imports neither jax nor the JAX package, so it also runs where jax is not
installed: ``python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py``.
Without a CUDA device every test skips. Grades: K1 bitwise (integer
weights, exact in f32); K2 within 1e-5 * max|plain| + 1e-7 and bitwise
across two runs."""

import numpy as np
import pytest
import torch

from flake16_framework_tpu_torch.kernels import hist, treeshap_unit


@pytest.mark.cuda
@pytest.mark.parametrize("n_tree,n,n_feat,n_nodes,n_bins", [
    (3, 600, 5, 4, 16),
    (7, 3000, 16, 128, 64),
    (2, 8000, 7, 128, 64),
])
def test_hist_cumsum_bitwise_vs_plain(n_tree, n, n_feat, n_nodes, n_bins):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rs = np.random.RandomState(n)
    rel = rs.randint(-1, n_nodes + 2, size=(n_tree, n)).astype(np.int32)
    w = rs.randint(0, 6, size=(n_tree, n)).astype(np.float32)
    wy = (w * (rs.rand(n) < 0.4)).astype(np.float32)
    bins = rs.randint(0, n_bins, size=(n_feat, n)).astype(np.uint8)
    args = [torch.from_numpy(a).cuda() for a in (rel, w, wy, bins)]
    before = hist.cum_hists.launches
    got = hist.cum_hists(*args, n_nodes, n_bins)
    want = hist.cum_hists_plain(*args, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert hist.cum_hists.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_hist_cumsum_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rel = torch.zeros((2, 10), dtype=torch.int32, device="cuda")
    w = torch.ones((2, 10), device="cuda")
    bins = torch.zeros((3, 10), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        hist.cum_hists(rel, w.double(), w, bins, 4, 16)
    with pytest.raises(ValueError, match="shared memory"):
        hist.cum_hists(rel, w, w, bins, 1024, 64)


def _bucket(r, cap, n_feat, seed, mode=None, s=0):
    """A packed bucket on the card and its samples x [s, n_feat]: unique
    fids per row, u in [0, cap]. ``mode``: "sorted" rows by u (as
    ``bucket_inputs`` hands them over), "u1" every u = 1, "z0" some zero
    fractions 0, "all_o0" empty intervals, "all_o1" unbounded ones,
    "on_edges" samples exactly on interval ends."""
    rs = np.random.RandomState(seed)
    fid = np.stack([rs.permutation(n_feat)[:cap] for _ in range(r)])
    u = rs.randint(0, cap + 1, size=r)
    z = rs.uniform(0.05, 1.0, size=(r, cap))
    thr = np.sort(rs.randn(r, cap, 2), -1)
    lo = np.where(rs.rand(r, cap) < 0.4, -3.4e38, thr[..., 0])
    hi = np.where(rs.rand(r, cap) < 0.4, 3.4e38, thr[..., 1])
    x = np.random.RandomState(r).randn(s, n_feat)
    if mode == "sorted":
        u = np.sort(u)
    elif mode == "u1":
        u[:] = 1
    elif mode == "z0":
        z[rs.rand(r, cap) < 0.3] = 0.0
    elif mode == "all_o0":
        lo = hi = thr[..., 0]
    elif mode == "all_o1":
        lo, hi = np.full_like(lo, -3.4e38), np.full_like(hi, 3.4e38)
    elif mode == "on_edges":
        for i in range(s):
            row, k = rs.randint(r), rs.randint(cap)
            edge = (lo if i % 2 else hi)[row, k]
            if abs(edge) < 3.4e38:
                x[i, fid[row, k]] = edge
    arrays = (fid.astype(np.int32), z.astype(np.float32),
              lo.astype(np.float32), hi.astype(np.float32),
              u.astype(np.int32), rs.rand(r).astype(np.float32),
              x.astype(np.float32))
    return [torch.from_numpy(a).cuda() for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n_feat,r,s,mode", [
    (1, 16, 40, 300, None),
    (2, 16, 2500, 128, None),
    (4, 16, 1500, 333, None),
    (7, 7, 2100, 129, None),
    (8, 16, 1024, 500, None),
    (16, 16, 1100, 257, None),
    (16, 16, 40000, 512, None),  # chunk 128: many stages, ragged last chunk
    (8, 16, 300, 128, "sorted"),    # u changes inside stages and chunks
    (16, 16, 100, 128, "sorted"),   # chunk 32 over 17 u values: 5-6 a chunk
    # chunk 128: 157 chunks, about 16 of them span a u boundary
    (16, 16, 20000, 4000, "sorted"),
    (16, 16, 512, 200, "u1"),
    (16, 16, 512, 200, "z0"),
    (16, 16, 512, 200, "all_o0"),
    (16, 16, 512, 200, "all_o1"),
    (16, 16, 512, 200, "on_edges"),
])
def test_treeshap_unit_vs_plain(cap, n_feat, r, s, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    *args, x = _bucket(r, cap, n_feat, seed=cap, mode=mode, s=s)
    before = treeshap_unit.unit_shap.launches
    got = treeshap_unit.unit_shap(*args, x)
    again = treeshap_unit.unit_shap(*args, x)
    want = treeshap_unit.unit_shap_plain(*args, x)
    torch.cuda.synchronize()
    assert treeshap_unit.unit_shap.launches == before + 2
    assert got.shape == (n_feat, s)
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()) + 1e-7, err


@pytest.mark.cuda
def test_treeshap_unit_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    args = _bucket(8, 4, 16, seed=0)[:6]
    x = torch.zeros((10, 16), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        treeshap_unit.unit_shap(*args[:4], args[4].long(), args[5], x)
    wide = _bucket(8, 17, 20, seed=0)[:6]
    with pytest.raises(ValueError, match="cap must be"):
        treeshap_unit.unit_shap(*wide, torch.zeros((10, 20), device="cuda"))
