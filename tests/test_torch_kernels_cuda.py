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


def _bucket(r, cap, n_feat, seed):
    """A packed bucket on the card: unique fids per row, u in [0, cap]."""
    rs = np.random.RandomState(seed)
    fid = np.stack([rs.permutation(n_feat)[:cap] for _ in range(r)])
    u = rs.randint(0, cap + 1, size=r)
    z = rs.uniform(0.05, 1.0, size=(r, cap))
    thr = np.sort(rs.randn(r, cap, 2), -1)
    lo = np.where(rs.rand(r, cap) < 0.4, -3.4e38, thr[..., 0])
    hi = np.where(rs.rand(r, cap) < 0.4, 3.4e38, thr[..., 1])
    arrays = (fid.astype(np.int32), z.astype(np.float32),
              lo.astype(np.float32), hi.astype(np.float32),
              u.astype(np.int32), rs.rand(r).astype(np.float32))
    return [torch.from_numpy(a).cuda() for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n_feat,r,s", [
    (1, 16, 40, 300),
    (2, 16, 2500, 128),
    (4, 16, 1500, 333),
    (7, 7, 2100, 129),
    (8, 16, 1024, 500),
    (16, 16, 1100, 257),
    (16, 16, 40000, 512),  # chunk 152 on 132 SMs: many stages, ragged ends
])
def test_treeshap_unit_vs_plain(cap, n_feat, r, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    args = _bucket(r, cap, n_feat, seed=cap)
    x = torch.from_numpy(np.random.RandomState(r).randn(s, n_feat)
                         .astype(np.float32)).cuda()
    before = treeshap_unit.unit_shap.launches
    got = treeshap_unit.unit_shap(*args, x)
    again = treeshap_unit.unit_shap(*args, x)
    want = treeshap_unit.unit_shap_plain(*args, x)
    torch.cuda.synchronize()
    assert treeshap_unit.unit_shap.launches == before + 2
    assert got.shape == (n_feat, s)
    assert torch.equal(got, again)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()) + 1e-7, err


@pytest.mark.cuda
def test_treeshap_unit_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    args = _bucket(8, 4, 16, seed=0)
    x = torch.zeros((10, 16), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        treeshap_unit.unit_shap(*args[:4], args[4].long(), args[5], x)
    wide = _bucket(8, 17, 20, seed=0)
    with pytest.raises(ValueError, match="cap must be"):
        treeshap_unit.unit_shap(*wide, torch.zeros((10, 20), device="cuda"))
