"""The port's CUDA kernels against their plain PyTorch versions, on a card.
Imports neither jax nor the JAX package, so it also runs where jax is not
installed: ``python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py``.
Without a CUDA device every test skips. Grade: bitwise (integer weights,
exact in f32)."""

import numpy as np
import pytest
import torch

from flake16_framework_tpu_torch.kernels import hist


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
