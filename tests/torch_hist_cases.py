"""Inputs of the histogram step (``kernels/hist.py``) shared by its CPU
test (tests/test_torch_hist.py) and its card test
(tests/test_torch_kernels_cuda.py). Imports neither jax nor the JAX
package."""

import numpy as np


def hist_inputs(seed, n_tree=3, n=600, n_feat=5, n_nodes=4, n_bins=16,
                mode=None):
    """``mode``: "one_row" puts every sample in row 0, "empty" every
    sample outside the window, "zero_w" makes every weight zero, "halves"
    makes the weights halves of whole numbers (exact in f32 in any order,
    but not whole), "heavy" scales them by 9 so that a tree's weights in
    the window pass 2^16."""
    rs = np.random.RandomState(seed)
    rel = rs.randint(-1, n_nodes + 2, size=(n_tree, n)).astype(np.int32)
    w = rs.randint(0, 6, size=(n_tree, n)).astype(np.float32)
    if mode == "one_row":
        rel[:] = 0
    elif mode == "empty":
        rel = np.where(rs.rand(n_tree, n) < 0.5, -1 - np.abs(rel),
                       n_nodes + np.abs(rel)).astype(np.int32)
    elif mode == "zero_w":
        w[:] = 0.0
    elif mode == "halves":
        w *= 0.5
    elif mode == "heavy":
        w *= 9.0
    wy = w * (rs.rand(n) < 0.4)
    bins = rs.randint(0, n_bins, size=(n_feat, n)).astype(np.uint8)
    return rel, w, wy.astype(np.float32), bins, n_nodes, n_bins


# Edge cases of the kernel's geometry and data, as hist_inputs keyword
# arguments.
EDGE_CASES = {
    "W1": dict(seed=2, n_nodes=1),
    "B2": dict(seed=3, n_bins=2),
    "B256": dict(seed=4, n_bins=256, n=1000),
    "one_row": dict(seed=5, mode="one_row"),
    "empty_window": dict(seed=6, mode="empty"),
    "zero_weights": dict(seed=7, mode="zero_w"),
    "half_weights": dict(seed=10, mode="halves"),
    "heavy_weights": dict(seed=11, n=8000, mode="heavy"),
    "n603": dict(seed=8, n=603),            # not a multiple of 4 or 16
    "F7": dict(seed=9, n_feat=7),
}
