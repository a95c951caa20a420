"""The frozen work models against hand counts."""

import torch

from port_bench.harness import work


def test_k1_bytes_read_each_input_once_and_write_each_output_once():
    # T = 2 trees, N = 8 samples, F = 3 features (one group), W = 4
    # nodes, B = 5 bins: rel, w, wy are 2 x 8 x 4 bytes each = 192; bins
    # 3 x 8 = 24; two outputs of 2 * 3 * 4 * 5 f32 = 960.
    assert work.k1_bytes(2, 8, 3, 24, 4, 5) == 192 + 24 + 960
    assert work.k1_seconds(2, 8, 3, 24, 4, 5) == \
        (192 + 24 + 960) / work.PEAK_HBM_BYTES


def test_k2_ops_count_the_one_fractions_of_each_block():
    # Two work items of cap 2: item 0 has u = 2 live slots on features 0
    # and 1, item 1 has u = 1 on feature 1. Slot o = 1 iff lo < x <= hi.
    fid = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    lo = torch.tensor([[0.0, 0.0], [-1.0, -1.0]])
    hi = torch.tensor([[1.0, 1.0], [0.5, 0.5]])
    u = torch.tensor([2, 1], dtype=torch.int32)
    a = torch.tensor([[0.5, 2.0]])                 # item 0: 1, item 1: 0
    b = torch.tensor([[0.5, 0.5], [3.0, 0.2]])     # item 0: 3, item 1: 2
    n1 = work.one_counts(fid, lo, hi, u, [a, b])
    assert n1.tolist() == [[1, 3], [0, 2]]
    # u^2 + 7u + 1 a (item, sample) and 4 u n1: block a (S = 1):
    # (4 + 14 + 1) + (1 + 7 + 1) + 4 * 2 * 1 = 36.
    assert work.unit_ops(u, n1[:, 0], 1) == 36.0
    # block b (S = 2): 28 * 2 + 4 * 2 * 3 + 4 * 1 * 2 = 88.
    assert work.unit_ops(u, n1[:, 1], 2) == 88.0
    z = torch.ones(2, 2)
    scale = torch.ones(2)
    rows = (fid, z, lo, hi, u, scale)
    got = work.k2_seconds(rows, [a, b])
    rows_bytes = 4 * (4 * 4 + 2 + 2)
    assert got[0] == max(36.0 / work.PEAK_F32_FLOPS,
                         (rows_bytes + 2 * 2 * 4) / work.PEAK_HBM_BYTES)
    assert got[1] == max(88.0 / work.PEAK_F32_FLOPS,
                         (rows_bytes + 2 * 4 * 4) / work.PEAK_HBM_BYTES)
