"""The yardstick's work models and peaks, frozen here so that a change to
the program cannot move them: copies of the port's ``kernels/hist.py::
work`` (K1) and ``kernels/treeshap_unit.py::unit_ops``/``one_counts``
(K2), and the published peaks of one NVIDIA H100 SXM (data sheet, dense,
at its 700 W limit)."""

import torch

PEAK_F32_FLOPS = 67e12       # f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12     # HBM3
PLAIN_ROWS = 1024


def k1_bytes(n_tree, n, n_feat, bin_elems, n_nodes, n_bins):
    """Bytes one K1 launch has to move: each input read once ([T, N]
    int32 rel, f32 w and wy, the uint8 bins) and both [T, F, W, B] f32
    outputs written once."""
    out_elems = n_tree * n_feat * n_nodes * n_bins
    return float(n_tree * n * 12 + bin_elems + 2 * out_elems * 4)


def k1_seconds(n_tree, n, n_feat, bin_elems, n_nodes, n_bins):
    """The least time of one K1 launch. The byte bound always binds: the
    flops (two adds an in-window sample and feature, two an output
    element) take at most 0.14 of it at these peaks, so the in-window
    count, a host read, is not needed."""
    return k1_bytes(n_tree, n, n_feat, bin_elems, n_nodes, n_bins) \
        / PEAK_HBM_BYTES


def one_counts(fid, lo, hi, u, xs):
    """[R, D] int64: for each work item and each sample block x [S_d, F]
    of ``xs``, the (live slot, sample) pairs with o = 1, in row batches
    over all the blocks' samples at once."""
    x = torch.cat(xs)
    bounds = torch.tensor([0] + [len(b) for b in xs],
                          device=x.device).cumsum(0)
    cap = fid.shape[1]
    slots = torch.arange(cap, device=x.device)
    out = []
    for a in range(0, fid.shape[0], PLAIN_ROWS):
        b = slice(a, a + PLAIN_ROWS)
        x_sel = x.T[fid[b].long()]                      # [r, cap, S_total]
        o = (x_sel > lo[b, :, None]) & (x_sel <= hi[b, :, None])
        live = (slots < u[b, None])[..., None]
        per = torch.nn.functional.pad((o & live).sum(1).cumsum(1), (1, 0))
        out.append(per[:, bounds[1:]] - per[:, bounds[:-1]])
    return torch.cat(out)


def unit_ops(u, n1, n_samples):
    """f32 flops (FMA = 2) of K2's division-free formulation for work
    items of live counts u [R] against ``n_samples`` samples, n1 [R] the
    o = 1 pairs of each: u^2 + 7u + 1 + 4u n1 a (work item, sample), the
    sample-independent coefficients left out."""
    u, n1 = u.double(), n1.double()
    return float((u * u + 7.0 * u + 1.0).sum() * n_samples
                 + (4.0 * u * n1).sum())


def k2_seconds(rows, xs):
    """The least time of each K2 launch on the unit rows (fid, z, lo, hi,
    u, scale) and each sample block x [S, F] of ``xs``: the larger of its
    operations over the f32 peak and its bytes (each input read once,
    phi [F, S] written once) over the HBM peak. Bytes bind at a few
    samples, operations at tens. One value a block."""
    fid, z, lo, hi, u, scale = rows
    n1 = one_counts(fid, lo, hi, u, xs)
    rows_bytes = sum(a.numel() * 4 for a in rows)
    out = []
    for d, x in enumerate(xs):
        ops = unit_ops(u, n1[:, d], x.shape[0])
        nbytes = float(rows_bytes + 2 * x.numel() * 4)
        out.append(max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES))
    return out
