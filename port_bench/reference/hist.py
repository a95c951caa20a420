"""The cumulative class histograms of one BFS step (K1's math), as one
scatter-add and a cumsum: for tree t, feature f, window node w, bin b,
cw[t, f, w, b] is the sum of w[t, n] over the in-window samples of node w
whose bin of f is at most b, cwy the same with wy. The weights are whole
numbers whose node sums stay below 2^24, so every f32 sum is exact in any
order and the result equals the kernel's bit for bit."""

import torch


def cum_hists(rel, w, wy, bin_t, n_nodes, n_bins):
    """(cw, cwy) [T, F, W, B] f32 from rel [T, N] int32, w and wy [T, N]
    f32 and bin_t [F, N] uint8."""
    n_feat = bin_t.shape[0]
    n_tree = rel.shape[0]
    rel = rel.to(torch.int64)
    inw = (rel >= 0) & (rel < n_nodes)
    b = bin_t.to(torch.int64)[None]                           # [1, F, N]
    cell = ((torch.arange(n_tree, device=rel.device)[:, None, None]
             * n_feat + torch.arange(n_feat, device=rel.device)[:, None])
            * n_nodes + rel.clamp(0, n_nodes - 1)[:, None, :]) * n_bins + b
    size = n_tree * n_feat * n_nodes * n_bins
    out = []
    for weights in (w, wy):
        vals = torch.where(inw, weights, 0.0)[:, None, :].expand(
            -1, n_feat, -1)
        h = torch.zeros(size, dtype=torch.float32, device=rel.device)
        h.index_add_(0, cell.reshape(-1), vals.reshape(-1))
        out.append(torch.cumsum(h.view(n_tree, n_feat, n_nodes, n_bins),
                                -1))
    return out[0], out[1]
