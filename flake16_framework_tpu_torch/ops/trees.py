"""Tree ensembles: the histogram grower for Random Forest and Extra Trees,
the exact sort-based grower for the single Decision Tree, and predict.

A tree is a fixed-capacity structure of arrays (``Forest``, ``max_nodes``
slots). Features are quantile-binned once; each BFS step takes the window
of node ids [p, p+W) of every tree in the batch, builds the cumulative
per-node class histograms in one kernel launch (``kernels.hist.cum_hists``)
and scores every bin boundary from them; every right-side statistic is the
subtraction ``total - left``. Node ids are allocated contiguously in
creation order, so the work queue is a pointer pair per tree (p = next
unprocessed id, a = next free id).

The JAX package's ``vmap`` over trees is an explicit tree-batch axis
[T, ...] here, and its ``lax.while_loop`` a host loop that reads
``(p < a).any()`` once per step; a finished tree's step is a no-op because
nothing is present in its window. Each node's random draws come from the
key ``fold_in(tree_key, node_id)`` (``rng``, bit-compatible with
``jax.random``), so neither the node-batch width nor which trees share a
batch changes the forest, and the forest equals the JAX package's bit for
bit.

The exact grower (``fit_forest``, one tree after another) grows a tree a
level at a time: a stable sort by node id of each feature's value-sorted
samples puts every node's samples in one run in value order, and every
position between two distinct values of a run is a candidate split
(sklearn's ``splitter="best"``, midpoint thresholds). It has no kernel of
its own: sorts, scans, gathers and scatters over [F, N]. Its loop reads
the level's split count once a level. Which grower a config takes is
``hist_tier_default``'s rule alone.

Weights are small integers, so every histogram and prefix sum is exact in
f32 in any order. ``argmax`` takes the first maximum (the lowest boundary,
the lowest feature), as ``jnp.argmax`` does.
"""

from typing import NamedTuple

import torch

from flake16_framework_tpu_torch import rng
from flake16_framework_tpu_torch.constants import HIST_BINS
from flake16_framework_tpu_torch.kernels.hist import cum_hists

# Node-batch width of the BFS step per device type (results-neutral).
NODE_BATCH = {"cuda": 128, "cpu": 8}

# sklearn's FEATURE_THRESHOLD: two values closer than this are "equal" for
# the exact grower's split candidates.
FEATURE_EPS = 1e-7


class Forest(NamedTuple):
    """Structure-of-arrays ensemble; shapes [T, M] (+ [T, M, 2] value).

    ``feature`` is -1 at leaves; ``value`` holds the weighted class counts
    of every populated node. ``max_depth`` is the fit-time depth bound
    that predict's traversal length derives from."""

    feature: torch.Tensor      # int32
    threshold: torch.Tensor    # float32
    left: torch.Tensor         # int32
    right: torch.Tensor        # int32
    value: torch.Tensor        # float32
    n_nodes: torch.Tensor      # int32 [T]
    max_depth: int


def trim_nodes(forest, m):
    """Forest with the node axis cut to ``m`` slots. Safe whenever
    ``m >= max(n_nodes)``: slots past the used count are never referenced
    (child ids are < n_nodes). Shrinks the leaf-slot padding that Tree
    SHAP's per-(leaf, sample) work pays for."""
    return forest._replace(
        feature=forest.feature[..., :m], threshold=forest.threshold[..., :m],
        left=forest.left[..., :m], right=forest.right[..., :m],
        value=forest.value[..., :m, :])


def quantile_edges(x):
    """Inner bin edges [F, HIST_BINS-1]: midpoints between adjacent sorted
    values at quantile ranks. Bin b covers edges[b-1] < x <= edges[b]."""
    n = x.shape[0]
    # stable, as jnp.sort: -0.0 and 0.0 compare equal and keep their order
    xs = torch.sort(x, dim=0, stable=True).values
    ks = torch.clamp((torch.arange(1, HIST_BINS, device=x.device) * n)
                     // HIST_BINS - 1, 0, n - 1)
    lo = xs[ks]
    hi = xs[torch.clamp(ks + 1, 0, n - 1)]
    return ((lo + hi) * 0.5).T.contiguous()


def bin_indices(x, edges):
    """Bin index [N, F] int64: the count of edges strictly below x."""
    return (x[:, :, None] > edges[None, :, :]).sum(-1)


def hist_subtract(total, side):
    """Sibling statistic by subtraction (exact: integer counts in f32)."""
    return total - side


def _exclusive_cumsum(x, dim=-1):
    return torch.cumsum(x, dim) - x


def _fma(a, b, c):
    """a * b + c for f32 tensors with one rounding: the JAX package's
    ``c + a * b``, which XLA contracts into a fused multiply-add on the CPU.
    The product is exact in f64; the f64 sum, rounded to odd with its
    TwoSum error, then rounds to the correctly rounded f32."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, torch.inf)
    odd = torch.nextafter(s, torch.where(err > 0, inf, -inf))
    return torch.where(even & (err != 0), odd, s).to(torch.float32)


def _proxy_score(lw, lwy, rw, rwy, valid):
    """Weighted-gini proxy d_L^2/w_L + d_R^2/w_R with d = w0 - w1, equal to
    sklearn's up to a per-node constant; -inf where not ``valid``."""
    d_l = lw - 2.0 * lwy
    d_r = rw - 2.0 * rwy
    score = (d_l * d_l / torch.clamp(lw, min=1.0)
             + d_r * d_r / torch.clamp(rw, min=1.0))
    return torch.where(valid, score, torch.full_like(score, -torch.inf))


def _select_features(nc, u, max_features):
    """sklearn's per-node feature draw, "informative" quota: the
    ``max_features`` non-constant features with the smallest draws.
    nc [..., F] bool, u [..., F] uniforms. Returns sel [..., F] bool."""
    if max_features is None:
        return nc
    r = torch.where(nc, u, torch.full_like(u, torch.inf))
    kth = torch.sort(r, dim=-1).values[..., max_features - 1:max_features]
    return (r <= kth) & nc


def _window_update(arr, start, updates, mask):
    """Per tree, write ``updates`` [T, W(, C)] at [start, start+W) of
    ``arr`` [T, M(, C)] where ``mask`` [T, W] holds; in place."""
    idx = start[:, None] + torch.arange(updates.shape[1], device=arr.device)
    if arr.dim() == 3:
        idx = idx[..., None].expand(-1, -1, arr.shape[2])
        mask = mask[..., None]
    old = arr.gather(1, idx)
    arr.scatter_(1, idx, torch.where(mask, updates.to(arr.dtype), old))


def _emit_children(can_split, lw_b, lwy_b, tot_w_b, tot_wy_b):
    """Cover values of the 2k children created by a window's splits: child
    slot s belongs to the (s//2)-th splitting parent, found by inverting
    the monotone split rank with searchsorted. Returns (child_vals
    [T, 2W, 2], child_ok [T, 2W], j_safe [T, 2W] parent slot)."""
    t, w_cap = can_split.shape
    slots = torch.arange(2 * w_cap, device=can_split.device)
    csum = torch.cumsum(can_split.to(torch.int64), 1)
    j = torch.searchsorted(csum, (slots // 2 + 1).expand(t, -1).contiguous())
    j_safe = torch.clamp(j, max=w_cap - 1)
    is_right = (slots % 2) == 1
    lw_s = lw_b.gather(1, j_safe)
    lwy_s = lwy_b.gather(1, j_safe)
    cw_s = torch.where(is_right, tot_w_b.gather(1, j_safe) - lw_s, lw_s)
    cwy_s = torch.where(is_right, tot_wy_b.gather(1, j_safe) - lwy_s, lwy_s)
    child_ok = slots[None, :] < 2 * csum[:, -1:]
    return torch.stack([cw_s - cwy_s, cwy_s], -1), child_ok, j_safe


def _node_uniforms(kg, n_ids, n_feat, random_splits):
    """Per-node draws for node ids [0, n_ids) of each tree key kg [T, 2]:
    node key fold_in(kg, id) splits into (kf, kt); kf draws the feature
    order, kt the Extra Trees thresholds. Each [T, n_ids, F] f32."""
    ids = torch.arange(n_ids, device=kg.device)
    ksplit = rng.split(rng.fold_in(kg[:, None, :], ids[None, :]))
    u_feat = rng.uniform(ksplit[..., 0, :], (n_feat,))
    u_thr = rng.uniform(ksplit[..., 1, :], (n_feat,)) if random_splits \
        else None
    return u_feat, u_thr


def _grow_trees(x, bin_t, edges, y01, w, kg, *, random_splits, max_features,
                max_depth, max_nodes, node_batch):
    """Grow a batch of T trees on shared binned features; per-tree weights
    w [T, N] and grower keys kg [T, 2]. Returns the Forest field tensors
    (feature, threshold, left, right, value, n_nodes), node axis cut to
    ``max_nodes``."""
    dev = x.device
    n_tree, n = w.shape
    n_feat, n_bins = edges.shape[0], edges.shape[1] + 1
    bw = min(node_batch, max_nodes)
    m_pad = max_nodes + 2 * bw
    iota_w = torch.arange(bw, device=dev)
    iota_t = torch.arange(n_tree, device=dev)
    feat_ix = torch.arange(n_feat, device=dev)[None, :, None]
    xt = x.T.contiguous()                                    # [F, N]
    sample_ix = torch.arange(n, device=dev)[None, :]

    feature = torch.full((n_tree, m_pad), -1, dtype=torch.int32, device=dev)
    threshold = torch.zeros((n_tree, m_pad), dtype=x.dtype, device=dev)
    left = torch.full((n_tree, m_pad), -1, dtype=torch.int32, device=dev)
    right = torch.full((n_tree, m_pad), -1, dtype=torch.int32, device=dev)
    value = torch.zeros((n_tree, m_pad, 2), dtype=x.dtype, device=dev)
    depth = torch.zeros((n_tree, m_pad), dtype=torch.int64, device=dev)

    wy = w * y01[None, :]
    sample_node = torch.where(w > 0, 0, -1).to(torch.int64)  # [T, N]
    tot_w0, tot_wy0 = w.sum(1), wy.sum(1)
    value[:, 0, 0] = tot_w0 - tot_wy0
    value[:, 0, 1] = tot_wy0
    a = torch.ones(n_tree, dtype=torch.int64, device=dev)
    p = torch.zeros(n_tree, dtype=torch.int64, device=dev)
    u_feat, u_thr = _node_uniforms(kg, max_nodes + bw, n_feat, random_splits)

    if random_splits:
        # Node value span from the occupied bins' edge values; the end
        # bins extrapolate one neighbour width.
        first = edges[:, :1] - (edges[:, 1:2] - edges[:, :1])
        last = edges[:, -1:] + (edges[:, -1:] - edges[:, -2:-1])
        full_edges = torch.cat([first, edges, last], 1)      # [F, B+1]

    while bool((p < a).any()):                   # the one host sync a step
        ids = p[:, None] + iota_w                            # [T, W]
        rel = sample_node - p[:, None]                       # [T, N]
        inb = (rel >= 0) & (rel < bw)
        cw, cwy = cum_hists(rel.to(torch.int32), w, wy, bin_t, bw, n_bins)

        tot_w = cw[:, 0, :, -1]                              # [T, W]
        tot_wy = cwy[:, 0, :, -1]
        lw = cw[..., :-1]                                    # [T, F, W, B-1]
        lwy = cwy[..., :-1]
        rw = hist_subtract(tot_w[:, None, :, None], lw)
        rwy = hist_subtract(tot_wy[:, None, :, None], lwy)
        valid = (lw > 0) & (rw > 0)
        nc = valid.any(-1)                                   # [T, F, W]

        if random_splits:
            # Extra Trees: a threshold drawn uniformly in VALUE space over
            # the node's occupied bin span, rounded down to its bin's
            # lower boundary.
            prev = torch.cat([torch.zeros_like(cw[..., :1]), cw[..., :-1]],
                             -1)
            occ = (cw > prev).to(torch.uint8)                # [T, F, W, B]
            lo = torch.argmax(occ, -1)
            hi = n_bins - 1 - torch.argmax(torch.flip(occ, [-1]), -1)
            u = u_thr[iota_t[:, None], ids].permute(0, 2, 1)  # [T, F, W]
            vmin = full_edges[feat_ix, lo]
            vmax = full_edges[feat_ix, hi + 1]
            thr_v = _fma(u, vmax - vmin, vmin)
            cnt = (edges[None, :, None, :] < thr_v[..., None]).sum(-1)
            bsel = torch.minimum(torch.maximum(cnt, lo + 1), hi)
            bm1 = torch.clamp(bsel - 1, 0, n_bins - 2)
            lw_j = lw.gather(-1, bm1[..., None])[..., 0]
            lwy_j = lwy.gather(-1, bm1[..., None])[..., 0]
            rw_j = tot_w[:, None, :] - lw_j
            ok_j = nc & (lw_j > 0) & (rw_j > 0)
            score_j = _proxy_score(lw_j, lwy_j, rw_j,
                                   tot_wy[:, None, :] - lwy_j, ok_j)
            bound_j = bsel
            thr_j = edges[feat_ix, bm1]
        else:
            score = _proxy_score(lw, lwy, rw, rwy, valid)    # [T, F, W, B-1]
            bb = torch.argmax(score, -1)                     # lowest boundary
            score_j = score.gather(-1, bb[..., None])[..., 0]
            bound_j = bb + 1
            lw_j = lw.gather(-1, bb[..., None])[..., 0]
            lwy_j = lwy.gather(-1, bb[..., None])[..., 0]
            thr_j = edges[feat_ix, bb]

        # ---- feature choice (sklearn's random feature draw) --------------
        u_f = u_feat[iota_t[:, None], ids]                   # [T, W, F]
        sel = _select_features(nc.permute(0, 2, 1), u_f, max_features)
        score_j = torch.where(sel.permute(0, 2, 1), score_j,
                              torch.full_like(score_j, -torch.inf))
        best_f = torch.argmax(score_j, 1)                    # [T, W]
        best_score = score_j.gather(1, best_f[:, None])[:, 0]

        def pick_f(t):                                       # [T,F,W]->[T,W]
            return t.gather(1, best_f[:, None])[:, 0]

        thr_node = pick_f(thr_j)
        bound_n = pick_f(bound_j)
        lw_b = pick_f(lw_j)
        lwy_b = pick_f(lwy_j)

        # ---- split decision ---------------------------------------------
        present = iota_w[None, :] < (a - p)[:, None]
        dep = depth.gather(1, ids)
        impure = (tot_wy > 0) & (tot_w - tot_wy > 0)
        can_split = ((best_score > -torch.inf) & impure & present
                     & (dep < max_depth))
        rank = _exclusive_cumsum(can_split.to(torch.int64), 1)
        left_g = a[:, None] + 2 * rank
        right_g = left_g + 1
        can_split = can_split & (right_g < max_nodes)
        k_splits = can_split.sum(1)

        # ---- per-sample routing -----------------------------------------
        rs = torch.clamp(rel, 0, bw - 1)
        can_mine = inb & can_split.gather(1, rs)
        rank_mine = rank.gather(1, rs)
        bf_mine = best_f.gather(1, rs)                       # [T, N]
        go_left = bin_t[bf_mine, sample_ix] < bound_n.gather(1, rs)

        if not random_splits:
            # Sharpen each winner to the exact sklearn midpoint between
            # the closest member values either side of the chosen edge;
            # routing is unchanged, only the stored threshold moves.
            xv = xt[bf_mine, sample_ix]
            inf = torch.full_like(xv, torch.inf)
            m_l = torch.full((n_tree, bw), -torch.inf, dtype=x.dtype,
                             device=dev).scatter_reduce_(
                1, rs, torch.where(can_mine & go_left, xv, -inf), "amax")
            m_r = torch.full((n_tree, bw), torch.inf, dtype=x.dtype,
                             device=dev).scatter_reduce_(
                1, rs, torch.where(can_mine & ~go_left, xv, inf), "amin")
            mid = (m_l + m_r) * 0.5
            thr_ref = torch.where(mid >= m_r, m_l, mid)
            ok_ref = torch.isfinite(m_l) & torch.isfinite(m_r) & can_split
            thr_node = torch.where(ok_ref, thr_ref, thr_node)

        minus1 = torch.full_like(left_g, -1)
        _window_update(feature, p, torch.where(can_split, best_f, minus1),
                       can_split)
        _window_update(threshold, p, thr_node, can_split)
        _window_update(left, p, torch.where(can_split, left_g, minus1),
                       can_split)
        _window_update(right, p, torch.where(can_split, right_g, minus1),
                       can_split)

        # ---- child covers + depth, written at creation ------------------
        child_vals, child_ok, j_safe = _emit_children(
            can_split, lw_b, lwy_b, tot_w, tot_wy)
        _window_update(value, a, child_vals, child_ok)
        _window_update(depth, a, dep.gather(1, j_safe) + 1, child_ok)

        child_mine = (a[:, None] + 2 * rank_mine
                      + torch.where(go_left, 0, 1))
        sample_node = torch.where(
            inb & can_mine, child_mine,
            torch.where(inb, torch.full_like(sample_node, -1), sample_node))
        p = torch.minimum(p + bw, a)
        a = a + 2 * k_splits

    m = max_nodes
    return (feature[:, :m], threshold[:, :m], left[:, :m], right[:, :m],
            value[:, :m], a.to(torch.int32))


def bootstrap_weights(w, keys):
    """Per-tree multinomial bootstrap over rows with positive weight:
    round(sum(w)) inverse-CDF draws, one uniform per row. w [N], keys
    [T, 2] -> counts [T, N]."""
    n = w.shape[0]
    total = w.sum()
    cdf = torch.cumsum(w, 0) / torch.clamp(total, min=1.0)
    u = rng.uniform(keys, (n,))                              # [T, N]
    # right=True: a draw of exactly 0.0 must not pick a leading zero row.
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, n - 1)
    keep = (torch.arange(n, device=w.device)
            < torch.round(total).to(torch.int64)).to(w.dtype)
    return torch.zeros((keys.shape[0], n), dtype=w.dtype,
                       device=w.device).scatter_add_(
        1, idx, keep.expand(keys.shape[0], -1).contiguous())


def fit_forest_hist(x, y, w, key, *, n_trees, bootstrap, random_splits,
                    sqrt_features, max_depth=48, max_nodes=None, edges=None):
    """Fit a histogram-grown ensemble. x [N, F] f32; y [N] bool/int; w [N]
    >= 0 sample weights (0 = row excluded); ``key`` a threefry key [2].
    Returns a ``Forest`` with a [n_trees, ...] leading axis.

    RandomForest = bootstrap, not random_splits; ExtraTrees = random_splits,
    no bootstrap; both with sqrt_features. ``edges`` [F, HIST_BINS-1] may
    be given (once per config). The BFS window width is ``NODE_BATCH``
    for the device; it does not change the forest. All trees grow as one
    batch: the sweep
    fits one fold (100 trees) at a time, so the [T, F, W, B] x 2 step
    workspace stays near 105 MB at W = 128."""
    n, n_feat = x.shape
    if max_nodes is None:
        max_nodes = 2 * n
    max_features = max(1, int(n_feat ** 0.5)) if sqrt_features else None
    x = x.to(torch.float32)
    y01 = y.to(x.dtype)
    w = w.to(x.dtype)
    if edges is None:
        edges = quantile_edges(x)
    bin_t = bin_indices(x, edges).T.to(torch.uint8).contiguous()  # [F, N]

    kk = rng.split(rng.split(key, n_trees))
    kb, kg = kk[:, 0], kk[:, 1]
    wt = bootstrap_weights(w, kb) if bootstrap \
        else w.expand(n_trees, -1).contiguous()
    fields = _grow_trees(x, bin_t, edges, y01, wt, kg,
                         random_splits=random_splits,
                         max_features=max_features, max_depth=max_depth,
                         max_nodes=max_nodes,
                         node_batch=NODE_BATCH[x.device.type])
    return Forest(*fields, max_depth)


def hist_tier_default(n_trees):
    """Whether a config of ``n_trees`` trees grows on the histogram grower:
    an ensemble does; a single tree grows on the exact grower, since with
    no averaging over trees the bin-granular choice of candidates moved the
    single tree's F1 (the JAX package's parity record). The only switch
    between the two growers."""
    return n_trees > 1


def _run_boundaries(s_rel):
    """(is_start, is_end) [..., N] of each sorted position's run, a
    maximal stretch of equal node ids."""
    diff = s_rel[..., 1:] != s_rel[..., :-1]
    edge = torch.ones_like(s_rel[..., :1], dtype=torch.bool)
    return torch.cat([edge, diff], -1), torch.cat([diff, edge], -1)


def _prefix_stats(vals, is_start, is_end):
    """(within-run inclusive prefix sum, run total) of ``vals`` [..., N] >=
    0. Its cumsum c is nondecreasing, so c just before the latest run start
    and c at the nearest run end spread over the run as a cummax and a
    reversed cummin."""
    c = torch.cumsum(vals, -1)
    c_prev = torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], -1)
    inf = torch.full_like(c, torch.inf)
    before = torch.cummax(torch.where(is_start, c_prev, -inf), -1).values
    at_end = torch.flip(torch.cummin(
        torch.flip(torch.where(is_end, c, inf), [-1]), -1).values, [-1])
    return c - before, at_end - before


def _run_best(s_rel, score):
    """For each node id j of the sorted ids ``s_rel`` [F, N] (values in
    [0, N], N = parked): the best ``score`` of j's run and the lowest
    position that reaches it, [F, N + 1] each; a run of all -inf gives its
    start position, an absent id -inf and N. At a run's start this is the
    JAX package's segmented suffix scan (``_segmented_suffix_best``),
    here as two per-run scatter reductions (max, then min position)."""
    n_feat, n = score.shape
    best = torch.full((n_feat, n + 1), -torch.inf, dtype=score.dtype,
                      device=score.device).scatter_reduce_(
        1, s_rel, score, "amax")
    pos = torch.arange(n, device=score.device).expand(n_feat, n)
    hit = score == best.gather(1, s_rel)
    best_p = torch.full((n_feat, n + 1), n, dtype=torch.int64,
                        device=score.device).scatter_reduce_(
        1, s_rel, torch.where(hit, pos, n), "amin")
    return best, best_p


def _node_lookup(sample_rel, w_cap):
    """Each node slot's run start and end positions in the sorted order
    (clamped in bounds) and whether it holds a sample, [w_cap] each. Runs
    appear in node order in every feature's sorted array (a stable sort of
    the same ids), so slot j's run starts at the count of samples in lower
    slots, shared by all features."""
    n = sample_rel.shape[0]
    count = torch.zeros(w_cap + 1, dtype=torch.int64,
                        device=sample_rel.device).scatter_add_(
        0, sample_rel, torch.ones_like(sample_rel))[:w_cap]
    pos = _exclusive_cumsum(count, 0)
    pos_end = torch.clamp(pos + count - 1, 0, n - 1)
    return torch.clamp(pos, max=n - 1), pos_end, count > 0


def _fit_one_tree(x, y01, w, key, order0, xsorted, *, random_splits,
                  max_features, max_depth, max_nodes):
    """Grow one tree a level at a time on the exact grower. x [N, F], the
    tree's weights w [N], its grower key [2]; order0/xsorted [F, N] each
    feature's stable value order and sorted values. Level d draws from
    fold_in(key, d): the feature order from kf ([N, F] uniforms), the
    Extra Trees thresholds from kt ([F, N]). A level's node slots are the
    window [level_base, level_base + N) and its children's [n_nodes,
    n_nodes + 2N), so the node arrays carry 2N slots of padding. Reads one
    number a level, its split count. Returns the Forest field tensors of
    the tree (node axis ``max_nodes``) and its node count."""
    dev = x.device
    n, n_feat = x.shape
    park = n                            # node slots are [0, n); n = parked
    m_pad = max_nodes + 2 * n
    feature = torch.full((m_pad,), -1, dtype=torch.int32, device=dev)
    threshold = torch.zeros(m_pad, dtype=x.dtype, device=dev)
    left = torch.full_like(feature, -1)
    right = torch.full_like(feature, -1)
    value = torch.zeros((m_pad, 2), dtype=x.dtype, device=dev)

    wy = w * y01
    sample_rel = torch.where(w > 0, 0, park)
    w_f, wy_f = w[order0], wy[order0]
    tot_wy0 = wy.sum()
    value[0] = torch.stack([w.sum() - tot_wy0, tot_wy0])
    minus_inf = torch.tensor(-torch.inf, dtype=x.dtype, device=dev)

    # Every level's (kf, kt) in one batch, not two hashes a level.
    level_keys = rng.split(rng.fold_in(
        key, torch.arange(max_depth, device=dev)))           # [D, 2, 2]
    n_nodes, level_base, d = 1, 0, 0
    while d < max_depth and n_nodes > level_base:
        kf, kt = level_keys[d].unbind(0)

        # ---- (node, value) order per feature: a stable sort by node id --
        s_rel, perm = torch.sort(sample_rel[order0], dim=1, stable=True)
        s_val = xsorted.gather(1, perm)
        s_w = w_f.gather(1, perm)
        s_wy = wy_f.gather(1, perm)
        is_start, is_end = _run_boundaries(s_rel)
        lw_pre, tot_w = _prefix_stats(s_w, is_start, is_end)
        lwy_pre, tot_wy = _prefix_stats(s_wy, is_start, is_end)
        pos_j, pos_end_j, present = _node_lookup(sample_rel, n)
        active = s_rel < park
        v_next = torch.cat([s_val[:, 1:], s_val[:, -1:]], 1)

        tot_w_j = tot_w[:, pos_j]                            # [F, N]
        tot_wy_j = tot_wy[:, pos_j]
        v_lo_j = s_val[:, pos_j]                             # node min
        v_hi_j = s_val[:, pos_end_j]                         # node max
        nc_j = present[None, :] & (v_hi_j - v_lo_j > FEATURE_EPS)

        if random_splits:
            # Extra Trees: one uniform threshold per (feature, node) in
            # [node min, node max); the left side is a prefix of the run.
            u = rng.uniform(kt, (n_feat, n))
            thr_j = _fma(u, v_hi_j - v_lo_j, v_lo_j)
            thr_j = torch.where(thr_j >= v_hi_j, v_lo_j, thr_j)  # sklearn
            thr_s = thr_j.gather(1, torch.clamp(s_rel, max=n - 1))
            left_i = (s_val <= thr_s) & active
            zero = torch.zeros_like(s_w)
            _, lw_tot = _prefix_stats(torch.where(left_i, s_w, zero),
                                      is_start, is_end)
            _, lwy_tot = _prefix_stats(torch.where(left_i, s_wy, zero),
                                       is_start, is_end)
            lw_j = lw_tot[:, pos_j]
            lwy_j = lwy_tot[:, pos_j]
            rw_j = tot_w_j - lw_j
            score_j = _proxy_score(lw_j, lwy_j, rw_j, tot_wy_j - lwy_j,
                                   nc_j & (lw_j > 0) & (rw_j > 0))
        else:
            # Exact best split: every position between two distinct values
            # of a run is a candidate; the lowest best position wins.
            rw = tot_w - lw_pre
            valid = (active & ~is_end & (v_next - s_val > FEATURE_EPS)
                     & (lw_pre > 0) & (rw > 0))
            score_i = _proxy_score(lw_pre, lwy_pre, rw, tot_wy - lwy_pre,
                                   valid)
            best, best_p = _run_best(s_rel, score_i)
            score_j = best[:, :n]
            bpos_j = torch.clamp(best_p[:, :n], max=n - 1)
            v_lo = s_val.gather(1, bpos_j)
            v_hi = v_next.gather(1, bpos_j)
            thr_j = (v_lo + v_hi) / 2.0
            thr_j = torch.where(thr_j == v_hi, v_lo, thr_j)  # midpoint guard
            lw_j = lw_pre.gather(1, bpos_j)
            lwy_j = lwy_pre.gather(1, bpos_j)
            score_j = torch.where(torch.isfinite(score_j), score_j, minus_inf)

        # ---- feature choice (sklearn's random feature draw) --------------
        u_f = rng.uniform(kf, (n, n_feat)) if max_features is not None \
            else None
        sel = _select_features(nc_j.T, u_f, max_features).T
        score_j = torch.where(sel, score_j, minus_inf)
        best_f = torch.argmax(score_j, 0)                    # [N]

        def pick_f(t):                                       # [F,N] -> [N]
            return t.gather(0, best_f[None])[0]

        best_score = pick_f(score_j)
        thr_node = pick_f(thr_j)
        lw_b, lwy_b = pick_f(lw_j), pick_f(lwy_j)
        tot_w_b, tot_wy_b = pick_f(tot_w_j), pick_f(tot_wy_j)

        impure = (tot_wy_b > 0) & (tot_w_b - tot_wy_b > 0)
        can_split = torch.isfinite(best_score) & impure & present
        rank = _exclusive_cumsum(can_split.to(torch.int64), 0)
        left_g = n_nodes + 2 * rank
        can_split = can_split & (left_g + 1 < max_nodes)     # capacity

        # ---- the level's window writes, then its children's covers ------
        win = slice(level_base, level_base + n)
        feature[win] = torch.where(can_split, best_f.to(torch.int32),
                                   feature[win])
        threshold[win] = torch.where(can_split, thr_node, threshold[win])
        left[win] = torch.where(can_split, left_g.to(torch.int32), left[win])
        right[win] = torch.where(can_split, (left_g + 1).to(torch.int32),
                                 right[win])
        child_vals, child_ok, _ = _emit_children(
            can_split[None], lw_b[None], lwy_b[None], tot_w_b[None],
            tot_wy_b[None])
        cwin = slice(n_nodes, n_nodes + 2 * n)
        value[cwin] = torch.where(child_ok[0, :, None], child_vals[0],
                                  value[cwin])

        # ---- route samples to children; park the rest -------------------
        rel_safe = torch.clamp(sample_rel, max=n - 1)
        splits_mine = can_split[rel_safe] & (sample_rel < park)
        xv = x.gather(1, best_f[rel_safe][:, None])[:, 0]
        go_left = xv <= thr_node[rel_safe]
        child_rel = 2 * rank[rel_safe] + torch.where(go_left, 0, 1)
        sample_rel = torch.where(splits_mine, child_rel, park)
        k_splits = int(can_split.sum())         # the one host read a level
        n_nodes, level_base, d = n_nodes + 2 * k_splits, n_nodes, d + 1

    m = max_nodes
    return (feature[:m], threshold[:m], left[:m], right[:m], value[:m],
            n_nodes)


def fit_forest(x, y, w, key, *, n_trees, bootstrap, random_splits,
               sqrt_features, max_depth=48, max_nodes=None):
    """Fit an ensemble on the exact grower, one tree after another. x
    [N, F] f32; y [N] bool/int; w [N] >= 0 sample weights (0 = row
    excluded); ``key`` a threefry key [2]. Returns a ``Forest`` with a
    [n_trees, ...] leading axis.

    DecisionTree = 1 tree, no bootstrap, no random splits, all features.
    Keys as the JAX package's: tree t's key is split(key, n_trees)[t],
    which splits into its bootstrap key and its grower key."""
    n, n_feat = x.shape
    if max_nodes is None:
        max_nodes = 2 * n
    max_features = max(1, int(n_feat ** 0.5)) if sqrt_features else None
    x = x.to(torch.float32)
    y01 = y.to(x.dtype)
    w = w.to(x.dtype)
    # Each feature's value order, shared by every tree (weights never
    # reorder values; parked rows are handled by the level's node ids).
    order0 = torch.argsort(x.T, dim=1, stable=True)
    xsorted = x.T.gather(1, order0)

    kk = rng.split(rng.split(key, n_trees))
    wt = bootstrap_weights(w, kk[:, 0]) if bootstrap \
        else w.expand(n_trees, -1)
    grown = [_fit_one_tree(x, y01, wt[t], kk[t, 1], order0, xsorted,
                           random_splits=random_splits,
                           max_features=max_features, max_depth=max_depth,
                           max_nodes=max_nodes)
             for t in range(n_trees)]
    fields = [torch.stack(f) for f in list(zip(*grown))[:5]]
    n_nodes = torch.tensor([g[5] for g in grown], dtype=torch.int32,
                           device=x.device)
    return Forest(*fields, n_nodes, max_depth)


def predict_proba(forest, x):
    """Mean over trees of the leaf class distributions (sklearn soft
    vote). Traverses ``max_depth + 1`` levels of per-tree table lookups;
    the tree mean sums in tree order, as the JAX package's reduce does."""
    n_tree = forest.feature.shape[0]
    s = x.shape[0]
    xt = x.T.contiguous()
    sample_ix = torch.arange(s, device=x.device)[None, :]
    node = torch.zeros((n_tree, s), dtype=torch.int64, device=x.device)
    feature = forest.feature.to(torch.int64)
    left = forest.left.to(torch.int64)
    right = forest.right.to(torch.int64)
    for _ in range(int(forest.max_depth) + 1):
        f = feature.gather(1, node)
        xv = xt[torch.clamp(f, min=0), sample_ix]
        nxt = torch.where(xv <= forest.threshold.gather(1, node),
                          left.gather(1, node), right.gather(1, node))
        node = torch.where(f < 0, node, nxt)
    v = forest.value.gather(1, node[..., None].expand(-1, -1, 2))
    probs = v / torch.clamp(v.sum(-1, keepdim=True), min=1e-30)
    total = probs[0]
    for t in range(1, n_tree):
        total = total + probs[t]
    return total / n_tree


def predict(forest, x):
    """Binary predict: class 1 iff p1 > p0 (a tie goes to class 0)."""
    p = predict_proba(forest, x)
    return p[:, 1] > p[:, 0]


def predict_batch(forests, x):
    """``predict`` for a list of forests (one per fold) against a shared
    matrix: [len(forests), N] bool."""
    return torch.stack([predict(f, x) for f in forests])
