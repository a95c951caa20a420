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

The exact grower (``fit_forest``, its trees as one batch) grows a tree a
level at a time: a stable sort by node id of each feature's value-sorted
samples puts every node's samples in one run in value order, and every
position between two distinct values of a run is a candidate split
(sklearn's ``splitter="best"``, midpoint thresholds). It has no kernel of
its own: sorts, scans, gathers and scatters over [F, N]. Its loop reads
one number a level. Which grower a config takes is
``hist_tier_default``'s rule alone.

Both growers also take a fold batch (``fit_folds_hist``, ``fit_folds``):
the trees of G groups, each group with its own samples and keys, grow as
one batch, one BFS step or one level serving every group; a group is a
fold of a config, and a config-batched sweep puts several configs' folds
on the group axis (on the histogram grower each group then reads its own
config's bin edges). ``predict_batch`` predicts the folds' forests as one
batch. Each group's forest is the one its one-fold fit grows, bit for
bit.

Weights are small integers, so every histogram and prefix sum is exact in
f32 in any order. ``argmax`` takes the first maximum (the lowest boundary,
the lowest feature), as ``jnp.argmax`` does.

``fit_forest_hist``, ``fit_forest`` and ``predict_proba`` are instrumented
(``obs/costs.py``) under the JAX package's span names: their dispatches
are counted, and with telemetry on the first call of each signature emits
a ``cost`` event; the histogram grower's carries the analytic per-stage
flop split (``fit_stage_flops``) that ``report --attrib`` divides the fit
wall by.
"""

import os
from typing import NamedTuple

import torch

from flake16_framework_tpu_torch import rng
from flake16_framework_tpu_torch import constants
from flake16_framework_tpu_torch.kernels.hist import cum_hists, max_window
from flake16_framework_tpu_torch.obs import costs

# Node-batch width of the BFS step per device type (results-neutral),
# unless an operator pins it with the JAX package's variables: on the card
# ``F16_HIST_NODE_BATCH``, on the CPU a nonzero ``F16_HIST_NODE_BATCH_CPU``.
NODE_BATCH = {"cuda": 128, "cpu": 8}
NODE_BATCH_ENV = {"cuda": "F16_HIST_NODE_BATCH",
                  "cpu": "F16_HIST_NODE_BATCH_CPU"}


# The bins are uint8 and K1 takes at most 256 of them (``kernels/hist``).
MAX_BINS = 256  # f16lint: disable=G108 (K1's limit, not a tunable)


def _checked(name, got, domain):
    """``got``, the value of arm ``name``; ValueError in the JAX
    package's words outside ``domain``."""
    if got not in domain:
        raise ValueError(f"{name} must be {'|'.join(domain)}, got {got!r}")
    return got


def hist_bins(n_bins=None, env=None):
    """The histogram grower's bin count: ``n_bins``, else
    ``F16_HIST_BINS``, else 64 (read at call time). A whole number from 2
    to ``MAX_BINS``, else ValueError: the bins are uint8 and K1 takes at
    most 256. Bin-granular candidates make this a model-changing knob."""
    env = os.environ if env is None else env
    raw = n_bins if n_bins is not None else env.get(
        "F16_HIST_BINS", str(constants.HIST_BINS))
    try:
        bins = int(str(raw).strip())
    except ValueError:
        bins = 0
    if not 2 <= bins <= MAX_BINS:
        raise ValueError(f"F16_HIST_BINS must be a whole number from 2 to "
                         f"{MAX_BINS} (the bins are uint8 and K1 takes at "
                         f"most {MAX_BINS}), got {raw!r}")
    return bins


def hist_refine(refine=None):
    """The hist grower's threshold refinement: ``refine``, else
    ``F16_HIST_REFINE``, else "exact" (each Random Forest winner
    sharpened to sklearn's midpoint); "edge" keeps the raw bin edge."""
    if refine is None:
        refine = os.environ.get("F16_HIST_REFINE", constants.HIST_REFINE)
    return _checked("F16_HIST_REFINE", refine, ("exact", "edge"))


def et_draw(draw=None):
    """The hist grower's Extra Trees threshold draw: ``draw``, else
    ``F16_ET_DRAW``, else "value" (uniform over the node's value span,
    rounded down to a bin edge); "rank" is uniform over the occupied
    boundary indices, which fewer than 3 bins always take."""
    if draw is None:
        draw = os.environ.get("F16_ET_DRAW", constants.ET_DRAW)
    return _checked("F16_ET_DRAW", draw, ("value", "rank"))


def feature_quota(quota=None):
    """Both growers' per-node feature quota: ``quota``, else
    ``F16_FEATURE_QUOTA``, else "informative" (the ``max_features``
    non-constant features with the smallest draws); "sklearn" lets
    constant features use up the quota, as sklearn 1.0.2's splitter
    does."""
    if quota is None:
        quota = os.environ.get("F16_FEATURE_QUOTA", constants.FEATURE_QUOTA)
    return _checked("F16_FEATURE_QUOTA", quota, ("sklearn", "informative"))


def _arms(refine=None, draw=None, quota=None):
    """One fit's resolved arms, as the growers take them (here, the fit
    functions' keywords do not shadow the resolvers)."""
    return dict(refine=hist_refine(refine), draw=et_draw(draw),
                quota=feature_quota(quota))


def default_node_batch(device_type, env=None, n_bins=None):
    """The hist grower's window width on ``device_type`` when its caller
    names none: the operator's pin (``NODE_BATCH_ENV``; "0" on the CPU
    means none, as in the JAX package), else ``NODE_BATCH`` cut to the
    widest window K1 holds at the grower's bins (``hist_bins(n_bins)``;
    ``kernels/hist.max_window``: 226 nodes at 64 bins, 113 at 128). A pin
    must be a whole number from 1 to that width, else ValueError."""
    env = os.environ if env is None else env
    limit = max_window(hist_bins(n_bins, env))
    name = NODE_BATCH_ENV[device_type]
    raw = env.get(name, "").strip()
    if raw == "" or (device_type == "cpu" and raw == "0"):
        return min(NODE_BATCH[device_type], limit)
    try:
        width = int(raw)
    except ValueError:
        width = 0
    if not 1 <= width <= limit:
        raise ValueError(f"{name}={raw!r}: the window width must be a whole "
                         f"number from 1 to {limit}")
    return width


def fit_stage_flops(*, n, n_feat, n_bins, n_trees, n_nodes, max_nodes,
                    node_batch=None, device_type="cuda"):
    """Analytic per-stage flop model of one hist-grower fit (the JAX
    package's, host arithmetic): {"bin", "hist_build", "split_scan",
    "partition"} flop counts for ``n_trees`` growths of ``n_nodes``-node
    trees, each term its leading shape factor. ``report --attrib`` splits
    the measured fit wall in proportion to these counts.

    - bin: one-time quantile binning, n x F x B one-hot expansion;
    - hist_build: per window step, the [n, bw] x [n, F*B] one-hot
      contraction (2 flops per MAC);
    - split_scan: per step, cumsum + gini proxy + argmax/extract over
      the [F, bw, B] histogram space (~12 passes);
    - partition: per step, the O(n x bw) membership one-hot plus
      refinement reduces, and O(n) routing gathers.

    ``node_batch`` (the window width bw) defaults to the grower's own at
    these bins, ``default_node_batch(device_type, n_bins=n_bins)``."""
    if node_batch is None:
        node_batch = default_node_batch(device_type, n_bins=n_bins)
    bw = max(1, min(node_batch, max_nodes))
    steps = max(1, -(-int(n_nodes) // bw))
    per_tree = {
        "bin": float(n * n_feat * n_bins) / max(1, n_trees),  # shared once
        "hist_build": float(steps * 2 * n * bw * n_feat * n_bins),
        "split_scan": float(steps * 12 * n_feat * bw * n_bins),
        "partition": float(steps * (4 * n * bw + 6 * n)),
    }
    return {k: round(v * n_trees, 1) for k, v in per_tree.items()}


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


def quantile_edges(x, n_bins=None):
    """Inner bin edges [F, B-1] at B = ``hist_bins(n_bins)`` bins:
    midpoints between adjacent sorted values at quantile ranks. Bin b
    covers edges[b-1] < x <= edges[b]."""
    n_bins = hist_bins(n_bins)
    n = x.shape[0]
    # stable, as jnp.sort: -0.0 and 0.0 compare equal and keep their order
    xs = torch.sort(x, dim=0, stable=True).values
    ks = torch.clamp((torch.arange(1, n_bins, device=x.device) * n)
                     // n_bins - 1, 0, n - 1)
    lo = xs[ks]
    hi = xs[torch.clamp(ks + 1, 0, n - 1)]
    return ((lo + hi) * 0.5).T.contiguous()


def bin_indices(x, edges):
    """Bin index [..., N, F] int64: the count of edges strictly below x.
    ``edges`` [F, B-1] serve every row; [G, F, B-1] (x [G, N, F]) are one
    set a group."""
    if edges.dim() == 3:
        edges = edges[:, None]
    return (x[..., None] > edges).sum(-1)


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


def _select_features(nc, u, max_features,
                     quota=constants.FEATURE_QUOTA):
    """sklearn's per-node feature draw. nc [..., F] bool, u [..., F]
    uniforms; returns sel [..., F] bool. The "informative" quota takes
    the ``max_features`` non-constant features with the smallest draws.
    The "sklearn" quota visits the features in the order of their draws
    (ranks from two stable argsorts, as ``jnp.argsort``'s): the visited
    prefix is ``max_features`` long, stretched to reach the first
    non-constant feature, and selects the non-constant ones in it."""
    if max_features is None:
        return nc
    if quota == "informative":
        r = torch.where(nc, u, torch.full_like(u, torch.inf))
        kth = torch.sort(r, dim=-1).values[..., max_features - 1:
                                           max_features]
        return (r <= kth) & nc
    n_feat = nc.shape[-1]
    rank = torch.argsort(torch.argsort(u, dim=-1, stable=True), dim=-1,
                         stable=True)
    first_nc = torch.where(nc, rank, n_feat).min(-1, keepdim=True).values
    return nc & (rank < torch.clamp(first_nc + 1, min=max_features))


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
                max_depth, max_nodes, node_batch,
                refine=constants.HIST_REFINE, draw=constants.ET_DRAW,
                quota=constants.FEATURE_QUOTA):
    """Grow a batch of T trees on G groups of samples: x [G, N, F], their
    bins bin_t [G, F, N] and labels y01 [G, N]; the bin edges [F, B-1]
    are shared, or [G, F, B-1] are a group's. Per-tree weights w [T, N]
    and grower keys kg [T, 2]; tree t belongs to group t // (T / G).
    ``refine``, ``draw`` and ``quota`` are the resolved arms
    (``hist_refine``, ``et_draw``, ``feature_quota``); fewer than 3 bins
    take the rank draw. Returns the Forest field tensors (feature,
    threshold, left, right, value, n_nodes), tree axis T, node axis cut
    to ``max_nodes``."""
    dev = x.device
    n_group = x.shape[0]
    n_tree, n = w.shape
    tpg = n_tree // n_group                                  # trees a group
    n_feat, n_bins = edges.shape[-2], edges.shape[-1] + 1
    bw = min(node_batch, max_nodes)
    m_pad = max_nodes + 2 * bw
    iota_w = torch.arange(bw, device=dev)
    iota_t = torch.arange(n_tree, device=dev)
    feat_ix = torch.arange(n_feat, device=dev)[None, :, None]
    xt = x.transpose(1, 2).contiguous()                      # [G, F, N]
    sample_ix = torch.arange(n, device=dev)[None, :]
    group_ix = iota_t[:n_group, None, None]                  # [G, 1, 1]

    def at_group(t, f):
        """t [G, F, N] read at each tree's group, feature f [T, N] and
        sample: [T, N]. One group reads as a [F, N] tensor: on CUDA the
        three-index read costs one more launch (a copy of the expanded
        indices), which a one-fold step does not pay."""
        if n_group == 1:
            return t[0][f, sample_ix]
        return t[group_ix, f.view(n_group, tpg, n), sample_ix].view(n_tree, n)

    if edges.dim() == 2:
        def edge_at(t, b):
            """t [F, K] at each tree's feature and index b [T, F, W]."""
            return t[feat_ix, b]
    else:
        tree_group = (iota_t // tpg)[:, None, None]          # [T, 1, 1]

        def edge_at(t, b):
            """t [G, F, K] at each tree's group, feature and b."""
            return t[tree_group, feat_ix, b]

    feature = torch.full((n_tree, m_pad), -1, dtype=torch.int32, device=dev)
    threshold = torch.zeros((n_tree, m_pad), dtype=x.dtype, device=dev)
    left = torch.full((n_tree, m_pad), -1, dtype=torch.int32, device=dev)
    right = torch.full((n_tree, m_pad), -1, dtype=torch.int32, device=dev)
    value = torch.zeros((n_tree, m_pad, 2), dtype=x.dtype, device=dev)
    depth = torch.zeros((n_tree, m_pad), dtype=torch.int64, device=dev)

    wy = (w.view(n_group, tpg, n) * y01[:, None, :]).view(n_tree, n)
    sample_node = torch.where(w > 0, 0, -1).to(torch.int64)  # [T, N]
    tot_w0, tot_wy0 = w.sum(1), wy.sum(1)
    value[:, 0, 0] = tot_w0 - tot_wy0
    value[:, 0, 1] = tot_wy0
    a = torch.ones(n_tree, dtype=torch.int64, device=dev)
    p = torch.zeros(n_tree, dtype=torch.int64, device=dev)
    u_feat, u_thr = _node_uniforms(kg, max_nodes + bw, n_feat, random_splits)
    rank_draw = draw == "rank" or n_bins < 3

    if random_splits and not rank_draw:
        # Node value span from the occupied bins' edge values; the end
        # bins extrapolate one neighbour width.
        first = edges[..., :1] - (edges[..., 1:2] - edges[..., :1])
        last = edges[..., -1:] + (edges[..., -1:] - edges[..., -2:-1])
        full_edges = torch.cat([first, edges, last], -1)     # [(G,) F, B+1]
        # each tree's edges, [T or 1, F, 1, B-1]
        tree_edges = edges[None, :, None, :] if edges.dim() == 2 \
            else edges[tree_group[:, 0]].transpose(1, 2)

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
            # lower boundary; or, under the rank draw, uniformly over the
            # span's boundary indices.
            prev = torch.cat([torch.zeros_like(cw[..., :1]), cw[..., :-1]],
                             -1)
            occ = (cw > prev).to(torch.uint8)                # [T, F, W, B]
            lo = torch.argmax(occ, -1)
            hi = n_bins - 1 - torch.argmax(torch.flip(occ, [-1]), -1)
            u = u_thr[iota_t[:, None], ids].permute(0, 2, 1)  # [T, F, W]
            if rank_draw:
                # one product and a floor: no multiply-add to contract
                span = torch.clamp(hi - lo, min=1)
                bsel = lo + 1 + torch.floor(u * span).to(torch.int64)
            else:
                vmin = edge_at(full_edges, lo)
                vmax = edge_at(full_edges, hi + 1)
                thr_v = _fma(u, vmax - vmin, vmin)
                cnt = (tree_edges < thr_v[..., None]).sum(-1)
                bsel = torch.minimum(torch.maximum(cnt, lo + 1), hi)
            bm1 = torch.clamp(bsel - 1, 0, n_bins - 2)
            lw_j = lw.gather(-1, bm1[..., None])[..., 0]
            lwy_j = lwy.gather(-1, bm1[..., None])[..., 0]
            rw_j = tot_w[:, None, :] - lw_j
            ok_j = nc & (lw_j > 0) & (rw_j > 0)
            score_j = _proxy_score(lw_j, lwy_j, rw_j,
                                   tot_wy[:, None, :] - lwy_j, ok_j)
            bound_j = bsel
            thr_j = edge_at(edges, bm1)
        else:
            score = _proxy_score(lw, lwy, rw, rwy, valid)    # [T, F, W, B-1]
            bb = torch.argmax(score, -1)                     # lowest boundary
            score_j = score.gather(-1, bb[..., None])[..., 0]
            bound_j = bb + 1
            lw_j = lw.gather(-1, bb[..., None])[..., 0]
            lwy_j = lwy.gather(-1, bb[..., None])[..., 0]
            thr_j = edge_at(edges, bb)

        # ---- feature choice (sklearn's random feature draw) --------------
        u_f = u_feat[iota_t[:, None], ids]                   # [T, W, F]
        sel = _select_features(nc.permute(0, 2, 1), u_f, max_features,
                               quota)
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
        go_left = at_group(bin_t, bf_mine) < bound_n.gather(1, rs)

        if not random_splits and refine == "exact":
            # Sharpen each winner to the exact sklearn midpoint between
            # the closest member values either side of the chosen edge;
            # routing is unchanged, only the stored threshold moves.
            xv = at_group(xt, bf_mine)
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
    round(sum(w)) inverse-CDF draws, one uniform per row. w [..., N] (a
    leading axis of folds, each with its own rows), keys [..., T, 2] ->
    counts [..., T, N]."""
    n = w.shape[-1]
    n_tree = keys.shape[-2]
    total = w.sum(-1, keepdim=True)
    cdf = torch.cumsum(w, -1) / torch.clamp(total, min=1.0)
    u = rng.uniform(keys, (n,))                              # [..., T, N]
    # right=True: a draw of exactly 0.0 must not pick a leading zero row.
    idx = torch.clamp(torch.searchsorted(
        cdf, u.reshape(*u.shape[:-2], n_tree * n), right=True), 0, n - 1)
    keep = (torch.arange(n, device=w.device)
            < torch.round(total).to(torch.int64)).to(w.dtype)
    return torch.zeros(u.shape, dtype=w.dtype, device=w.device).scatter_add_(
        -1, idx.view(u.shape),
        keep[..., None, :].expand(u.shape).contiguous())


def _batches(n_folds, n_trees, tree_chunk, fold_chunk):
    """The (fold slice, tree slice) of each tree batch: every tree of every
    fold when no bound is given, else at most ``fold_chunk`` folds by
    ``tree_chunk`` trees a batch."""
    tc = tree_chunk or n_trees
    fc = fold_chunk or n_folds
    return [(slice(g, g + fc), slice(t, t + tc))
            for g in range(0, n_folds, fc) for t in range(0, n_trees, tc)]


def _joined(parts, n_folds, n_trees, tree_chunk, fold_chunk):
    """The Forest field tensors of tree batches (``_batches`` order),
    each [g, t, ...], joined into [n_folds, n_trees, ...]."""
    if len(parts) == 1:
        return parts[0]
    n_t = len(range(0, n_trees, tree_chunk or n_trees))
    rows = [[torch.cat(f, 1) for f in zip(*parts[i:i + n_t])]
            for i in range(0, len(parts), n_t)]
    return [torch.cat(f, 0) for f in zip(*rows)]


def fit_folds_hist(x, y, w, keys, *, edges, n_trees, bootstrap,
                   random_splits, sqrt_features, max_depth=48, max_nodes=None,
                   tree_chunk=None, fold_chunk=None, node_batch=None,
                   n_bins=None, refine=None, et_draw=None,
                   feature_quota=None):
    """Fit one histogram-grown ensemble a fold, the folds' trees grown as
    one tree batch. x [G, N, F] f32, y [G, N] bool/int, w [G, N] >= 0
    sample weights (0 = row excluded) and ``keys`` [G, 2] threefry keys,
    one a fold; ``edges`` [F, B-1] are shared by the folds (once a
    config), or [G, F, B-1] are one set a group (a config batch: each
    fold reads its own config's edges). The edges carry the bin count B;
    ``n_bins``, where given, must agree with them. The arms ``refine``,
    ``et_draw`` and ``feature_quota`` resolve at the call
    (``hist_refine``, ``et_draw``, ``feature_quota``). Returns a
    ``Forest`` with [G, n_trees, ...] leading axes.

    RandomForest = bootstrap, not random_splits; ExtraTrees = random_splits,
    no bootstrap; both with sqrt_features. Tree t of fold g draws from
    ``split(split(keys[g], n_trees)[t])``, so each fold's forest equals
    ``fit_forest_hist`` on that fold bit for bit, and neither the BFS
    window width (``node_batch``; None: ``default_node_batch`` of the
    device type) nor the batches change it: at most ``fold_chunk`` folds by
    ``tree_chunk`` trees grow as one batch (None: all). A batch's step
    workspace is about 5 MiB a tree at N = 8000, W = 128
    (``parallel/sweep.py``, ``TREES_IN_FLIGHT``)."""
    n_fold, n, n_feat = x.shape
    bins = edges.shape[-1] + 1
    if n_bins is not None and hist_bins(n_bins) != bins:
        raise ValueError(f"fit_folds_hist: n_bins={n_bins} but the edges "
                         f"hold {bins} bins")
    arms = _arms(refine, et_draw, feature_quota)
    if max_nodes is None:
        max_nodes = 2 * n
    max_features = max(1, int(n_feat ** 0.5)) if sqrt_features else None
    x = x.to(torch.float32)
    y01 = y.to(x.dtype)
    w = w.to(x.dtype)
    bin_t = bin_indices(x, edges).transpose(1, 2).to(
        torch.uint8).contiguous()                            # [G, F, N]
    kk = rng.split(rng.split(keys, n_trees))                 # [G, T, 2, 2]
    kb, kg = kk[..., 0, :], kk[..., 1, :]
    wt = bootstrap_weights(w, kb) if bootstrap \
        else w[:, None, :].expand(n_fold, n_trees, n)
    parts = []
    for gs, ts in _batches(n_fold, n_trees, tree_chunk, fold_chunk):
        wb = wt[gs, ts]
        # K1 takes w contiguous, from a 16-byte boundary
        w_flat = wb.reshape(-1, n).contiguous()
        if w_flat.data_ptr() % 16:
            w_flat = w_flat.clone()
        fields = _grow_trees(
            x[gs], bin_t[gs], edges if edges.dim() == 2 else edges[gs],
            y01[gs], w_flat,
            kg[gs, ts].reshape(-1, 2), random_splits=random_splits,
            max_features=max_features, max_depth=max_depth,
            max_nodes=max_nodes, node_batch=node_batch or default_node_batch(
                x.device.type, n_bins=bins), **arms)
        parts.append([f.view(*wb.shape[:2], *f.shape[1:]) for f in fields])
    return Forest(*_joined(parts, n_fold, n_trees, tree_chunk, fold_chunk),
                  max_depth)


def fit_forest_hist(x, y, w, key, *, n_trees, bootstrap, random_splits,
                    sqrt_features, max_depth=48, max_nodes=None, edges=None,
                    tree_chunk=None, n_bins=None, refine=None, et_draw=None,
                    feature_quota=None):
    """Fit a histogram-grown ensemble on one fold: ``fit_folds_hist`` with
    one fold. x [N, F] f32; y [N] bool/int; w [N] >= 0 sample weights;
    ``key`` a threefry key [2]; ``edges`` (once per config) default to
    ``quantile_edges(x, n_bins)``. Returns a ``Forest`` with a
    [n_trees, ...] leading axis."""
    x = x.to(torch.float32)
    if edges is None:
        edges = quantile_edges(x, n_bins)
    forest = fit_folds_hist(
        x[None], y[None], w[None], key[None], edges=edges, n_trees=n_trees,
        bootstrap=bootstrap, random_splits=random_splits,
        sqrt_features=sqrt_features, max_depth=max_depth,
        max_nodes=max_nodes, tree_chunk=tree_chunk, n_bins=n_bins,
        refine=refine, et_draw=et_draw, feature_quota=feature_quota)
    return Forest(*(f[0] for f in forest[:-1]), max_depth)


def ensemble_grower(grower=None):
    """The ensembles' grower: ``grower``, else the ``F16_ENSEMBLE_GROWER``
    environment variable, else "hist" (read at call time, as the JAX
    package reads it); "exact" grows ensembles on the exact grower.
    Raises ValueError for any other value."""
    g = grower or os.environ.get("F16_ENSEMBLE_GROWER", "hist")
    if g not in ("hist", "exact"):
        raise ValueError(
            f"grower/F16_ENSEMBLE_GROWER must be hist|exact, got {g!r}")
    return g


def hist_tier_default(n_trees, grower=None):
    """Whether a config of ``n_trees`` trees grows on the histogram grower:
    an ensemble does unless its grower (``ensemble_grower``) is "exact"; a
    single tree grows on the exact grower, since with no averaging over
    trees the bin-granular choice of candidates moved the single tree's F1
    (the JAX package's parity record). The only switch between the two
    growers."""
    return n_trees > 1 and ensemble_grower(grower) == "hist"


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
    """For each node id j of the sorted ids ``s_rel`` [..., F, N] (values
    in [0, N], N = parked): the best ``score`` of j's run and the lowest
    position that reaches it, [..., F, N + 1] each; a run of all -inf
    gives its start position, an absent id -inf and N. At a run's start
    this is the JAX package's segmented suffix scan
    (``_segmented_suffix_best``), here as two per-run scatter reductions
    (max, then min position)."""
    n = score.shape[-1]
    shape = (*score.shape[:-1], n + 1)
    best = torch.full(shape, -torch.inf, dtype=score.dtype,
                      device=score.device).scatter_reduce_(
        -1, s_rel, score, "amax")
    pos = torch.arange(n, device=score.device).expand(score.shape)
    hit = score == best.gather(-1, s_rel)
    best_p = torch.full(shape, n, dtype=torch.int64,
                        device=score.device).scatter_reduce_(
        -1, s_rel, torch.where(hit, pos, n), "amin")
    return best, best_p


def _node_lookup(sample_rel, w_cap):
    """Each node slot's run start and end positions in the sorted order
    (clamped in bounds) and whether it holds a sample, [..., w_cap] each,
    from the node ids ``sample_rel`` [..., N]. Runs appear in node order in
    every feature's sorted array (a stable sort of the same ids), so slot
    j's run starts at the count of samples in lower slots, shared by all
    features."""
    n = sample_rel.shape[-1]
    count = torch.zeros((*sample_rel.shape[:-1], w_cap + 1),
                        dtype=torch.int64,
                        device=sample_rel.device).scatter_add_(
        -1, sample_rel, torch.ones_like(sample_rel))[..., :w_cap]
    pos = _exclusive_cumsum(count, -1)
    pos_end = torch.clamp(pos + count - 1, 0, n - 1)
    return torch.clamp(pos, max=n - 1), pos_end, count > 0


def _fit_trees_exact(x, y01, w, keys, order0, xsorted, *, random_splits,
                     max_features, max_depth, max_nodes,
                     quota=constants.FEATURE_QUOTA):
    """Grow the trees of G groups (folds) a level at a time on the exact
    grower, all as one batch. x [G, N, F], labels y01 [G, N] and each
    feature's stable value order and sorted values order0/xsorted
    [G, F, N] are a group's; weights w [G, T, N] and grower keys
    [G, T, 2] a tree's. Level d draws from fold_in(key, d): the feature
    order from kf ([N, F] uniforms), the Extra Trees thresholds from kt
    ([F, N]). A level's node slots are the window [level_base,
    level_base + N) and its children's [n_nodes, n_nodes + 2N), so the
    node arrays carry 2N slots of padding. ``quota`` is the resolved
    feature quota (``feature_quota``).

    A tree's level base and node count are [G, T, 1] tensors, so a
    finished tree's level is a no-op and the loop reads one number a
    level: whether any tree is still growing. A batch of one tree keeps
    them as host ints, read from its split count, and writes its windows
    as slices, the launches of a one-tree level. Which trees share a
    batch changes no tree. Returns the Forest field tensors, [G, T, ...]
    leading axes, node axis ``max_nodes``."""
    dev = x.device
    n_group, n_tree, n = w.shape
    n_feat = x.shape[2]
    park = n                            # node slots are [0, n); n = parked
    m_pad = max_nodes + 2 * n
    one = n_group * n_tree == 1
    lead = (n_group, n_tree)
    per_feat = (*lead, n_feat, n)
    feature = torch.full((*lead, m_pad), -1, dtype=torch.int32, device=dev)
    threshold = torch.zeros((*lead, m_pad), dtype=x.dtype, device=dev)
    left = torch.full_like(feature, -1)
    right = torch.full_like(feature, -1)
    value = torch.zeros((*lead, m_pad, 2), dtype=x.dtype, device=dev)

    def write(arr, base, vals, ok):
        """arr[..., base + j(, :)] = vals[..., j(, :)] where ok[..., j]."""
        if not one:
            _window_update(arr.view(n_group * n_tree, *arr.shape[2:]),
                           base.view(-1), vals.flatten(0, 1),
                           ok.flatten(0, 1))
            return
        win = arr[0, 0, base:base + vals.shape[2]]
        ok = ok[0, 0, :, None] if arr.dim() == 4 else ok[0, 0]
        win.copy_(torch.where(ok, vals[0, 0].to(arr.dtype), win))

    # Each feature's value order is its group's, shared by the group's
    # trees (weights never reorder values; parked rows are handled by the
    # level's node ids).
    order_t = order0[:, None].expand(per_feat)
    xs_t = xsorted[:, None].expand(per_feat)
    x_t = x[:, None].expand(*lead, n, n_feat)
    wy = w * y01[:, None, :]
    sample_rel = torch.where(w > 0, 0, park)                 # [G, T, N]
    w_f = w[..., None, :].expand(per_feat).gather(-1, order_t)
    wy_f = wy[..., None, :].expand(per_feat).gather(-1, order_t)
    tot_wy0 = wy.sum(-1)
    value[..., 0, :] = torch.stack([w.sum(-1) - tot_wy0, tot_wy0], -1)
    minus_inf = torch.tensor(-torch.inf, dtype=x.dtype, device=dev)

    # Every level's (kf, kt) in one batch, not two hashes a level.
    level_keys = rng.split(rng.fold_in(
        keys[..., None, :], torch.arange(max_depth, device=dev)))
    if one:
        n_nodes, level_base = 1, 0
    else:
        n_nodes = torch.ones((*lead, 1), dtype=torch.int64, device=dev)
        level_base = torch.zeros_like(n_nodes)
    d = 0
    # the one host read a level (for one tree, its split count below)
    while d < max_depth and (n_nodes > level_base if one else
                             bool((n_nodes > level_base).any())):
        kf, kt = level_keys[:, :, d].unbind(-2)              # [G, T, 2]

        # ---- (node, value) order per feature: a stable sort by node id --
        s_rel, perm = torch.sort(
            sample_rel[..., None, :].expand(per_feat).gather(-1, order_t),
            dim=-1, stable=True)
        s_val = xs_t.gather(-1, perm)
        s_w = w_f.gather(-1, perm)
        s_wy = wy_f.gather(-1, perm)
        is_start, is_end = _run_boundaries(s_rel)
        lw_pre, tot_w = _prefix_stats(s_w, is_start, is_end)
        lwy_pre, tot_wy = _prefix_stats(s_wy, is_start, is_end)
        pos_j, pos_end_j, present = _node_lookup(sample_rel, n)
        active = s_rel < park
        v_next = torch.cat([s_val[..., 1:], s_val[..., -1:]], -1)

        def at_node(t, pos):            # [G, T, F, N] at each node's run
            return t.gather(-1, pos[..., None, :].expand(per_feat))

        tot_w_j = at_node(tot_w, pos_j)
        tot_wy_j = at_node(tot_wy, pos_j)
        v_lo_j = at_node(s_val, pos_j)                       # node min
        v_hi_j = at_node(s_val, pos_end_j)                   # node max
        nc_j = present[..., None, :] & (v_hi_j - v_lo_j > FEATURE_EPS)

        if random_splits:
            # Extra Trees: one uniform threshold per (feature, node) in
            # [node min, node max); the left side is a prefix of the run.
            u = rng.uniform(kt, (n_feat, n))
            thr_j = _fma(u, v_hi_j - v_lo_j, v_lo_j)
            thr_j = torch.where(thr_j >= v_hi_j, v_lo_j, thr_j)  # sklearn
            thr_s = thr_j.gather(-1, torch.clamp(s_rel, max=n - 1))
            left_i = (s_val <= thr_s) & active
            zero = torch.zeros_like(s_w)
            _, lw_tot = _prefix_stats(torch.where(left_i, s_w, zero),
                                      is_start, is_end)
            _, lwy_tot = _prefix_stats(torch.where(left_i, s_wy, zero),
                                       is_start, is_end)
            lw_j = at_node(lw_tot, pos_j)
            lwy_j = at_node(lwy_tot, pos_j)
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
            score_j = best[..., :n]
            bpos_j = torch.clamp(best_p[..., :n], max=n - 1)
            v_lo = s_val.gather(-1, bpos_j)
            v_hi = v_next.gather(-1, bpos_j)
            thr_j = (v_lo + v_hi) / 2.0
            thr_j = torch.where(thr_j == v_hi, v_lo, thr_j)  # midpoint guard
            lw_j = lw_pre.gather(-1, bpos_j)
            lwy_j = lwy_pre.gather(-1, bpos_j)
            score_j = torch.where(torch.isfinite(score_j), score_j, minus_inf)

        # ---- feature choice (sklearn's random feature draw) --------------
        u_f = rng.uniform(kf, (n, n_feat)) if max_features is not None \
            else None
        sel = _select_features(nc_j.transpose(-1, -2), u_f, max_features,
                               quota).transpose(-1, -2)
        score_j = torch.where(sel, score_j, minus_inf)
        best_f = torch.argmax(score_j, -2)                   # [G, T, N]

        def pick_f(t):                  # [G, T, F, N] -> [G, T, N]
            return t.gather(-2, best_f[..., None, :])[..., 0, :]

        best_score = pick_f(score_j)
        thr_node = pick_f(thr_j)
        lw_b, lwy_b = pick_f(lw_j), pick_f(lwy_j)
        tot_w_b, tot_wy_b = pick_f(tot_w_j), pick_f(tot_wy_j)

        impure = (tot_wy_b > 0) & (tot_w_b - tot_wy_b > 0)
        can_split = torch.isfinite(best_score) & impure & present
        rank = _exclusive_cumsum(can_split.to(torch.int64), -1)
        left_g = n_nodes + 2 * rank
        can_split = can_split & (left_g + 1 < max_nodes)     # capacity

        # ---- the level's window writes, then its children's covers ------
        write(feature, level_base, best_f, can_split)
        write(threshold, level_base, thr_node, can_split)
        write(left, level_base, left_g, can_split)
        write(right, level_base, left_g + 1, can_split)
        child_vals, child_ok, _ = _emit_children(
            *(t.flatten(0, 1) for t in (can_split, lw_b, lwy_b, tot_w_b,
                                        tot_wy_b)))
        write(value, n_nodes, child_vals.view(*lead, 2 * n, 2),
              child_ok.view(*lead, 2 * n))

        # ---- route samples to children; park the rest -------------------
        rel_safe = torch.clamp(sample_rel, max=n - 1)
        splits_mine = can_split.gather(-1, rel_safe) & (sample_rel < park)
        xv = x_t.gather(-1, best_f.gather(-1, rel_safe)[..., None])[..., 0]
        go_left = xv <= thr_node.gather(-1, rel_safe)
        child_rel = 2 * rank.gather(-1, rel_safe) + torch.where(go_left, 0, 1)
        sample_rel = torch.where(splits_mine, child_rel, park)
        n_split = int(can_split.sum()) if one \
            else can_split.sum(-1, keepdim=True)
        level_base, n_nodes = n_nodes, n_nodes + 2 * n_split
        d += 1

    m = max_nodes
    n_nodes = torch.tensor([[n_nodes]], dtype=torch.int32, device=dev) \
        if one else n_nodes[..., 0].to(torch.int32)
    return (feature[..., :m], threshold[..., :m], left[..., :m],
            right[..., :m], value[..., :m, :], n_nodes)


def fit_folds(x, y, w, keys, *, n_trees, bootstrap, random_splits,
              sqrt_features, max_depth=48, max_nodes=None, tree_chunk=None,
              fold_chunk=None, feature_quota=None):
    """Fit one ensemble a fold on the exact grower, the folds' trees grown
    as one batch (``_fit_trees_exact``). x [G, N, F] f32, y [G, N]
    bool/int, w [G, N] >= 0 sample weights (0 = row excluded) and
    ``keys`` [G, 2] threefry keys, one a fold. Returns a ``Forest`` with
    [G, n_trees, ...] leading axes.

    DecisionTree = 1 tree, no bootstrap, no random splits, all features.
    Keys as the JAX package's: tree t of fold g grows from
    split(keys[g], n_trees)[t], which splits into its bootstrap key and
    its grower key. Each fold's forest equals ``fit_forest`` on that fold
    bit for bit, for any batches: at most ``fold_chunk`` folds by
    ``tree_chunk`` trees a batch (None: all). ``feature_quota`` resolves
    at the call (``feature_quota``); the exact grower has no other arm."""
    quota = _arms(quota=feature_quota)["quota"]
    n_fold, n, n_feat = x.shape
    if max_nodes is None:
        max_nodes = 2 * n
    max_features = max(1, int(n_feat ** 0.5)) if sqrt_features else None
    x = x.to(torch.float32)
    y01 = y.to(x.dtype)
    w = w.to(x.dtype)
    xt = x.transpose(1, 2)
    order0 = torch.argsort(xt, dim=-1, stable=True)          # [G, F, N]
    xsorted = xt.gather(-1, order0)
    kk = rng.split(rng.split(keys, n_trees))                 # [G, T, 2, 2]
    wt = bootstrap_weights(w, kk[..., 0, :]) if bootstrap \
        else w[:, None, :].expand(n_fold, n_trees, n)
    parts = [list(_fit_trees_exact(
        x[gs], y01[gs], wt[gs, ts], kk[gs, ts, 1], order0[gs], xsorted[gs],
        random_splits=random_splits, max_features=max_features,
        max_depth=max_depth, max_nodes=max_nodes, quota=quota))
        for gs, ts in _batches(n_fold, n_trees, tree_chunk, fold_chunk)]
    return Forest(*_joined(parts, n_fold, n_trees, tree_chunk, fold_chunk),
                  max_depth)


def fit_forest(x, y, w, key, *, n_trees, bootstrap, random_splits,
               sqrt_features, max_depth=48, max_nodes=None, tree_chunk=None,
               feature_quota=None):
    """Fit an ensemble on the exact grower on one fold: ``fit_folds`` with
    one fold, at most ``tree_chunk`` trees a batch (None: all). x [N, F]
    f32; y [N] bool/int; w [N] >= 0 sample weights; ``key`` a threefry
    key [2]. Returns a ``Forest`` with a [n_trees, ...] leading axis."""
    forest = fit_folds(
        x[None], y[None], w[None], key[None], n_trees=n_trees,
        bootstrap=bootstrap, random_splits=random_splits,
        sqrt_features=sqrt_features, max_depth=max_depth,
        max_nodes=max_nodes, tree_chunk=tree_chunk,
        feature_quota=feature_quota)
    return Forest(*(f[0] for f in forest[:-1]), max_depth)


def predict_impl(impl=None):
    """Predict's walk: ``impl``, else ``F16_PREDICT_IMPL``, else "gather"
    (read at each call). "gather" looks each sample's node up in the
    tables once a level; "windows" sweeps node-id windows
    (``_walk_windows``). Both stop every sample at the same leaf, so their
    results are bitwise equal."""
    if impl is None:
        impl = os.environ.get("F16_PREDICT_IMPL", constants.PREDICT_IMPL)
    return _checked("F16_PREDICT_IMPL", impl, ("gather", "windows"))


def predict_window():
    """The windows walk's width: ``F16_PREDICT_WINDOW``, else 128 (read at
    each call); a whole number >= 1, else ValueError."""
    raw = os.environ.get("F16_PREDICT_WINDOW", str(constants.PREDICT_WINDOW))
    try:
        width = int(str(raw).strip())
    except ValueError:
        width = 0
    if width < 1:
        raise ValueError(f"F16_PREDICT_WINDOW must be a whole number >= 1, "
                         f"got {raw!r}")
    return width


def _walk_gather(forest, x):
    """Each tree's leaf id for each sample, [T, S] int64: ``max_depth +
    1`` levels of per-tree table lookups."""
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
    return node


class WindowPlan(NamedTuple):
    """The windows walk's static schedule for one forest: the width, and
    ``(k, steps)`` for each window [k*W, (k+1)*W) that holds an internal
    node, ``steps`` the span of those nodes' depths across the trees."""

    window: int
    steps: tuple


# Elements of the per-window tables ([trees, W, S]) that one chunk of
# trees holds at most; the walk takes the trees in chunks under it.
WINDOW_TABLE_ELEMS = 1 << 24


def window_plan(forest, window):
    """The ``WindowPlan`` of ``forest`` at ``window``, with one host read.

    A sample descends one level a routing step and leaves a window at a
    leaf or at an id past the window; ids grow from parent to child in
    both growers, so the internal nodes a sample passes in a window have
    distinct depths within the window's span, and that many steps route
    every sample resident in it. Extra steps move nobody. Node depths come
    from parent pointers by pointer jumping (log2 of the depth bound
    rounds). Raises inside a CUDA graph capture, where a host read is an
    error: make the plan before the capture (``predict_proba(plans=)``)."""
    feature = forest.feature
    if feature.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the windows walk's plan reads the host: make "
                           "it before the capture (predict_proba(plans=))")
    n_tree, m = feature.shape
    ids = torch.arange(m, device=feature.device).expand(n_tree, m)
    internal = (feature >= 0) & (ids < forest.n_nodes[:, None])
    # Each child's parent; the root and the unused slots point to
    # themselves. Leaves write to a spare column, which is dropped.
    parent = torch.cat([ids, ids[:, :1]], 1).contiguous()
    for child in (forest.left, forest.right):
        parent.scatter_(1, torch.where(internal, child.to(torch.int64), m),
                        ids)
    anc = parent[:, :m].contiguous()
    depth = (anc != ids).to(torch.int64)
    for _ in range(max(1, int(forest.max_depth)).bit_length()):
        depth, anc = depth + depth.gather(1, anc), anc.gather(1, anc)
    n_win = -(-m // window)
    pad = (0, n_win * window - m)
    lo = torch.nn.functional.pad(torch.where(internal, depth, m), pad,
                                 value=m)
    hi = torch.nn.functional.pad(torch.where(internal, depth, -1), pad,
                                 value=-1)
    span = (hi.view(n_tree, n_win, window).amax((0, 2))
            - lo.view(n_tree, n_win, window).amin((0, 2)) + 1)
    steps = span.clamp(min=0).tolist()
    return WindowPlan(window, tuple((k, n) for k, n in enumerate(steps)
                                    if n))


def _walk_windows(forest, x, plan):
    """Each tree's leaf id for each sample, [T, S] int64, by the JAX
    package's windows formulation: for each window of ``plan``, select
    each sample's value of each node's feature (an index select of x, so
    the comparison sees x's exact values, as the JAX walk's matmul under
    ``Precision.HIGHEST`` does), build the next-node table [T, W, S], then
    route the samples resident in the window ``steps`` times. The node
    tables are padded to a whole window with leaf-like entries."""
    n_tree, m = forest.feature.shape
    width = plan.window
    s = x.shape[0]
    pad = (0, -m % width)
    feature = torch.nn.functional.pad(forest.feature, pad, value=-1)
    threshold = torch.nn.functional.pad(forest.threshold, pad)
    left = torch.nn.functional.pad(forest.left, pad, value=-1)
    right = torch.nn.functional.pad(forest.right, pad, value=-1)
    xt = x.T.contiguous()
    chunk = max(1, WINDOW_TABLE_ELEMS // (width * max(s, 1)))
    parts = []
    for t0 in range(0, n_tree, chunk):
        trees_c = slice(t0, t0 + chunk)
        node = torch.zeros((min(chunk, n_tree - t0), s), dtype=torch.int64,
                           device=x.device)
        for k, n_steps in plan.steps:
            win = slice(k * width, (k + 1) * width)
            featw = feature[trees_c, win]
            leafw = featw < 0
            xsel = xt[featw.clamp(min=0)]                       # [Tc, W, S]
            nxtw = torch.where(xsel <= threshold[trees_c, win, None],
                               left[trees_c, win, None],
                               right[trees_c, win, None])
            for _ in range(n_steps):
                rel = node - k * width
                relc = rel.clamp(0, width - 1)
                movable = (rel >= 0) & (rel < width) & \
                    ~leafw.gather(1, relc)
                nxt = nxtw.gather(1, relc[:, None, :])[:, 0]
                node = torch.where(movable, nxt.to(torch.int64), node)
        parts.append(node)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _leaf_probs(forest, x, impl=None, plans=None):
    """Each tree's leaf class distribution for each sample, [T, S, 2],
    through the walk ``predict_impl(impl)`` names. ``plans`` ({width:
    WindowPlan}) keeps the windows walk's plans of this forest across
    calls."""
    if predict_impl(impl) == "gather":
        node = _walk_gather(forest, x)
    else:
        width = predict_window()
        plan = None if plans is None else plans.get(width)
        if plan is None:
            plan = window_plan(forest, width)
            if plans is not None:
                plans[width] = plan
        node = _walk_windows(forest, x, plan)
    v = forest.value.gather(1, node[..., None].expand(-1, -1, 2))
    return v / torch.clamp(v.sum(-1, keepdim=True), min=1e-30)


def _tree_mean(probs):
    """Mean over the tree axis (-3) of [..., T, S, 2] with the bits of the
    JAX package's ``jnp.mean`` on XLA:CPU: the trees summed in XLA's
    windowed order (``preprocess._colsum``), then multiplied by
    float32(1/T), the constant XLA puts in place of ``/ T``."""
    from flake16_framework_tpu_torch.ops.preprocess import _colsum

    n_tree = probs.shape[-3]
    rows = probs.movedim(-3, 0)
    total = _colsum(rows.reshape(n_tree, -1)).view(rows.shape[1:])
    one = torch.ones((), dtype=total.dtype, device=total.device)
    return total * (one / torch.full_like(one, float(n_tree)))


def predict_proba(forest, x, impl=None, plans=None):
    """Mean over trees of the leaf class distributions (sklearn soft
    vote), [S, 2]. ``impl`` names the walk (``predict_impl``; the knobs
    are read at each call). The windows walk makes its plan with one host
    read unless ``plans`` ({width: WindowPlan}, filled here) holds it: a
    caller that captures the walk into a CUDA graph passes the same dict
    to a run before the capture, so that the capture reads nothing."""
    return _tree_mean(_leaf_probs(forest, x, impl, plans))


def predict(forest, x):
    """Binary predict: class 1 iff p1 > p0 (a tie goes to class 0),
    through ``predict_proba``'s walk."""
    p = predict_proba(forest, x)
    return p[:, 1] > p[:, 0]


def predict_batch(forest, x):
    """``predict`` of each fold's forest (a ``Forest`` with [G, T, ...]
    leading axes, as the JAX package's ``predict_batch`` takes it) against
    a shared matrix, the G x T trees traversed as one batch: [G, S] bool,
    row g equal to ``predict`` of fold g's forest. The windows walk plans
    over the whole batch (the widest depth span of each window)."""
    n_fold, n_tree = forest.feature.shape[:2]
    flat = Forest(*(f.reshape(n_fold * n_tree, *f.shape[2:])
                    for f in forest[:-1]), forest.max_depth)
    p = _tree_mean(_leaf_probs(flat, x).view(n_fold, n_tree, x.shape[0], 2))
    return p[..., 1] > p[..., 0]


# Cost attribution (obs/costs.py): the grower and predict entry points,
# under the JAX package's span names. The histogram grower's events carry
# the analytic per-stage flop split (``stage_flops``).


def _fit_hist_cost_fields(args, kwargs):
    n, f = args[0].shape
    max_nodes = kwargs.get("max_nodes") or 2 * n
    edges = kwargs.get("edges")
    n_bins = hist_bins(kwargs.get("n_bins")) if edges is None \
        else edges.shape[-1] + 1
    return {"stage_flops": fit_stage_flops(
        n=n, n_feat=f, n_bins=n_bins, n_trees=kwargs["n_trees"],
        n_nodes=max_nodes, max_nodes=max_nodes,
        device_type=args[0].device.type)}


_FIT_STATIC = ("n_trees", "bootstrap", "random_splits", "sqrt_features",
               "max_depth", "max_nodes", "tree_chunk", "n_bins", "refine",
               "et_draw", "feature_quota")
fit_forest_hist = costs.instrument(fit_forest_hist, "trees.fit_forest_hist",
                                   static_argnames=_FIT_STATIC,
                                   cost_fields=_fit_hist_cost_fields)
fit_forest = costs.instrument(fit_forest, "trees.fit_forest",
                              static_argnames=_FIT_STATIC)
predict_proba = costs.instrument(predict_proba, "trees.predict_proba",
                                 static_argnames=("impl",))
