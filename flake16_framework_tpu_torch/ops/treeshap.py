"""Path-dependent Tree SHAP of the class-0 soft-vote probability (what
``shap.TreeExplainer(forest).shap_values(X)[0]`` returns for a sklearn
forest), on the GPUTreeShap work-item decomposition (arXiv 2010.13972).

The forest is flattened into one work list of root-to-leaf paths
(``compact_paths``): a path's repeated features merge into one slot each,
holding the product z of their cover ratios and one interval (lo, hi], so
a path is a row of u <= min(F, depth) live slots. The rows are packed by u
into buckets of cap = the next power of two (``pack_work_items``), and each
bucket is one launch of the unit (``kernels.treeshap_unit``), which runs
EXTEND and UNWIND for every (path, sample) pair. ``forest_shap_class0``
sums the buckets and divides by the tree count.

The JAX package's ``vmap`` over trees is the tensor's tree axis here, and
its ``lax.scan`` root walk a loop over the depth bound.
"""

import numpy as np
import torch

from flake16_framework_tpu_torch.kernels.treeshap_unit import unit_shap
from flake16_framework_tpu_torch.ops.trees import trim_nodes

# Finite interval sentinels of the compact rows (every real f32 input is
# below 3.4e38), as the JAX package keeps them.
BIG = 3.4e38


def _leaf_slots(forest):
    """Per tree, the first M//2+1 node ids with real leaves first (stable),
    and each slot's leaf flag, class-0 probability and cover fraction.
    Returns (leaf_ids [T, L] int64, leaf_ok, leaf_p0, leaf_cover_frac)."""
    m = forest.feature.shape[1]
    cover = forest.value.sum(-1)                               # [T, M]
    is_leaf = (forest.feature < 0) & (cover > 0)
    leaf_ids = torch.sort((~is_leaf).to(torch.uint8), dim=1,
                          stable=True).indices[:, :m // 2 + 1]
    leaf_val = forest.value.gather(
        1, leaf_ids[..., None].expand(-1, -1, 2))              # [T, L, 2]
    leaf_cover = cover.gather(1, leaf_ids)
    leaf_p0 = leaf_val[..., 0] / torch.clamp(leaf_val.sum(-1), min=1e-30)
    root_cover = torch.clamp(cover[:, :1], min=1e-30)
    return (leaf_ids, is_leaf.gather(1, leaf_ids), leaf_p0,
            leaf_cover / root_cover)


def extract_paths(forest, depth):
    """Forest [T, M] -> per-leaf-slot root-path steps, [T, L, D] each
    (L = M//2+1 leaf slots, D = ``depth``), ordered leaf -> root: ``sf``
    split feature of the ancestor, ``sthr`` its threshold, ``sratio``
    cover(child)/cover(ancestor), ``sleft`` whether the path goes left,
    ``svalid`` whether the step exists. Plus the [T, L] leaf fields of
    ``_leaf_slots``."""
    n_tree, m = forest.feature.shape
    dev = forest.feature.device
    cover = forest.value.sum(-1)
    feature = forest.feature.long()
    left = forest.left.long()
    right = forest.right.long()
    idx = torch.arange(m, device=dev).expand(n_tree, -1)
    parent = torch.full((n_tree, m + 1), -1, dtype=torch.int64, device=dev)
    for child in (left, right):            # index m collects the non-children
        parent.scatter_(1, torch.where(child >= 0, child, m),
                        torch.where(child >= 0, idx, -1))
    parent = parent[:, :m]

    leaf_ids, leaf_ok, leaf_p0, leaf_cover_frac = _leaf_slots(forest)
    node = leaf_ids
    steps = []
    for _ in range(depth):
        p = parent.gather(1, node)
        ok = p >= 0
        psafe = torch.clamp(p, min=0)
        steps.append((
            torch.where(ok, feature.gather(1, psafe), 0).to(torch.int32),
            torch.where(ok, forest.threshold.gather(1, psafe), 0.0),
            torch.where(ok, cover.gather(1, node)
                        / torch.clamp(cover.gather(1, psafe), min=1e-30),
                        1.0),
            ok & (left.gather(1, psafe) == node),
            ok))
        node = torch.where(ok, psafe, node)
    sf, sthr, sratio, sleft, svalid = (torch.stack(a, -1) for a in zip(*steps))
    return {"sf": sf, "sthr": sthr, "sratio": sratio, "sleft": sleft,
            "svalid": svalid, "leaf_p0": leaf_p0, "leaf_ok": leaf_ok,
            "leaf_cover_frac": leaf_cover_frac}


def compact_paths(forest, depth, n_features):
    """Flatten the forest into the work list: one row per (tree, leaf
    slot), P = T * L rows, tree-major. Returns a dict of [P, F] / [P]:
    ``fid`` int32 feature per slot, present ones first (stable);
    ``z`` f32 merged zero fraction; ``lo``, ``hi`` f32 the merged interval,
    o = (x > lo) & (x <= hi); ``u`` int32 the live count (slots [0, u));
    ``scale`` f32 the leaf's p0 on real leaves, else 0; ``valid`` bool
    real leaf with u > 0.

    The JAX package reduces [T, L, D, F] one-hots over D; here the D axis
    is a loop (product of z, min of hi, max of lo, OR of present), so only
    [T, L, F] is live. The loop multiplies z in step order, so z may
    differ from a product taken in another order by an ulp; min, max and
    the stable sort are exact."""
    paths = extract_paths(forest, depth)
    n_tree, n_slot = paths["leaf_ok"].shape
    dev = forest.feature.device
    feats = torch.arange(n_features, device=dev)
    shape = (n_tree, n_slot, n_features)
    present = torch.zeros(shape, dtype=torch.bool, device=dev)
    z = torch.ones(shape, dtype=torch.float32, device=dev)
    # Left steps bound from above (x <= thr), right steps from below.
    hi = torch.full(shape, BIG, dtype=torch.float32, device=dev)
    lo = torch.full(shape, -BIG, dtype=torch.float32, device=dev)
    for d in range(depth):
        oh = ((paths["sf"][..., d, None] == feats)
              & paths["svalid"][..., d, None])
        present |= oh
        z = z * torch.where(oh, paths["sratio"][..., d, None], 1.0)
        thr = paths["sthr"][..., d, None]
        go_left = paths["sleft"][..., d, None]
        hi = torch.where(oh & go_left, torch.minimum(hi, thr), hi)
        lo = torch.where(oh & ~go_left, torch.maximum(lo, thr), lo)

    u = present.sum(-1).to(torch.int32)                       # [T, L]
    order = torch.sort((~present).to(torch.uint8), dim=-1,
                       stable=True).indices                   # present first
    scale = torch.where(paths["leaf_ok"], paths["leaf_p0"], 0.0)
    return {
        "fid": order.to(torch.int32).reshape(-1, n_features),
        "z": z.gather(-1, order).reshape(-1, n_features),
        "lo": lo.gather(-1, order).reshape(-1, n_features),
        "hi": hi.gather(-1, order).reshape(-1, n_features),
        "u": u.reshape(-1), "scale": scale.reshape(-1),
        "valid": (paths["leaf_ok"] & (u > 0)).reshape(-1),
    }


def pack_work_items(u, valid, *, n_features, depth):
    """Host bin packing (numpy): rows -> [(cap, row_ids), ...]. A kept row
    (``valid`` and u > 0) goes to the bucket whose cap is the next power of
    two >= u, clamped to min(F, depth), so that top cap need not be a power
    of two (7 for FlakeFlagger's 7 features)."""
    u = np.asarray(u)
    keep = np.asarray(valid) & (u > 0)
    cap_max = int(min(n_features, depth))
    caps = np.minimum(
        np.power(2, np.ceil(np.log2(np.maximum(u, 1)))).astype(np.int64),
        cap_max)
    return [(int(cap), np.nonzero(keep & (caps == cap))[0])
            for cap in sorted(set(caps[keep].tolist()))]


def bucket_inputs(forest, n_features):
    """The forest's work items as unit inputs, one entry per occupied cap
    bucket: [(cap, (fid, z, lo, hi, u, scale))], contiguous row tensors on
    the forest's device. Trims the node axis first, as the JAX package
    does (one host read of max(n_nodes), rounded up to 128). Within a
    bucket the rows are sorted by u (stable), so that each chunk of the
    unit's kernel holds one u, or a few."""
    m = forest.feature.shape[-1]
    n_used = int(forest.n_nodes.max())
    m_trim = min(m, max(128, -(-n_used // 128) * 128))
    if m_trim < m:
        forest = trim_nodes(forest, m_trim)
    depth = int(forest.max_depth)
    comp = compact_paths(forest, depth, n_features)
    u = comp["u"].cpu().numpy()
    plan = pack_work_items(u, comp["valid"].cpu().numpy(),
                           n_features=n_features, depth=depth)
    out = []
    for cap, rows in plan:
        rows = rows[np.argsort(u[rows], kind="stable")]
        idx = torch.from_numpy(rows).to(forest.feature.device)
        out.append((cap, tuple(
            comp[k][idx, :cap].contiguous() if comp[k].dim() == 2
            else comp[k][idx].contiguous()
            for k in ("fid", "z", "lo", "hi", "u", "scale"))))
    return out


def forest_shap_class0(forest, x):
    """phi [S, F]: the mean over trees of each tree's class-0 Tree SHAP
    values of the samples x [S, F] f32. One unit launch per occupied cap
    bucket."""
    s, n_features = x.shape
    phi = torch.zeros((n_features, s), dtype=torch.float32, device=x.device)
    for _, args in bucket_inputs(forest, n_features):
        phi = phi + unit_shap(*args, x)
    return phi.T / forest.feature.shape[0]


def expected_p0(forest):
    """Base value E[p0] under path-dependent cover weighting, per tree then
    averaged; pairs with ``forest_shap_class0`` for local accuracy:
    phi.sum(1) == p0(x) - E[p0]."""
    _, leaf_ok, leaf_p0, leaf_cover_frac = _leaf_slots(forest)
    return torch.where(leaf_ok, leaf_p0 * leaf_cover_frac, 0.0).sum(1).mean()
