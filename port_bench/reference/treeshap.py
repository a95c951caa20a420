"""Path-dependent Tree SHAP of the class-0 soft vote, the reference the
serving cells' SHAP answers are judged against: the benchmark's frozen
copy of the port's work-item decomposition (``ops/treeshap.py``:
``extract_paths``, ``compact_paths``, ``graph_inputs``) and of the plain
unit math (``kernels/treeshap_unit.py``: ``unit_shap_plain``), with no
kernel. ``forest_shap`` is what the serving store's SHAP graph computes:
phi [S, F] = the unit's sum over every (tree, leaf slot) row, over the
tree count."""

import torch

# Finite interval sentinels of the compact rows.
BIG = 3.4e38
# Work items of one batch of the plain unit.
PLAIN_ROWS = 1024


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


def graph_inputs(forest, n_features):
    """The single-bucket work list (the JAX package's
    ``_graph_forest_shap`` layout): every (tree, leaf slot) row of
    ``compact_paths``, cut to cap = min(F, depth), as contiguous unit
    inputs (fid, z, lo, hi, u, scale) on the forest's device. Rows that
    are not ``valid`` get u = 0 and scale = 0, which the unit passes over.
    No host read and no packing: the rows depend only on the forest's
    shapes, so a served model prepares them once. They are sorted by u
    (stable, on the device), so that each chunk of the kernel holds one u,
    or a few."""
    depth = int(forest.max_depth)
    cap = int(min(n_features, depth))
    comp = compact_paths(forest, depth, n_features)
    u = torch.where(comp["valid"], comp["u"], 0)
    scale = torch.where(comp["valid"], comp["scale"], 0.0)
    order = torch.sort(u, stable=True).indices
    return tuple(t[order].contiguous() for t in (
        comp["fid"][:, :cap], comp["z"][:, :cap], comp["lo"][:, :cap],
        comp["hi"][:, :cap], u, scale))


def unit_shap_plain(fid, z, lo, hi, u, scale, x):
    """The plain version: the JAX package's ``_unit_block_math`` over
    [rows, cap, S] batches of at most PLAIN_ROWS work items, summed in row
    order. Returns phi [F, S]."""
    rows = (fid, z, lo, hi, u, scale)
    phi = _plain_rows(*(t[:PLAIN_ROWS] for t in rows), x)
    for a in range(PLAIN_ROWS, fid.shape[0], PLAIN_ROWS):
        phi = phi + _plain_rows(*(t[a:a + PLAIN_ROWS] for t in rows), x)
    return phi


def _plain_rows(fid, z, lo, hi, u, scale, x):
    """``_unit_block_math`` over one [R, cap, S] batch, with the same
    expressions, the same 1e-30 clamp on z in UNWIND, the same o == 0
    branch and the same ``live & (l > 1)`` mask. Returns phi [F, S]."""
    r, cap = fid.shape
    s, n_feat = x.shape
    c2 = cap + 2
    dev = x.device
    f32 = torch.float32
    uf = u.to(f32)
    live = (torch.arange(cap, device=dev, dtype=f32)[None, :]
            < uf[:, None])[..., None]                          # [R, cap, 1]
    x_sel = x.T[fid.long().clamp(0, n_feat - 1)]               # [R, cap, S]
    o = ((x_sel > lo[..., None]) & (x_sel <= hi[..., None])).to(f32)
    iota_i = torch.arange(c2, device=dev, dtype=f32)[None, :, None]

    # EXTEND over the cap slots (live slots are the prefix [0, u)).
    w = torch.zeros((r, c2, s), dtype=f32, device=dev)
    w[:, 0] = 1.0
    l = torch.ones((r, 1, 1), dtype=f32, device=dev)
    for k in range(cap):
        pf = (k < uf)[:, None, None]
        zf = z[:, k, None, None]
        of = o[:, k, None, :]
        stay = zf * w * (l - iota_i) / (l + 1.0)
        w_shift = torch.cat([torch.zeros_like(w[:, :1]), w[:, :-1]], 1)
        up = of * w_shift * iota_i / (l + 1.0)
        w = torch.where(pf, stay + up, w)
        l = torch.where(pf, l + 1.0, l)

    # UNWIND every slot at once, positions high to low.
    nxt = w.gather(1, (l - 1.0).long().expand(r, 1, s)).expand(r, cap, s)
    z_sf = torch.clamp(z, min=1e-30)[..., None]                # [R, cap, 1]
    o_safe = torch.where(o == 0, 1.0, o)
    total = torch.zeros((r, cap, s), dtype=f32, device=dev)
    for jj in range(c2 - 1):
        j = float(c2 - 2 - jj)
        activ = j <= l - 2.0
        wj = w[:, int(j), None, :]
        tmp = nxt * l / ((j + 1.0) * o_safe)
        total_o = total + tmp
        nxt_o = wj - tmp * z_sf * (l - 1.0 - j) / l
        total_z = total + wj * l / (z_sf * (l - 1.0 - j))
        tot_new = torch.where(o == 0, total_z, total_o)
        nxt_new = torch.where(o == 0, nxt, nxt_o)
        total = torch.where(activ, tot_new, total)
        nxt = torch.where(activ, nxt_new, nxt)

    contrib = torch.where(live & (l > 1.0),
                          (o - z[..., None]) * total * scale[:, None, None],
                          0.0)                                 # [R, cap, S]
    # Slots -> features: each (f, s) cell gets at most one nonzero term per
    # work item (fids are unique on a path).
    onehot = ((fid.long()[..., None] == torch.arange(n_feat, device=dev))
              & live).to(f32)                                  # [R, cap, F]
    return torch.einsum("rkf,rks->fs", onehot, contrib)


def forest_shap(forest, x):
    """phi [S, F] f32 of the samples x [S, F] (transformed coordinates)."""
    rows = graph_inputs(forest, x.shape[1])
    return unit_shap_plain(*rows, x.contiguous()).T / forest.feature.shape[0]
