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
sums the buckets and divides by the tree count. ``forest_shap_graph`` is
the single-bucket engine the scoring service runs: every row at cap =
min(F, depth), dead rows included, in one launch, with no host read, so
its inputs (``graph_inputs``) are prepared once per served model.

The same buckets feed two more explainers, in plain PyTorch as the JAX
package's are XLA code: ``forest_shap_interventional`` (against a
background set, in closed form) and ``forest_shap_interactions`` (SHAP
interaction values, by a second UNWIND for each pair of slots, on the
EXTEND/UNWIND vectors ``extend_all``, ``unwound_sum`` and
``unwind_weights``). Both walk a bucket's rows in chunks whose workspace
stays under ``CHUNK_BYTES``.

The JAX package's ``vmap`` over trees is the tensor's tree axis here, and
its ``lax.scan`` root walk a loop over the depth bound.
"""

import math

import numpy as np
import torch

from flake16_framework_tpu_torch.kernels.treeshap_unit import unit_shap
from flake16_framework_tpu_torch.obs import costs
from flake16_framework_tpu_torch.ops.trees import trim_nodes

# Finite interval sentinels of the compact rows (every real f32 input is
# below 3.4e38), as the JAX package keeps them.
BIG = 3.4e38
# Bound on the live workspace of one row chunk of the interventional and
# interaction explainers (bytes; ``_chunks``).
CHUNK_BYTES = 1 << 30


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


def graph_shap(inputs, n_trees, x):
    """phi [S, F] of the samples x [S, F] (contiguous f32) from
    ``graph_inputs``' rows of a forest of ``n_trees`` trees: one unit
    launch, then the mean over trees."""
    return unit_shap(*inputs, x).T / n_trees


def forest_shap_graph(forest, x, *, sample_chunk=None):
    """phi [S, F]: ``forest_shap_class0``'s values on the single-bucket
    work list (``graph_inputs``), one unit launch per ``sample_chunk``
    samples (all at once by default), as the JAX package's
    ``_xla_forest_shap`` and ``_pallas_graph_shap`` compute them. The
    forest is explained as given (callers trim it)."""
    inputs = graph_inputs(forest, x.shape[1])
    n_trees = forest.feature.shape[0]
    x = x.contiguous()
    if sample_chunk is None or sample_chunk >= x.shape[0]:
        return graph_shap(inputs, n_trees, x)
    return torch.cat([graph_shap(inputs, n_trees, x[a:a + sample_chunk])
                      for a in range(0, x.shape[0], sample_chunk)])


def expected_p0(forest):
    """Base value E[p0] under path-dependent cover weighting, per tree then
    averaged; pairs with ``forest_shap_class0`` for local accuracy:
    phi.sum(1) == p0(x) - E[p0]."""
    _, leaf_ok, leaf_p0, leaf_cover_frac = _leaf_slots(forest)
    return torch.where(leaf_ok, leaf_p0 * leaf_cover_frac, 0.0).sum(1).mean()


# --------------------------------------------------------------------------
# The EXTEND/UNWIND vectors, vectorised over every axis but the positions
# --------------------------------------------------------------------------


def _at(w, idx):
    """``w[..., idx]`` with one position per lane: ``idx`` is an int64
    tensor broadcastable to ``w.shape[:-1]``."""
    return w.gather(-1, idx.expand(w.shape[:-1])[..., None])[..., 0]


def extend_all(present, z, o, n_slots):
    """EXTEND over the ``n_slots`` slots of present (bool), z and o
    [..., n_slots]: the permutation-weight vector w [..., n_slots + 2] and
    the path length l [...] (the dummy element counts one). A slot that is
    not present leaves both unchanged."""
    shape = present.shape[:-1]
    k2 = n_slots + 2
    i = torch.arange(k2, dtype=z.dtype, device=z.device)
    w = torch.zeros((*shape, k2), dtype=z.dtype, device=z.device)
    w[..., 0] = 1.0
    l = torch.ones(shape, dtype=z.dtype, device=z.device)
    for f in range(n_slots):
        zf = z[..., f, None]
        of = o[..., f, None]
        pf = present[..., f]
        ln = l[..., None]
        # Position i keeps z*w[i]*(l-i)/(l+1) and gains o*w[i-1]*i/(l+1).
        stay = zf * w * (ln - i) / (ln + 1.0)
        up = of * torch.cat([torch.zeros_like(w[..., :1]), w[..., :-1]],
                            -1) * i / (ln + 1.0)
        w = torch.where(pf[..., None], stay + up, w)
        l = l + pf.to(l.dtype)
    return w, l


def unwound_sum(w, l, z, o):
    """The sum of the path weights after UNWINDing one feature of
    fractions (z, o): w [..., K2], l the path length broadcastable to
    w's lanes, z and o broadcastable against both; the result takes the
    broadcast shape. Runs the recurrence over positions l-2 .. 0. The
    divisions of the branch a lane does not take (by o = 0, or by
    z * (l - 1 - j) = 0 past the path) are dropped by selects."""
    k2 = w.shape[-1]
    lm1 = l - 1.0
    nxt = _at(w, lm1.long().clamp(0, k2 - 1))
    total = torch.zeros_like(nxt)
    o_safe = torch.where(o == 0, 1.0, o)
    for j in range(k2 - 2, -1, -1):
        active = (j <= lm1 - 1.0) & (lm1 > 0)
        wj = w[..., j]
        tmp = nxt * l / ((j + 1.0) * o_safe)
        total_o = total + tmp
        nxt_o = wj - tmp * z * (lm1 - j) / l
        total_z = total + wj * l / (z * (lm1 - j))
        total = torch.where(active, torch.where(o == 0, total_z, total_o),
                            total)
        nxt = torch.where(active, torch.where(o == 0, nxt, nxt_o), nxt)
    return total


def unwind_weights(w, l, z, o):
    """The full UNWIND: the weight vector with one feature of fractions
    (z, o) removed, [*lanes, K2] with positions [0, l - 2) set (a path of
    length l - 1) and zeros elsewhere; shapes as ``unwound_sum``, whose
    value is this vector's sum. The interaction values UNWIND it once
    more for the partner feature."""
    k2 = w.shape[-1]
    lm1 = l - 1.0
    n = _at(w, lm1.long().clamp(0, k2 - 1))
    lanes = torch.broadcast_shapes(n.shape, z.shape, o.shape)
    m = torch.zeros((*lanes, k2), dtype=w.dtype, device=w.device)
    o_safe = torch.where(o == 0, 1.0, o)
    z_safe = torch.clamp(z, min=1e-30)
    for j in range(k2 - 2, -1, -1):
        active = (j <= lm1 - 1.0) & (lm1 > 0)
        wj = w[..., j]
        mj_o = n * l / ((j + 1.0) * o_safe)
        n_new = wj - mj_o * z * (lm1 - j) / l
        mj_z = wj * l / (z_safe * (lm1 - j))
        m[..., j] = torch.where(active, torch.where(o == 0, mj_z, mj_o), 0.0)
        n = torch.where(active & (o != 0), n_new, n)
    return m


def _chunks(args, row_bytes, rows=None):
    """A bucket's row tensors in chunks of ``rows`` rows; by default as
    many as keep ``row_bytes`` a row under ``CHUNK_BYTES`` (at least
    one)."""
    step = rows or max(1, CHUNK_BYTES // row_bytes)
    for a in range(0, args[0].shape[0], step):
        yield tuple(t[a:a + step] for t in args)


def _slot_features(fid, live, n_features):
    """The one-hot [R, K, F] f32 of each live slot's feature."""
    feats = torch.arange(n_features, device=fid.device)
    return ((fid.long()[..., None] == feats) & live[..., None]).to(
        torch.float32)


def _one_fractions(fid, lo, hi, live, pts):
    """o [R, N, K] f32: whether each point of ``pts`` [N, F] lies in each
    live slot's interval (lo, hi]."""
    g = pts.T[fid.long()]                                     # [R, K, N]
    o = (g > lo[..., None]) & (g <= hi[..., None])
    return (o & live[..., None]).transpose(1, 2).to(torch.float32)


# --------------------------------------------------------------------------
# Interventional SHAP (feature_perturbation='interventional')
# --------------------------------------------------------------------------
#
# For a (path, x, b) triple the path's live slots split into those both
# points satisfy (they cancel out of the Shapley sum), those neither does
# (the leaf is out of reach for every coalition: no term), the p that only
# x satisfies and the q that only b does. Each x-only slot gains
# scale * (p-1)! q! / (p+q)!, each b-only slot loses scale * p! (q-1)!
# / (p+q)!, averaged over the background.


def interventional_tables(n_features):
    """The closed form's weights, f32 [F + 1, F + 1] each, indexed
    [p, q]: wx = (p-1)! q! / (p+q)! for p >= 1 and wb = p! (q-1)! / (p+q)!
    for q >= 1 (p + q <= F, else 0). Each is a correctly rounded float64
    quotient of exact factorials, rounded once to f32, as the JAX package
    builds them."""
    f = [math.factorial(i) for i in range(n_features + 1)]
    wx = np.zeros((n_features + 1, n_features + 1))
    wb = np.zeros((n_features + 1, n_features + 1))
    for pp in range(n_features + 1):
        for qq in range(n_features + 1 - pp):
            if pp >= 1:
                wx[pp, qq] = f[pp - 1] * f[qq] / f[pp + qq]
            if qq >= 1:
                wb[pp, qq] = f[pp] * f[qq - 1] / f[pp + qq]
    return (torch.from_numpy(wx).to(torch.float32),
            torch.from_numpy(wb).to(torch.float32))


def _interventional_rows(fid, lo, hi, u, scale, x, background, wx, wb):
    """phi [S, F] of one chunk of rows, summed over rows and background
    points (the caller divides by B and T). The counts are whole numbers,
    exact in f32; ox * tx - nx * tb has 0/1 factors, so it is exact
    whether or not it is contracted into a fused multiply-add."""
    k = fid.shape[1]
    n_feat = x.shape[1]
    live = torch.arange(k, device=x.device)[None, :] < u[:, None]   # [R, K]
    livef = live[:, None, :].to(torch.float32)
    ox = _one_fractions(fid, lo, hi, live, x)                       # [R, S, K]
    ob = _one_fractions(fid, lo, hi, live, background)              # [R, B, K]
    nx = livef - ox                         # live but x-unsatisfied
    nb = livef - ob
    pcnt = torch.einsum("rsk,rbk->rsb", ox, nb)                     # x only
    qcnt = torch.einsum("rsk,rbk->rsb", nx, ob)                     # b only
    ncnt = torch.einsum("rsk,rbk->rsb", nx, nb)                     # neither
    ok = (ncnt < 0.5).to(torch.float32) * scale[:, None, None]
    idx = pcnt.long() * (n_feat + 1) + qcnt.long()
    a_w = wx.reshape(-1)[idx] * ok                                  # [R, S, B]
    b_w = wb.reshape(-1)[idx] * ok
    tx = torch.einsum("rbk,rsb->rsk", nb, a_w)
    tb = torch.einsum("rbk,rsb->rsk", ob, b_w)
    phi_slots = ox * tx - nx * tb                                   # [R, S, K]
    return torch.einsum("rsk,rkf->sf", phi_slots,
                        _slot_features(fid, live, n_feat))


def forest_shap_interventional(forest, x, background, *, rows=None):
    """Interventional SHAP of the class-0 soft-vote probability against a
    background set: phi [S, F] f32 with phi.sum(1) = p0(x) - mean_b p0(b).
    x [S, F] and background [B, F] f32. Runs on the cap buckets of
    ``bucket_inputs`` (rows with u = 0 or no real leaf add exact zeros and
    are left out), ``rows`` rows a chunk (default: ``CHUNK_BYTES``)."""
    s, n_feat = x.shape
    b = background.shape[0]
    wx, wb = (t.to(x.device) for t in interventional_tables(n_feat))
    phi = torch.zeros((s, n_feat), dtype=torch.float32, device=x.device)
    for cap, args in bucket_inputs(forest, n_feat):
        row_bytes = 4 * (10 * s * b + 6 * s * cap + 4 * b * cap)
        for fid, _, lo, hi, u, scale in _chunks(args, row_bytes, rows):
            phi = phi + _interventional_rows(fid, lo, hi, u, scale, x,
                                             background, wx, wb)
    return phi / (b * forest.feature.shape[0])


# --------------------------------------------------------------------------
# SHAP interaction values
# --------------------------------------------------------------------------


def _interaction_rows(fid, z, lo, hi, u, scale, x):
    """(phi [S, F], off [S, F, F]) of one chunk of rows, summed over the
    rows (the caller divides by T): the path-dependent values and the
    off-diagonal interactions, for every slot and every pair of slots at
    once. Slot-major [K, R, S] and pair-major [Kj, Ki, R, S] tensors
    stand for the JAX package's ``vmap``s over slots and pairs."""
    k = fid.shape[1]
    n_feat = x.shape[1]
    live = torch.arange(k, device=x.device)[None, :] < u[:, None]   # [R, K]
    o = _one_fractions(fid, lo, hi, live, x)                        # [R, S, K]
    zb = z[:, None, :].expand_as(o)
    w, l = extend_all(live[:, None, :].expand_as(o), zb, o, k)
    zk = zb.permute(2, 0, 1)                                        # [K, R, S]
    ok = o.permute(2, 0, 1)
    totals = unwound_sum(w, l, zk, ok)                              # [K, R, S]
    phi_slots = torch.where(
        live[:, None, :],
        (o - zb) * totals.permute(1, 2, 0) * scale[:, None, None], 0.0)
    onehot = _slot_features(fid, live, n_feat)                      # [R, K, F]
    phi = torch.einsum("rsk,rkf->sf", phi_slots, onehot)

    # Pair (j, i): condition slot j present against absent, then the
    # unwound sum for slot i on the j-removed weights (length l - 1).
    mj = unwind_weights(w, l, zk, ok)                               # [K, R, S, K2]
    tot = unwound_sum(mj[:, None], l - 1.0, zk[None], ok[None])     # [Kj, Ki, R, S]
    oz = ok - zk
    val = 0.5 * oz[:, None] * oz[None] * tot * scale[:, None]
    pair = (live.T[:, None] & live.T[None]
            & ~torch.eye(k, dtype=torch.bool, device=x.device)[..., None])
    pv = torch.where(pair[..., None], val, 0.0)
    return phi, torch.einsum("jirs,rjf,rig->sfg", pv, onehot, onehot)


def forest_shap_interactions(forest, x, *, rows=None):
    """SHAP interaction values of the class-0 soft-vote probability,
    [S, F, F] f32 for x [S, F]: exactly symmetric (0.5 * (off + off^T)),
    with the diagonal phi - off.sum(2), so each row sums to the
    path-dependent phi and the matrix to p0(x) - E[p0]. Runs on the cap
    buckets of ``bucket_inputs`` (left-out rows add exact zeros),
    ``rows`` rows a chunk (default: ``CHUNK_BYTES``)."""
    s, n_feat = x.shape
    phi = torch.zeros((s, n_feat), dtype=torch.float32, device=x.device)
    off = torch.zeros((s, n_feat, n_feat), dtype=torch.float32,
                      device=x.device)
    for cap, args in bucket_inputs(forest, n_feat):
        row_bytes = 4 * s * (cap * (cap + 2) + 12 * cap * cap
                             + 2 * cap * n_feat)
        for chunk in _chunks(args, row_bytes, rows):
            p, q = _interaction_rows(*chunk, x)
            phi = phi + p
            off = off + q
    n_tree = forest.feature.shape[0]
    phi = phi / n_tree
    off = off / n_tree
    off = 0.5 * (off + off.transpose(1, 2))
    # off + diag * eye has a 0/1 factor: exact with or without a fused
    # multiply-add.
    diag = phi - off.sum(2)
    return off + diag[..., None] * torch.eye(n_feat, device=x.device)


# Cost attribution (obs/costs.py): the explain entry points, under the JAX
# package's span names. ``shap.unit_pallas`` is the unit (K2 is the port of
# the JAX package's Pallas unit kernel), ``shap.pallas_graph`` the
# single-bucket program.
compact_paths = costs.instrument(compact_paths, "shap.compact",
                                 static_argnames=("depth", "n_features"))
unit_shap = costs.instrument(unit_shap, "shap.unit_pallas")
graph_shap = costs.instrument(graph_shap, "shap.pallas_graph")
forest_shap_interventional = costs.instrument(
    forest_shap_interventional, "shap.interventional",
    static_argnames=("rows",))
forest_shap_interactions = costs.instrument(
    forest_shap_interactions, "shap.interactions", static_argnames=("rows",))
