"""Path-dependent Tree SHAP for one cap bucket of work items: the CUDA
kernel ``csrc/treeshap_unit.cu`` and its plain PyTorch version.

A work item is one root-to-leaf path of one tree in compact form: ``cap``
slots whose live prefix [0, u) holds a unique feature ``fid``, its zero
fraction ``z`` (the product of the path's cover ratios on that feature)
and the interval (lo, hi] the path's splits allow it, plus the leaf's
class-0 probability ``scale``. For each sample the one fraction of a slot
is o = (x[fid] > lo) & (x[fid] <= hi); EXTEND builds the path's
permutation weights over the live slots, UNWIND removes each slot again,
and the slot adds (o - z) * total * scale to phi[fid, sample].

Inputs: fid int32, z/lo/hi f32 [R, cap]; u int32 and scale f32 [R];
x f32 [S, F]. Output: phi [F, S] f32, summed over the R work items (the
caller divides by the tree count).

``unit_shap`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; it never falls back. The kernel divides in
no per-sample loop: ``unit_tables`` holds the coefficients that depend
only on u and a position, and the wrapper passes them with every launch.
"""

import ctypes
import functools
import math

import torch

from flake16_framework_tpu_torch.kernels import build

# Work items a block walks (one chunk; its partial is one slice of the
# [n_chunks, F, S] output that the wrapper sums): at most CHUNK, fewer
# when that would leave the card with under BLOCKS_PER_SM blocks an SM,
# but at least MIN_CHUNK (the kernel stages 8 at a time). Rows sorted by
# u make chunks of unequal cost, so many short chunks balance the SMs:
# on an H100, 64 and 128 ran the cap-16 buckets of the paper configs'
# forests about as fast, and 1024 up to 1.6x slower
# (measure_treeshap_unit.py).
CHUNK = 128
MIN_CHUNK = 32
BLOCKS_PER_SM = 8
TILE = 128         # samples a block (kTile in the kernel)
MAX_CAP = 16       # the kernel's widest register instance
MAX_FEATURES = 16  # rows of its shared-memory accumulator
# Work items of one batch of the plain version: bounds its [rows, cap + 2,
# S] workspaces (about 0.3 GB each at cap 16, S = 4000).
PLAIN_ROWS = 1024


# Rows of ``unit_tables`` (the kernel's kC, kE, kH, kF).
TABLE_C, TABLE_E, TABLE_H, TABLE_F = range(4)


@functools.cache
def unit_tables():
    """The kernel's coefficient tables, f32 [4, MAX_CAP + 1, MAX_CAP + 1]
    on the CPU, indexed [table, u, j] (u = 0 unused, zero where j is out of
    range), each rounded once from float64:
    C[u, j] = (u + 1) / (j + 1) and E[u, j] = (u - j) / (j + 1) for the
    o = 1 unwind, H[u, j] = (u + 1) / (u - j) for the o = 0 sum (j < u),
    and F[u, j] = j! / (u + 1)!, which takes EXTEND's scaled weights back
    to the reference's (j <= u)."""
    n = MAX_CAP + 1
    t = torch.zeros((4, n, n), dtype=torch.float64)
    for u in range(1, n):
        for j in range(u):
            t[TABLE_C, u, j] = (u + 1) / (j + 1)
            t[TABLE_E, u, j] = (u - j) / (j + 1)
            t[TABLE_H, u, j] = (u + 1) / (u - j)
        for j in range(u + 1):
            t[TABLE_F, u, j] = math.factorial(j) / math.factorial(u + 1)
    return t.to(torch.float32)


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


def unit_shap(fid, z, lo, hi, u, scale, x):
    """phi [F, S] f32; see the module docstring. CPU tensors go to
    ``unit_shap_plain``; CUDA tensors launch the kernel (counted in
    ``unit_shap.launches``) or raise."""
    if x.device.type == "cpu":
        return unit_shap_plain(fid, z, lo, hi, u, scale, x)
    if x.device.type != "cuda":
        raise ValueError(f"unit_shap: unsupported device {x.device}")
    r, cap = fid.shape
    s, n_feat = x.shape
    for name, t, dtype, shape in (("fid", fid, torch.int32, (r, cap)),
                                  ("z", z, torch.float32, (r, cap)),
                                  ("lo", lo, torch.float32, (r, cap)),
                                  ("hi", hi, torch.float32, (r, cap)),
                                  ("u", u, torch.int32, (r,)),
                                  ("scale", scale, torch.float32, (r,)),
                                  ("x", x, torch.float32, (s, n_feat))):
        if t.device != x.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"unit_shap: {name} must be a contiguous {dtype} {shape} "
                f"tensor on {x.device}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device} (contiguous={t.is_contiguous()})")
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"unit_shap: cap must be in [1, {MAX_CAP}], "
                         f"got {cap}")
    if not 1 <= n_feat <= MAX_FEATURES:
        raise ValueError(f"unit_shap: at most {MAX_FEATURES} features, "
                         f"got {n_feat}")
    if r == 0 or s == 0:
        raise ValueError(f"unit_shap: empty input ({r} work items, {s} "
                         f"samples)")
    tiles = -(-s // TILE)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunk = min(CHUNK, max(MIN_CHUNK, -(-r * tiles // (BLOCKS_PER_SM * sms))))
    n_chunks = -(-r // chunk)
    if n_chunks > 65535:
        raise ValueError(f"unit_shap: at most {65535 * chunk} work items a "
                         f"launch, got {r}")
    partial = torch.empty((n_chunks, n_feat, s), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(
            unit_tables().data_ptr(), fid.data_ptr(), z.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), u.data_ptr(), scale.data_ptr(),
            x.data_ptr(), partial.data_ptr(),
            r, cap, s, n_feat, chunk, x.device.index,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"treeshap_unit launch failed: CUDA error {err}")
    with build.COUNT_LOCK:
        unit_shap.launches += 1
    return partial.sum(0)


unit_shap.launches = 0


@functools.cache
def _launcher():
    """The C entry point, loaded (and built) once with its signature."""
    fn = build.load("treeshap_unit").treeshap_unit_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
