"""The cumulative class histograms of one BFS step of the tree grower:
the CUDA kernel ``csrc/hist_cumsum.cu`` and its plain PyTorch version.

For each tree t, feature f, window node w and bin b::

    cw[t, f, w, b]  = sum_{b' <= b} sum_n [rel[t,n] == w] w[t,n] [bin[g,f,n] == b']
    cwy[t, f, w, b] = the same with wy

``rel`` [T, N] int32 is each sample's node id relative to the window start
(outside [0, W) means "not in the window"), ``w``/``wy`` [T, N] f32 the
per-tree weights and weights times label, ``bin_t`` [G, F, N] uint8 the
bin indices (each below B) of G groups, feature-major so a feature's bins
are contiguous. Tree t reads group g = t // (T / G): the grower batches
the trees of G folds, each fold with its own samples. A [F, N] ``bin_t``
is one group. Outputs are f32 [T, F, W, B] x 2. The kernel counts whole
weights as integers and is bitwise equal to the plain version wherever the
f32 sums are exact (whole weights whose per-node sums stay below 2^24, as
the grower's are).

``cum_hists`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; it never falls back.
"""

import ctypes
import functools

import torch

from flake16_framework_tpu_torch.kernels import build

# Shared memory a block may use on Hopper (bytes).
_SMEM_LIMIT = 232448

# Features a tile, as compiled into the kernel (kGroup): a block's pass
# over a tree's samples feeds this many histograms.
GROUP = 4


def smem_bytes(n_nodes, n_bins):
    """Dynamic shared memory of a block (``csrc/hist_cumsum.cu``): the
    [GROUP, W, B] 32-bit cells, W row marks rounded up to 16 bytes, and two
    32-bit totals padded to 16 bytes."""
    return GROUP * n_nodes * n_bins * 4 + (n_nodes + 15) // 16 * 16 + 16


def max_window(n_bins):
    """The widest window (nodes) whose histogram fits a block's shared
    memory at ``n_bins`` bins: the bound on the grower's window width."""
    n_nodes = _SMEM_LIMIT // (GROUP * n_bins * 4)
    while n_nodes > 0 and smem_bytes(n_nodes, n_bins) > _SMEM_LIMIT:
        n_nodes -= 1
    return n_nodes


def _groups(bin_t):
    """``bin_t`` as [G, F, N] (a [F, N] tensor is one group)."""
    return bin_t[None] if bin_t.dim() == 2 else bin_t


def check_inputs(rel, w, wy, bin_t, n_nodes, n_bins):
    """Raise ValueError for inputs the kernel cannot take: wrong types or
    shapes, a tree count that the groups of ``bin_t`` do not divide, other
    devices, non-contiguous tensors, rel/w/wy not 16-byte aligned (the
    kernel reads them four samples at a time), bins outside [1, 256], a
    window whose histogram exceeds shared memory, or more tiles than a
    grid holds."""
    n_tree, n = rel.shape
    if bin_t.dim() not in (2, 3):
        raise ValueError(f"cum_hists: bin_t must be [F, N] or [G, F, N], "
                         f"got {tuple(bin_t.shape)}")
    n_group, n_feat = _groups(bin_t).shape[:2]
    if n_group < 1 or n_tree % n_group:
        raise ValueError(f"cum_hists: {n_tree} trees do not split into "
                         f"{n_group} groups")
    for name, t, dtype, shape in (("rel", rel, torch.int32, (n_tree, n)),
                                  ("w", w, torch.float32, (n_tree, n)),
                                  ("wy", wy, torch.float32, (n_tree, n)),
                                  ("bin_t", bin_t, torch.uint8,
                                   tuple(bin_t.shape[:-1]) + (n,))):
        if t.device != rel.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"cum_hists: {name} must be a contiguous {dtype} {shape} "
                f"tensor on {rel.device}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device} (contiguous={t.is_contiguous()})")
        if name != "bin_t" and t.data_ptr() % 16:
            raise ValueError(f"cum_hists: {name} must start on a 16-byte "
                             f"boundary")
    if not 1 <= n_bins <= 256:
        raise ValueError(f"cum_hists: n_bins must be in [1, 256], got {n_bins}")
    if n_nodes < 1 or smem_bytes(n_nodes, n_bins) > _SMEM_LIMIT:
        raise ValueError(f"cum_hists: a {n_nodes} x {n_bins} window of "
                         f"{GROUP} features exceeds shared memory")
    if n_tree * -(-n_feat // GROUP) >= 2 ** 31:
        raise ValueError(f"cum_hists: {n_tree} trees x {n_feat} features "
                         f"are more tiles than a grid holds")


def cum_hists_plain(rel, w, wy, bin_t, n_nodes, n_bins):
    """The plain version: one-hots contracted over samples in f32
    (``torch.einsum`` on bf16 would return bf16 and round counts above
    256), each group's trees against its bins, then a cumsum over bins."""
    bins = _groups(bin_t)
    n_group = bins.shape[0]
    n_tree, n = rel.shape
    rel = rel.to(torch.int64)
    iota = torch.arange(n_nodes, device=rel.device)
    member = (rel[..., None] == iota).to(w.dtype)               # [T, N, W]
    ohfb = torch.nn.functional.one_hot(bins.to(torch.int64),
                                       n_bins).to(w.dtype)   # [G, F, N, B]

    def contract(weights):
        ohw = (member * weights[..., None]).view(n_group, -1, n, n_nodes)
        return torch.einsum("gtnw,gfnb->gtfwb", ohw, ohfb).reshape(
            n_tree, -1, n_nodes, n_bins)

    return torch.cumsum(contract(w), -1), torch.cumsum(contract(wy), -1)


def cum_hists(rel, w, wy, bin_t, n_nodes, n_bins):
    """(cw, cwy) [T, F, W, B] f32; see the module docstring. CPU tensors
    go to ``cum_hists_plain``; CUDA tensors launch the kernel (counted in
    ``cum_hists.launches``) or raise."""
    if rel.device.type == "cpu":
        return cum_hists_plain(rel, w, wy, bin_t, n_nodes, n_bins)
    if rel.device.type != "cuda":
        raise ValueError(f"cum_hists: unsupported device {rel.device}")
    check_inputs(rel, w, wy, bin_t, n_nodes, n_bins)
    n_tree, n = rel.shape
    n_group, n_feat = _groups(bin_t).shape[:2]
    out = torch.empty((2, n_tree, n_feat, n_nodes, n_bins),
                      dtype=torch.float32, device=rel.device)
    cw, cwy = out[0], out[1]
    err = _launcher()(
        rel.data_ptr(), w.data_ptr(), wy.data_ptr(), bin_t.data_ptr(),
        cw.data_ptr(), cwy.data_ptr(), n_tree, n, n_feat, n_nodes, n_bins,
        n_tree // n_group, rel.device.index,
        torch.cuda.current_stream(rel.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hist_cumsum launch failed: CUDA error {err}")
    with build.COUNT_LOCK:
        cum_hists.launches += 1
    return cw, cwy


cum_hists.launches = 0


@functools.cache
def _launcher():
    """The C entry point, loaded (and built) once with its signature."""
    fn = build.load("hist_cumsum").hist_cumsum_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def occupancy(n_nodes, n_bins):
    """(resident blocks per SM, SM count) of the kernel at this window on
    the current CUDA device, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    fn = build.load("hist_cumsum").hist_cumsum_occupancy
    fn.restype = ctypes.c_int
    blocks, n_sm = ctypes.c_int(), ctypes.c_int()
    err = fn(n_nodes, n_bins, torch.cuda.current_device(),
             ctypes.byref(blocks), ctypes.byref(n_sm))
    if err != 0:
        raise RuntimeError(f"hist_cumsum occupancy query failed: CUDA error "
                           f"{err}")
    return blocks.value, n_sm.value
