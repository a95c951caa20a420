"""The plan executor's memory envelope: an upper bound on the device bytes
that one plan of ``scores planner`` holds at once, from the plan's shape
alone. The sweep's budget pre-flight (``sweep._preflight_plan_budget``)
holds it against ``F16_DEVICE_BUDGET_MB`` before any plan dispatches.

The JAX package traces each plan abstractly and walks the buffers'
liveness. The port cannot: its growers are host loops that read the
device once a step or a level, which stops ``torch.export``, FakeTensor
and the meta device, and a recorded run at the real shape would be the
run itself. So this module is a law over the tensors the executor
allocates, read from the code (``parallel/sweep.py``, ``ops/``), and it
imports no torch.

**One member decides a plan's peak.** ``SweepEngine.run_plan`` runs a
plan's members one after another, and a family's members share one
static shape (``cap = 2N``, ``max_nodes = 2 cap``, ``Plan.shape``), so a
plan's peak is its largest member's peak over what the engine keeps
resident across members (``arg_bytes``: the features, labels, project
ids and fold masks). Only the balancing changes a member's transients,
through the kNN workspace, so the largest over the members' balancings
is taken. Across a device list each card runs its shard's members one
after another, so a card's peak is its largest member's too.

**A member's peak** is the largest of its phases' peaks. Each phase
holds what the code still references and, at its worst statement, that
statement's own temporaries (``_Live``). PyTorch frees a tensor when its
last reference drops, so a statement's temporaries die with it, and a
variable keeps its storage until it is bound again. In a loop (a BFS step
of the hist grower, a level of the exact grower) every variable of the
body still holds the previous pass's value when the next pass begins, so
a pass peaks at the sum of its variables plus its largest statement's
temporaries (the new value of the variable that statement binds among
them). The phases:

- *prepare* (``SweepEngine._prepare``): the config's columns, the labels,
  the preprocessing (the scaler, the PCA's SVD), ``xp`` and the bin
  ``edges``, held to the member's end.
- *resample* of each fold (``ops/resample.py``, ``ops/knn.py``): the
  earlier folds' ``[cap, F]``/``[cap]`` outputs held, and the kNN
  workspace: three ``[m, m]`` f32 matrices while the distances are made
  and masked, and ``masked_knn``'s sort (the matrix, its sorted values,
  its int64 indices), at ``m = N`` for Tomek and ENN and at ``m = cap``
  after SMOTE. ``masked_knn`` returns a view of its indices, which keeps
  all ``[m, m]`` of them while its caller runs.
- *stack*: the folds' outputs stacked to ``[n_folds, cap, F]``, both
  copies held through the fit.
- *bootstrap* (RF): the uniforms of ``[G, T, cap]``, whose threefry chain
  (``rng.py``) holds five int64 words of that shape at once (the two
  words, the two shifts of a rotation and their ``|``).
- *draws* (hist grower): ``_node_uniforms``' ``[T, max_nodes + W, F]`` f32
  draw (two for ET), each with its five int64 words beside the node keys
  ``[T, max_nodes + W, 2, 2]``; the node arrays ``[T, max_nodes + 2W]``,
  the ``[T, cap]`` weights and routes held. At the paper's shape this is
  the plan's peak.
- *grow*: a BFS step (hist: ``cum_hists``' ``[T, F, W, B]`` outputs, the
  split scan's ``[T, F, W, B-1]`` temporaries, ``_proxy_score``'s six of
  them, the ``[T, cap]`` routing) or a level of the exact grower (about
  thirty ``[G, T, F, cap]`` variables, the sort's and the scans'
  temporaries).
- *join*: with more than one tree batch, the batches' forests beside
  their concatenation.
- *predict* (``trees.predict_batch``): the forests' int64 copies of the
  child and feature arrays and the traversal's ``[G T, N]`` tensors; then
  *counts* (``confusion_by_fold``).

**CPU against card.** On ``cpu`` K1 runs as its plain version
(``kernels/hist.cum_hists_plain``), whose one-hot contraction holds the
``[T, cap, W]`` membership, the int64 and f32 ``[G, F, cap, B]`` one-hots,
the einsum's permuted copies and the ``bmm`` output; on ``cuda`` the
kernel writes its ``[2, T, F, W, B]`` output and nothing else. On
``cuda`` the law also counts what no tensor of the port names, from
``measure_envelope.py`` (NVIDIA H100 80GB HBM3, 700.00 W, torch
2.11.0+cu128): the 32 MiB cuBLAS workspace a process keeps from its
first matrix product, the stable sort's workspace above 4,096 keys a
segment (16 bytes an element plus the key's width when the sort has 128
segments or more, up to 40.54 bytes an element below 128), the
expanded index copies of a gather with broadcast index tensors (8 bytes
an element an expanded index), the int64 copy that a sum of a bool
tensor makes of its input (8 bytes an element), the SVD's workspace, and
the caching
allocator's rounding (each block a multiple of 512 bytes, and a block
above 1 MiB may keep an unsplit remainder below 1 MiB). On ``cpu`` those
are 0: the audit's recorder, which the CPU law is held against, sees
only the outputs of aten ops.

``plan_envelope`` returns the keys of the JAX package's
``memory_envelope`` (``arg_bytes``, ``out_bytes``, ``peak_bytes``), so
the I401 rule and the tuner read it unchanged; ``detail=True`` adds
each phase's peak (``phases``).
"""

from flake16_framework_tpu_torch import config as cfg
from flake16_framework_tpu_torch.constants import HIST_BINS, N_FEATURES

F32 = I32 = 4
I64 = 8
BOOL = U8 = 1

# Measured on the card by ``measure_envelope.py`` (NVIDIA H100 80GB HBM3,
# 700.00 W, torch 2.11.0+cu128, CUDA 12.8); the law takes each at or
# above the largest reading.
CUBLAS_WORKSPACE = 32 * 2**20      # kept from the first matrix product
SORT_SMALL = 4096                  # keys a segment sorted in place
SORT_FULL_SEGMENTS = 128           # from here on, one sort of all keys
SORT_FULL_PER_KEY = 16             # + the key's width, bytes an element
SORT_SEGMENTED_PER_ELEMENT = 48    # below 128 segments (read: 40.54)
SORT_ONE_SEGMENT_PER_ELEMENT = 32  # a 1-D sort (read: 8.70 int8, 28.62)
SORT_CONSTANT = 2**20              # cub's own, and the in-place path's
SVD_WORKSPACE = 4 * 2**20          # + 80 bytes an element (read: 3.15 MB
SVD_PER_ELEMENT = 80               # at [60, 16], 74.33 B an element above)
INDEX_COPY = I64                   # an expanded index tensor, an element
BOOL_SUM = I64                     # a bool sum's int64 copy, an element

# The keys, scalars and [G, T] bookkeeping that no term names (each one
# block of 512 bytes on the card).
SMALL_TENSORS = 2**18

# The caching allocator's granularity, and the largest remainder it may
# leave unsplit in a block above ``_SPLIT``.
_ROUND, _SPLIT = 512, 2**20

# ``_fma``'s temporaries on its operands' shape, in f32 widths: the f64
# product, sums and errors, the odd neighbour and its selects (read from
# ``ops/trees.py::_fma``).
FMA_F32 = 20
# ``_emit_children``'s temporaries, bytes an element of its [rows, W]
# inputs: the split ranks, the expanded slot queries, the searchsorted
# parent slots, the gathered covers and their selects, the stacked values.
EMIT_BYTES = 160


class _Live:
    """The device bytes one member holds at once. ``hold`` names tensors
    that outlive a statement, ``drop`` releases them, and ``at`` marks a
    moment at which a statement's own temporaries stand beside everything
    held. ``phases`` keeps the largest moment of each phase."""

    def __init__(self, device_type):
        self.cuda = device_type == "cuda"
        self.held = {}
        self.phase = "prepare"
        self.phases = {}

    def size(self, nbytes):
        """A tensor's bytes as the device allocates them."""
        nbytes = max(0, int(nbytes))
        if not self.cuda or not nbytes:
            return nbytes
        nbytes = -(-nbytes // _ROUND) * _ROUND
        return nbytes + (_SPLIT if nbytes > _SPLIT else 0)

    def hold(self, name, *tensors):
        if name in self.held:
            raise ValueError(f"envelope: {name!r} is already held")
        self.held[name] = sum(self.size(t) for t in tensors)
        self.at()

    def drop(self, *names):
        for name in names:
            del self.held[name]

    def at(self, *tensors):
        now = sum(self.held.values()) + sum(self.size(t) for t in tensors)
        self.phases[self.phase] = max(self.phases.get(self.phase, 0), now)

    def loop(self, variables, statements):
        """A pass of a loop body: every variable held at once (the
        previous pass's values), then each statement's temporaries. A
        statement given as (name, temporaries) is a phase of its own."""
        self.hold("loop", *variables)
        phase = self.phase
        for st in statements:
            self.phase, temps = st if isinstance(st, tuple) else (phase, st)
            self.at(*temps)
        self.phase = phase
        self.drop("loop")

    def workspace(self, nbytes):
        """A library call's own bytes: 0 on the CPU (no aten op makes
        them), else as measured."""
        return nbytes if self.cuda else 0

    @property
    def peak(self):
        return max(self.phases.values())


def sort_workspace(live, segments, keys, key_bytes):
    """The CUDA stable sort's workspace for ``segments`` segments of
    ``keys`` keys of ``key_bytes`` bytes (``measure_envelope.py``)."""
    n = segments * keys
    if segments == 1:
        per = SORT_ONE_SEGMENT_PER_ELEMENT
    elif keys <= SORT_SMALL:
        per = 0
    elif segments >= SORT_FULL_SEGMENTS:
        per = SORT_FULL_PER_KEY + key_bytes
    else:
        per = SORT_SEGMENTED_PER_ELEMENT
    return live.workspace(per * n + SORT_CONSTANT)


def _threefry(live, words, keys=0):
    """``rng.uniform`` of ``words`` draws: the threefry chain holds five
    int64 words at once (``x0``, ``x1``, and a rotation's two shifts and
    their ``|``) beside ``k2``, one int64 a key; ``random_bits``' xor and
    ``uniform``'s casts hold fewer. Returns the moment's temporaries."""
    return [I64 * words] * 5 + [I64 * keys]


def _proxy(elements):
    """``_proxy_score``'s temporaries on ``elements`` f32 scores:
    ``d_l``, ``d_r`` and four terms of the sum at once."""
    return [F32 * elements] * 6


def _knn(live, m, f, *, sort):
    """The kNN workspace at ``m`` rows: the distance matrix made (three
    [m, m] f32 at once), masked (three), and for ``masked_knn`` sorted
    (the matrix, its values, its int64 indices and the sort's workspace).
    Returns the moments' temporaries."""
    mat = F32 * m * m
    rows = [F32 * m * f, F32 * m, F32 * m]
    moments = [rows + [mat] * 3, [mat] * 3]
    if sort:
        moments.append([mat, mat, I64 * m * m,
                        sort_workspace(live, m, m, F32)])
    else:
        moments.append([mat, I64 * m])      # argmin: no workspace
    return moments


def _resample(live, bal, n, f, cap):
    """One fold's ``resample``: the kNN stages of its balancing, then its
    [cap, F] / [cap] outputs (held by the caller)."""
    ns = cap - n
    out = [F32 * cap * f, BOOL * cap, F32 * cap]
    pad = [F32 * ns * f, BOOL * ns, F32 * ns]
    small = [BOOL * n] * 4 + [F32 * n] * 2
    if bal == cfg.BAL_NONE:
        live.at(*small, *out, *pad)
        return
    if bal in (cfg.BAL_TOMEK, cfg.BAL_ENN):
        for temps in _knn(live, n, f, sort=bal == cfg.BAL_ENN):
            live.at(*small, *temps)
        idx = [I64 * n * n] if bal == cfg.BAL_ENN else [I64 * n]
        live.at(*small, *idx, I64 * n * 3, *out, *pad)
        return
    # SMOTE at n rows, its neighbour indices held while it draws.
    for temps in _knn(live, n, f, sort=True):
        live.at(*small, *temps)
    draws = [I64 * ns] * 5 + [I64 * ns] * 4 + [F32 * ns * f] * 3 \
        + [F32 * ns * f] * FMA_F32
    live.at(*small, I64 * n * n, BOOL * n * 5, U8 * n, I64 * n,
            sort_workspace(live, 1, n, U8), *draws)
    live.at(*small, I64 * n * n, F32 * ns * f, *out,
            F32 * ns * f, BOOL * ns, F32 * ns)
    if bal == cfg.BAL_SMOTE:
        return
    # The cleaner at cap rows, SMOTE's outputs held.
    live.hold("smoted", *out)
    sort = bal == cfg.BAL_SMOTE_ENN
    for temps in _knn(live, cap, f, sort=sort):
        live.at(BOOL * cap * 4, F32 * cap * 2, *temps)
    idx = I64 * cap * cap if sort else I64 * cap
    live.at(BOOL * cap * 4, idx, I64 * cap * 3, F32 * cap)
    live.drop("smoted")


def _bootstrap(live, g, t, n):
    """``bootstrap_weights`` over [g, t, n]: the uniforms' chain, then the
    inverse-CDF indices beside them. Its output is held by the caller."""
    e = g * t * n
    cdf = [F32 * g * n] * 3
    live.at(*cdf, *_threefry(live, e, g * t))
    live.at(*cdf, F32 * e, I64 * e, I64 * e)
    live.at(*cdf, F32 * e, I64 * e, F32 * e, F32 * e)


def _k1(live, t, gb, n, f, w, b):
    """``cum_hists``' temporaries, its outputs included: the kernel's
    output on ``cuda``; on ``cpu`` the plain version's one-hots, the
    einsum's permuted copies and its ``bmm`` output (read with the
    audit's recorder from ``kernels/hist.py::cum_hists_plain``)."""
    c = F32 * t * f * w * b
    rel32 = I32 * t * n
    if live.cuda:
        return [[rel32, 2 * c]]
    rel64, member = I64 * t * n, F32 * t * n * w
    oh = gb * f * n * b
    base = [rel32, rel64, member]
    contract = [F32 * t * n * w, F32 * t * n * w, F32 * oh, c]
    return [[rel32, rel64, BOOL * t * n * w, member],
            base + [I64 * gb * f * n, I64 * oh],
            base + [I64 * oh, F32 * oh],
            base + [F32 * oh] + contract,
            base + [F32 * oh, c] + contract,
            base + [F32 * oh, c, c, c]]


def _draws(live, t, nid, f, random_splits):
    """``_node_uniforms``: the node keys (``fold_in``, then ``split``),
    then one [t, nid, f] draw, two for Extra Trees."""
    tn = t * nid
    live.at(*[I64 * nid] * 3, *[I64 * tn] * 5)           # fold_in
    live.at(I64 * nid, I64 * 2 * tn, I64 * tn,
            *[I64 * 2 * tn] * 5)                         # split
    keys = [I64 * nid, I64 * 4 * tn]
    live.at(*keys, *_threefry(live, tn * f, tn))
    if random_splits:
        live.at(*keys, F32 * tn * f, *_threefry(live, tn * f, tn))


def _grow_hist(live, *, t, gb, n, f, w, b, max_nodes, random_splits,
               max_features):
    """``_grow_trees`` on a batch of ``t`` trees over ``gb`` groups of
    ``n`` samples at window ``w``: its held arrays, the draws, then a BFS
    step. Leaves the batch's forest held as ``"forest"``."""
    mp = max_nodes + 2 * w
    tn, tw, tfw = t * n, t * w, t * f * w
    s, c = t * f * w * (b - 1), t * f * w * b
    live.hold("grow", F32 * gb * f * n,                   # xt
              I32 * t * mp, F32 * t * mp, I32 * t * mp, I32 * t * mp,
              F32 * 2 * t * mp, I64 * t * mp,             # node arrays
              F32 * tn, I64 * tn,                         # wy, sample_node
              *[F32 * t] * 2, *[I64 * t] * 2, *[I64 * w] * 2,
              I64 * t, I64 * f, I64 * n)
    live.phase = "draws"
    live.at(BOOL * tn)
    _draws(live, t, max_nodes + w, f, random_splits)
    nid_f = F32 * t * (max_nodes + w) * f
    live.hold("draws", nid_f, nid_f if random_splits else 0,
              F32 * f * (b + 1))
    live.phase = "grow"
    index = live.workspace(INDEX_COPY * tn * (1 if gb == 1 else 2))
    index_fw = live.workspace(INDEX_COPY * tfw)
    cw = [2 * F32 * c] if live.cuda else [F32 * c, F32 * c]
    common = [I64 * tw, I64 * tn, BOOL * tn, *cw,       # ids, rel, inb, cw
              F32 * s, F32 * s, BOOL * s, BOOL * tfw,   # rw, rwy, valid, nc
              F32 * tfw, BOOL * tfw, F32 * tfw,         # u_f, sel, score_j
              I64 * tw, F32 * tw, F32 * tw, I64 * tw,   # best_f ... bound_n
              F32 * tw, F32 * tw, BOOL * tw, I64 * tw,  # lw_b, lwy_b, present, dep
              BOOL * tw, BOOL * tw, I64 * tw, I64 * tw,  # impure, can_split, rank, left_g
              I64 * tw, I64 * t,                        # right_g, k_splits
              I64 * tn, BOOL * tn, I64 * tn, I64 * tn,  # rs, can_mine, rank_mine, bf_mine
              BOOL * tn, I64 * tw,                      # go_left, minus1
              F32 * 2 * tw * 2, BOOL * 2 * tw, I64 * 2 * tw,  # children
              I64 * tn]                                 # child_mine
    if random_splits:
        branch = [F32 * c, U8 * c, I64 * tfw, I64 * tfw,  # prev, occ, lo, hi
                  F32 * tfw, F32 * tfw, F32 * tfw,      # u, vmin, vmax
                  F32 * tfw, I64 * tfw, I64 * tfw,      # thr_v, cnt, bsel
                  I64 * tfw, F32 * tfw, F32 * tfw,      # bm1, lw_j, lwy_j
                  F32 * tfw, BOOL * tfw, F32 * tfw]     # rw_j, ok_j, thr_j
        stmts = [[F32 * tfw, F32 * c],                  # prev
                 [BOOL * c, U8 * c],                    # occ
                 [U8 * c, I64 * tfw, I64 * tfw, I64 * tfw],  # hi
                 [I64 * tfw, F32 * tfw, index_fw],      # vmin, vmax
                 ("fma", [F32 * tfw, F32 * tfw]         # thr_v, _fma
                  + [F32 * tfw] * FMA_F32),
                 [BOOL * s, live.workspace(BOOL_SUM * s),  # cnt
                  I64 * tfw],
                 [I64 * tfw] * 3,                       # bsel
                 ("proxy", [F32 * tfw, BOOL * tfw * 3]  # score_j
                  + _proxy(tfw))]
    else:
        branch = [F32 * s, I64 * tfw,                 # score, bb
                  I64 * tfw, F32 * tfw, F32 * tfw,      # bound_j, lw_j, lwy_j
                  F32 * tfw,                            # thr_j
                  F32 * tn, F32 * tn,                   # xv, inf
                  *[F32 * tw] * 4, BOOL * tw]           # m_l ... ok_ref
        stmts = [("proxy", _proxy(s)),                  # score
                 [BOOL * tn, F32 * tn, F32 * tn, F32 * tw],  # m_l
                 [BOOL * tn, BOOL * tn, F32 * tn, F32 * tw]]  # m_r
    sel = [F32 * tfw, F32 * tfw, F32 * tfw, I64 * tfw] \
        if max_features is not None else []
    stmts += [
        [I64 * tn],                                     # rel
        [BOOL * tn] * 3,                                # inb
        *[("k1", m) for m in _k1(live, t, gb, n, f, w, b)],
        [F32 * s],                                      # rw, rwy
        [BOOL * s] * 3,                                 # valid
        ("select", sel + [BOOL * tfw] * 2
         + [live.workspace(SORT_CONSTANT)]),
        [F32 * tfw, F32 * tfw],                         # score_j
        [F32 * tfw, index_fw],                          # thr_j
        [F32 * tfw, live.workspace(INDEX_COPY * tw)],   # u_f
        [BOOL * tw, live.workspace(BOOL_SUM * tw), I64 * t],  # k_splits
        [I64 * tn, BOOL * tn, BOOL * tn],               # rs, can_mine
        [U8 * tn, I64 * tn, BOOL * tn, index],          # go_left
        [I64 * tn, index],                              # bf_mine, xv
        [I64 * tn] * 3,                                 # child_mine
        [BOOL * tn, I64 * tn, I64 * tn],                # sample_node
        ("emit", [EMIT_BYTES * tw]),                    # _emit_children
        ("window", [I64 * tw * 2, F32 * tw * 2 * 4]),   # _window_update
    ]
    live.loop(common + branch, stmts)
    live.drop("draws", "grow")
    live.hold("forest", I32 * t * mp, F32 * t * mp, I32 * t * mp,
              I32 * t * mp, F32 * 2 * t * mp, I32 * t)


def _grow_exact(live, *, g, t, n, f, max_nodes, depth, random_splits,
                max_features):
    """``_fit_trees_exact`` on ``g`` groups of ``t`` trees of ``n``
    samples: its held arrays, then a level. Leaves the batch's forest held
    as ``"forest"``."""
    mp = max_nodes + 2 * n
    pf, pf1, ln = g * t * f * n, g * t * f * (n + 1), g * t * n
    live.hold("grow", I32 * g * t * mp, F32 * g * t * mp, I32 * g * t * mp,
              I32 * g * t * mp, F32 * 2 * g * t * mp,   # node arrays
              F32 * ln, I64 * ln, F32 * pf, F32 * pf,   # wy, sample_rel, w_f, wy_f
              I64 * 4 * g * t * depth, F32 * g * t, *[I64 * g * t] * 2)
    live.at(*[I64 * 2 * g * t * depth] * 6)             # the level keys
    sort = sort_workspace(live, g * t * f, n, I64)
    variables = [I64 * pf, I64 * pf, F32 * pf, F32 * pf, F32 * pf,
                 BOOL * pf, BOOL * pf,                  # ... is_end
                 F32 * pf, F32 * pf, F32 * pf, F32 * pf,  # prefix stats
                 I64 * ln, I64 * ln, BOOL * ln,         # node lookup
                 BOOL * pf, F32 * pf,                   # active, v_next
                 F32 * pf, F32 * pf, F32 * pf, F32 * pf,  # at_node
                 BOOL * pf, F32 * pf, F32 * pf, F32 * pf,  # nc_j, thr_j, lw_j, lwy_j
                 F32 * pf,                              # score_j
                 I64 * ln, *[F32 * ln] * 6, BOOL * ln, BOOL * ln,
                 I64 * ln, I64 * ln,                    # ... left_g
                 F32 * 2 * ln * 2, BOOL * 2 * ln,       # child_vals, child_ok
                 max(I64 * 2 * ln, F32 * pf if random_splits else 0),  # _
                 I64 * ln, BOOL * ln, F32 * ln, BOOL * ln, I64 * ln]
    prefix = [F32 * pf] * 6 + [I64 * pf]
    stmts = [
        [I64 * pf, I64 * pf, I64 * pf, sort],           # the sort
        [BOOL * pf] * 3,                                # run boundaries
        prefix,                                         # _prefix_stats
        [I64 * (ln + g * t)] * 6 + [BOOL * ln],         # node lookup
        [F32 * pf, BOOL * pf, BOOL * pf],               # nc_j
        [I64 * pf, F32 * pf, F32 * pf],                 # bpos_j, v_lo
        [F32 * pf, F32 * pf, BOOL * pf],                # thr_j
        [I64 * ln, I64 * ln, F32 * ln],                 # xv
        [I64 * ln] * 3 + [BOOL * ln],                   # child_rel
        [live.workspace(BOOL_SUM * ln), I64 * g * t],   # n_split
        [EMIT_BYTES * ln],                              # _emit_children
        [I64 * 2 * ln * 2, F32 * 2 * ln * 2 * 3],       # write(value)
    ]
    if random_splits:
        variables += [F32 * pf, F32 * pf, BOOL * pf, F32 * pf, F32 * pf,
                      F32 * pf, F32 * pf]               # u ... rw_j
        stmts += [_threefry(live, pf, g * t),          # u
                  [F32 * pf] + [F32 * pf] * FMA_F32,    # thr_j = _fma
                  [I64 * pf, F32 * pf],                 # thr_s
                  [F32 * pf] + prefix,                  # lw_tot, lwy_tot
                  [F32 * pf, BOOL * pf * 3] + _proxy(pf)]
    else:
        variables += [F32 * pf, BOOL * pf, F32 * pf,    # rw, valid, score_i
                      F32 * pf1, I64 * pf1, I64 * pf,   # best, best_p, bpos_j
                      F32 * pf, F32 * pf]               # v_lo, v_hi
        stmts += [[BOOL * pf] * 3 + [F32 * pf],         # valid
                  [F32 * pf] + _proxy(pf),              # score_i
                  [F32 * pf1, BOOL * pf, I64 * pf, I64 * pf1,
                   F32 * pf]]                           # _run_best
    if max_features is not None:
        variables += [F32 * pf, BOOL * pf]              # u_f, sel
        stmts += [_threefry(live, pf, g * t),
                  [F32 * pf, F32 * pf, F32 * pf, I64 * pf, BOOL * pf,
                   live.workspace(SORT_CONSTANT)]]
    live.loop(variables, stmts)
    live.drop("grow")
    live.hold("forest", I32 * g * t * mp, F32 * g * t * mp,
              I32 * g * t * mp, I32 * g * t * mp, F32 * 2 * g * t * mp,
              I32 * g * t)


def _batches(n_folds, n_trees, tree_chunk, fold_chunk):
    """(folds, trees) of each tree batch, as ``trees._batches`` cuts them."""
    tc, fc = tree_chunk or n_trees, fold_chunk or n_folds
    return [(min(fc, n_folds - g0), min(tc, n_trees - t0))
            for g0 in range(0, n_folds, fc) for t0 in range(0, n_trees, tc)]


def member_envelope(keys, *, n, n_trees, n_folds, n_projects, max_depth,
                    hist, width, tree_chunk, fold_chunk, device_type,
                    n_bins=HIST_BINS):
    """(peak bytes over the engine's resident ones, {phase: peak}) of one
    member, config ``keys`` at ``n`` rows and ``n_bins`` bins, run by
    ``_fit_count_folds``."""
    _, cols, prep, bal, spec = cfg.resolve_config(keys)
    f, cap, b = len(cols), 2 * n, n_bins
    max_nodes = 2 * cap
    max_features = max(1, int(f ** 0.5)) if spec.sqrt_features else None
    live = _Live(device_type)
    live.hold("small", SMALL_TENSORS)
    if live.cuda:
        live.hold("cublas", CUBLAS_WORKSPACE)
    nf = n * f
    # prepare: the columns, the labels, the preprocessing, xp, the edges.
    live.hold("y", BOOL * n)
    live.hold("x", F32 * nf, F32 * f, F32 * f * f)
    svd = live.workspace(SVD_WORKSPACE + SVD_PER_ELEMENT * nf)
    live.at(*[F32 * (nf + 32 * f)] * 5, svd if prep == cfg.PREP_PCA else 0)
    live.hold("xp", F32 * nf)
    if hist:
        live.at(F32 * nf, I64 * nf, sort_workspace(live, f, n, F32),
                *[F32 * f * b] * 3)
        live.hold("edges", F32 * f * (b - 1))
    live.drop("x")
    live.hold("keys", *[I64 * 2 * n_folds] * 2)
    # resample: each fold's outputs held by the next folds.
    live.phase = "resample"
    for k in range(n_folds):
        _resample(live, bal, n, f, cap)
        live.hold(f"fold{k}", F32 * cap * f, BOOL * cap, F32 * cap,
                  I64 * 2)
    live.hold("stacked", F32 * n_folds * cap * f, BOOL * n_folds * cap,
              F32 * n_folds * cap, I64 * 2 * n_folds)
    # fit
    live.phase = "fit"
    nb = n_folds * cap
    live.hold("fit", F32 * nb, I64 * 4 * n_folds * n_trees)  # y01, kk
    if hist:
        bins = nb * f * (b - 1)
        live.at(BOOL * bins, live.workspace(BOOL_SUM * bins), I64 * nb * f)
        live.at(I64 * nb * f, U8 * nb * f)
        live.hold("bins", U8 * nb * f)
    else:
        live.at(F32 * nb * f, I64 * nb * f,
                sort_workspace(live, n_folds * f, cap, F32))
        live.hold("bins", I64 * nb * f, F32 * nb * f)   # order0, xsorted
    if spec.bootstrap:
        live.phase = "bootstrap"
        _bootstrap(live, n_folds, n_trees, cap)
        live.hold("wt", F32 * n_folds * n_trees * cap)
    batches = _batches(n_folds, n_trees, tree_chunk, fold_chunk)
    for k, (gb, tb) in enumerate(batches):
        live.phase = "grow"
        if hist:
            whole = (gb, tb) == (n_folds, n_trees)
            copy = 0 if spec.bootstrap and whole else F32 * gb * tb * cap
            live.hold("w_flat", copy, I64 * 2 * gb * tb)
            _grow_hist(live, t=gb * tb, gb=gb, n=cap, f=f,
                       w=min(width, max_nodes), b=b, max_nodes=max_nodes,
                       random_splits=spec.random_splits,
                       max_features=max_features)
            live.drop("w_flat")
        else:
            _grow_exact(live, g=gb, t=tb, n=cap, f=f, max_nodes=max_nodes,
                        depth=max_depth, random_splits=spec.random_splits,
                        max_features=max_features)
        live.held[f"part{k}"] = live.held.pop("forest")
    m, gt = max_nodes, n_folds * n_trees
    if len(batches) > 1:
        live.phase = "join"
        field = [I32 * gt * m, F32 * gt * m, I32 * gt * m, I32 * gt * m,
                 F32 * 2 * gt * m, I32 * gt]
        live.at(*field, *field)         # the rows, then the whole
        for k in range(len(batches)):
            live.drop(f"part{k}")
        live.hold("forest", *field)
    live.drop("fit", "bins")
    if spec.bootstrap:
        live.drop("wt")
    # predict: the traversal over [G T, N] samples.
    live.phase = "predict"
    gts = gt * n
    index = live.workspace(INDEX_COPY * gts)
    live.hold("predict", F32 * nf, I64 * n, I64 * gt * m, I64 * gt * m,
              I64 * gt * m)
    live.loop([I64 * gts, F32 * gts, I64 * gts, I64 * gts],
              [[I64 * gts], [I64 * gts, F32 * gts, index],
               [F32 * gts, BOOL * gts],
               [BOOL * gts, I64 * gts, I64 * gts, I64 * gts],
               [F32 * 2 * gts, F32 * gts, F32 * gts, F32 * 2 * gts]])
    live.drop("predict")
    live.at(F32 * 2 * gts, F32 * 2 * n_folds * n * 3, BOOL * n_folds * n)
    # counts
    live.phase = "counts"
    live.at(*[I64 * n_folds * n] * 5, BOOL * n_folds * n * 2, I64 * n * 2,
            I64 * n_folds * n_projects * 3, I32 * n_folds * n_projects * 3)
    return live.peak, live.phases


def _resident_bytes(*, n, n_folds, device_type):
    """What ``SweepEngine`` keeps on a card across members: the features
    (f32 [N, N_FEATURES]), the raw labels and project ids (int32 [N]) and
    each flaky type's train and test fold masks (f32 [n_folds, N])."""
    live = _Live(device_type)
    return sum(live.size(t) for t in (
        [F32 * n * N_FEATURES, I32 * n, I32 * n]
        + [F32 * n_folds * n] * 2 * len(cfg.FLAKY_TYPES)))


def plan_envelope(plan, *, n_projects, max_depth, hist, width, tree_chunk,
                  fold_chunk, device_type, detail=False, n_bins=HIST_BINS):
    """{"arg_bytes", "out_bytes", "peak_bytes"} of one ``planner.Plan``
    on ``device_type`` ("cuda" or "cpu"): what the engine keeps resident,
    the plan's outputs (each member's int32 [n_folds, P, 3] counts) and
    the resident bytes plus its largest member's peak. ``hist`` is
    whether the family grows on the histogram grower, ``width`` its window
    width and ``n_bins`` its bins, ``tree_chunk``/``fold_chunk`` a tree
    batch's bounds
    (``sweep.batch_bounds``). ``detail=True`` adds the largest member's
    ``phases`` and its ``config``. Raises ValueError for a plan it cannot
    bound."""
    n, n_feat, n_trees, n_folds, cap = plan.shape
    if cap != 2 * n or not plan.configs:
        raise ValueError(f"envelope: plan {plan!r} is not a sweep plan")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"envelope: unknown device type {device_type!r}")
    if hist and not width:
        raise ValueError("envelope: a hist plan needs its window width")
    best = None
    for keys in plan.configs:
        if len(cfg.FEATURE_SETS[keys[1]]) != n_feat:
            raise ValueError(f"envelope: {keys!r} is not of plan {plan!r}")
        peak, phases = member_envelope(
            keys, n=n, n_trees=n_trees, n_folds=n_folds,
            n_projects=n_projects, max_depth=max_depth, hist=hist,
            width=width, tree_chunk=tree_chunk, fold_chunk=fold_chunk,
            device_type=device_type, n_bins=n_bins)
        if best is None or peak > best[0]:
            best = (peak, phases, keys)
    arg = _resident_bytes(n=n, n_folds=n_folds, device_type=device_type)
    env = {"arg_bytes": arg,
           "out_bytes": I32 * n_folds * n_projects * 3 * len(plan.configs),
           "peak_bytes": arg + best[0]}
    if detail:
        env["phases"] = best[1]
        env["config"] = "/".join(best[2])
    return env
