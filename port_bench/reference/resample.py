"""The five balancers behind one switch on the balancing code, each
returning fixed-capacity arrays (x [cap,F], y [cap], w [cap]) where ``w``
is a 0/1 validity weight the tree grower consumes directly (imbalanced-learn
0.9.0 defaults, re-derived as in the JAX package):

- TomekLinks: i is in a link iff its 1-NN j has another class and j's 1-NN
  is i; 'auto' removes only majority link members, 'all' every member.
- ENN (k=3, kind_sel='all'): a target sample is kept iff its 3 nearest
  neighbours share its class; 'auto' cleans the majority, 'all' both.
- SMOTE (k=5): n_maj - n_min synthetic minority rows, each
  base + U(0,1) * (neighbour - base), the neighbour drawn from the base's
  5-NN within the minority class.
- SMOTE ENN / SMOTE Tomek: SMOTE, then the cleaner with 'all'.

Random draws use the port's jax-compatible threefry (``rng``), so the
synthetic rows are the JAX package's rows.
"""

import torch

from port_bench.reference import rng
from port_bench.reference.grid import (
    BAL_NONE, BAL_TOMEK, BAL_SMOTE, BAL_ENN, BAL_SMOTE_ENN, BAL_SMOTE_TOMEK,
)
from port_bench.reference.knn import masked_knn, nearest_one
from port_bench.reference.trees import _fma

SMOTE_K = 5
ENN_K = 3


def _class_counts(y, w):
    pos = torch.sum(torch.where(y, w, torch.zeros_like(w)))
    neg = torch.sum(w) - pos
    return neg, pos


def _pad_cap(x, y, w, cap):
    pad = cap - x.shape[0]
    return (torch.cat([x, x.new_zeros(pad, x.shape[1])]),
            torch.cat([y, y.new_zeros(pad)]),
            torch.cat([w, w.new_zeros(pad)]))


def tomek_keep(x, y, w, *, strategy_all):
    """Weights with the Tomek-link members removed (set to 0)."""
    valid = w > 0
    nn1 = nearest_one(x, valid)
    mutual = nn1[nn1] == torch.arange(x.shape[0], device=x.device)
    link = valid & (y[nn1] != y) & mutual
    if not strategy_all:
        neg, pos = _class_counts(y, w)
        link = link & (y == (pos >= neg))
    return torch.where(valid & ~link, w, torch.zeros_like(w))


def enn_keep(x, y, w, *, strategy_all):
    """Weights with ENN(kind_sel='all') removals set to 0."""
    valid = w > 0
    idx, ok = masked_knn(x, valid, ENN_K)
    # Missing neighbours (tiny classes) count as agreeing: never remove.
    all_same = torch.all((y[idx] == y[:, None]) | ~ok, dim=1)
    target = valid
    if not strategy_all:
        neg, pos = _class_counts(y, w)
        target = target & (y == (pos >= neg))
    return torch.where(valid & ~(target & ~all_same), w, torch.zeros_like(w))


def smote(x, y, w, key, cap):
    """SMOTE into fixed capacity: rows [0,N) are the originals, rows
    [N,cap) synthetic slots, the first n_maj-n_min of which are valid."""
    n = x.shape[0]
    neg, pos = _class_counts(y, w)
    minority_is_pos = pos < neg
    is_min = (w > 0) & (y == minority_is_pos)
    n_min = torch.sum(is_min.to(torch.int64))
    n_maj = torch.sum((w > 0).to(torch.int64)) - n_min
    # No minority sample in this fold: a no-op, not mislabeled copies.
    n_synth = torch.where(n_min > 0, torch.clamp(n_maj - n_min, 0, cap - n),
                          torch.zeros_like(n_min))

    idx, ok = masked_knn(x, is_min, SMOTE_K)
    # Minority rows in original order (a stable sort moves them first).
    min_order = torch.sort((~is_min).to(torch.int8), stable=True).indices

    n_slots = cap - n
    ki, ks = rng.split(key).unbind(-2)
    # imblearn's draw: one randint over the flattened [n_min x k] table.
    pick = rng.randint(ki, (n_slots,), 0,
                       torch.clamp(n_min * SMOTE_K, min=1)).to(torch.int64)
    base = min_order[pick // SMOTE_K]
    col = pick % SMOTE_K
    nbr = torch.where(ok[base, col], idx[base, col], base)

    steps = rng.uniform(ks, (n_slots, 1)).to(x.dtype)
    # One rounding, as XLA contracts the JAX package's x + s * d on the CPU.
    x_new = _fma(steps, x[nbr] - x[base], x[base])
    slot_ok = torch.arange(n_slots, device=x.device) < n_synth

    x_out = torch.cat([x, torch.where(slot_ok[:, None], x_new,
                                      torch.zeros_like(x_new))])
    y_out = torch.cat([y, minority_is_pos.expand(n_slots)])
    w_out = torch.cat([w, slot_ok.to(w.dtype)])
    return x_out, y_out, w_out


def resample(x, y, w, bal_code, key, cap):
    """Balance (x [N,F], y [N] bool, w [N]) by ``bal_code``
    (config.BALANCINGS) into (x [cap,F], y [cap], w [cap])."""
    if bal_code == BAL_NONE:
        return _pad_cap(x, y, w, cap)
    if bal_code == BAL_TOMEK:
        return _pad_cap(x, y, tomek_keep(x, y, w, strategy_all=False), cap)
    if bal_code == BAL_ENN:
        return _pad_cap(x, y, enn_keep(x, y, w, strategy_all=False), cap)
    if bal_code not in (BAL_SMOTE, BAL_SMOTE_ENN, BAL_SMOTE_TOMEK):
        raise ValueError(f"unknown balancing code {bal_code!r}")
    xs, ys, ws = smote(x, y, w, key, cap)
    if bal_code == BAL_SMOTE_ENN:
        ws = enn_keep(xs, ys, ws, strategy_all=True)
    elif bal_code == BAL_SMOTE_TOMEK:
        ws = tomek_keep(xs, ys, ws, strategy_all=True)
    return xs, ys, ws
