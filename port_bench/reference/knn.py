"""Pairwise squared distances and k nearest neighbours, the primitive of
every resampler. Distances use the matmul identity
|a-b|^2 = |a|^2 + |b|^2 - 2ab; invalid columns and the diagonal (self) are
+inf. Ties go to the lowest index: a stable sort, not ``torch.topk``,
which promises no order among ties on CUDA."""

import torch


def pairwise_sq_dists(a, b):
    """[Na, F], [Nb, F] -> [Na, Nb] squared Euclidean distances."""
    aa = torch.sum(a * a, dim=1)
    bb = torch.sum(b * b, dim=1)
    d = aa[:, None] + bb[None, :] - 2.0 * (a @ b.T)
    return torch.clamp(d, min=0.0)


def _masked_dists(x, col_valid):
    d = pairwise_sq_dists(x, x)
    d = torch.where(col_valid[None, :], d, torch.full_like(d, float("inf")))
    d.fill_diagonal_(float("inf"))
    return d


def masked_knn(x, col_valid, k):
    """(idx [N, k] int64, ok [N, k] bool): the k nearest valid neighbours of
    every row, self excluded; ``ok`` marks real (finite) neighbours."""
    d = _masked_dists(x, col_valid)
    vals, idx = torch.sort(d, dim=1, stable=True)
    return idx[:, :k], torch.isfinite(vals[:, :k])


def nearest_one(x, col_valid):
    """Index of the nearest valid neighbour per row (ties -> lowest)."""
    return torch.argmin(_masked_dists(x, col_valid), dim=1)
