"""Confusion accumulation (reference scoring
semantics): ``k = 2*label + pred - 1`` maps (TN, FP, FN, TP) to
(-1, 0, 1, 2); TN is skipped; counts accumulate per project."""

import torch


def confusion_by_project(labels, preds, test_mask, project_ids, n_projects):
    """(FP, FN, TP) per project over fold-test samples.

    labels [N] bool/int; preds [..., N] (leading axes e.g. folds);
    test_mask [..., N] 0/1; project_ids [N] int. Returns int32 [P, 3].
    """
    labels = labels.to(torch.int64)
    n = labels.shape[0]
    k = 2 * labels[None, :] + preds.reshape(-1, n).to(torch.int64) - 1
    mask = (test_mask.reshape(k.shape) > 0) & (k >= 0)
    seg = project_ids.to(torch.int64)[None, :] * 3 + k.clamp(min=0)
    counts = torch.bincount(seg[mask], minlength=n_projects * 3)
    return counts.to(torch.int32).reshape(n_projects, 3)
