"""Confusion accumulation and precision/recall/F1 (reference scoring
semantics): ``k = 2*label + pred - 1`` maps (TN, FP, FN, TP) to
(-1, 0, 1, 2); TN is skipped; counts accumulate per project; P/R/F give
``None`` on zero denominators."""

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


def confusion_by_fold(labels, preds, test_mask, project_ids, n_projects):
    """(FP, FN, TP) per fold and project, int32 [G, P, 3], from per-fold
    predictions and test masks [G, N]: row g equals
    ``confusion_by_project`` of fold g. One scatter-add, with no
    data-dependent shape, so the counts reach the host in one read."""
    labels = labels.to(torch.int64)
    n_fold = preds.shape[0]
    k = 2 * labels[None, :] + preds.to(torch.int64) - 1
    mask = (test_mask > 0) & (k >= 0)
    fold = torch.arange(n_fold, device=preds.device)[:, None]
    seg = (fold * n_projects + project_ids.to(torch.int64)[None, :]) * 3 \
        + k.clamp(min=0)
    counts = torch.zeros(n_fold * n_projects * 3, dtype=torch.int64,
                         device=preds.device).scatter_add_(
        0, seg.reshape(-1), mask.reshape(-1).to(torch.int64))
    return counts.to(torch.int32).reshape(n_fold, n_projects, 3)


def div_none(a, b):
    return a / b if b else None


def get_prf(fp, fn, tp):
    """Precision/recall/F1 with None on zero denominators."""
    p = div_none(tp, tp + fp)
    r = div_none(tp, tp + fn)

    if p is None or r is None:
        f = None
    else:
        f = div_none(2 * p * r, p + r)

    return p, r, f


def format_scores(counts, project_names, all_projects):
    """counts [P,3] -> (scores dict, scores_total list) in reference schema:
    ``scores[proj] = [fp, fn, tp, p, r, f]``; projects keep their
    first-seen order over the per-sample ``all_projects`` array."""
    counts = [[int(x) for x in row] for row in counts]
    order = list(dict.fromkeys(project_names))

    scores = {}
    total = [0, 0, 0]
    for pid, proj in enumerate(order):
        fp, fn, tp = counts[pid]
        scores[proj] = [fp, fn, tp, *get_prf(fp, fn, tp)]
        total[0] += fp
        total[1] += fn
        total[2] += tp

    seen = {p: scores[p] for p in dict.fromkeys(list(all_projects))}
    scores_total = [*total, *get_prf(*total)]
    return seen, scores_total
