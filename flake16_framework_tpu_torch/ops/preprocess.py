"""Preprocessing as one affine transform ``x' = (x - mu) @ W``: none,
StandardScaler, or StandardScaler -> PCA (all components), fit on the full
matrix before CV as the reference does.

The PCA basis comes from ``torch.linalg.svd`` with sklearn's u-based
``svd_flip`` sign rule (the JAX package's CPU arm). Callers resolve the
device through ``device.resolve``, which pins full-f32 matmuls.
"""

import torch

from flake16_framework_tpu_torch.config import PREP_NONE, PREP_SCALING, PREP_PCA


def _scaler_params(x):
    """StandardScaler, ddof=0; zero-variance columns get scale 1."""
    mu = x.mean(dim=0)
    sd = torch.sqrt(torch.clamp(x.var(dim=0, unbiased=False), min=0.0))
    sd = torch.where(sd == 0.0, torch.ones_like(sd), sd)
    return mu, sd


def fit_preprocess(x, prep_code):
    """(mu [F], W [F,F]) with transform(x) == (x - mu) @ W for ``prep_code``
    (PREP_NONE / PREP_SCALING / PREP_PCA)."""
    f = x.shape[1]
    if prep_code == PREP_NONE:
        return torch.zeros(f, dtype=x.dtype, device=x.device), \
            torch.eye(f, dtype=x.dtype, device=x.device)
    mu, sd = _scaler_params(x)
    if prep_code == PREP_SCALING:
        return mu, torch.diag(1.0 / sd)
    if prep_code != PREP_PCA:
        raise ValueError(f"unknown preprocessing code {prep_code!r}")
    xs = (x - mu) / sd
    mu2 = xs.mean(dim=0)
    xc = xs - mu2
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    # svd_flip(u_based): the sign of each component is that of U's
    # largest-|.| entry in its column; U's column is xc @ v / s.
    proj = xc @ vt.T
    idx = torch.argmax(proj.abs(), dim=0)
    signs = torch.sign(proj[idx, torch.arange(f, device=x.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    vt = vt * signs[:, None]
    return mu + mu2 * sd, torch.diag(1.0 / sd) @ vt.T


def transform(x, mu, w):
    return (x - mu[None, :]) @ w
