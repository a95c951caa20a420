"""Preprocessing as one affine transform ``x' = (x - mu) @ W``: none,
StandardScaler, or StandardScaler -> PCA (all components), fit on the full
matrix before CV as the reference does.

The PCA basis comes from ``torch.linalg.svd`` of the centred matrix, or,
under ``pca_impl="eigh"`` / ``F16_PCA_IMPL=eigh``, from the eigenvectors
of its f32 Gram matrix ``xcᵀ·xc`` (columns reversed: descending
eigenvalue is descending singular value), both with sklearn's u-based
``svd_flip`` sign rule. The port's default is "svd" on the CPU and on the
card alike. The JAX package defaults to eigh on a TPU only, for the TPU's
sake: XLA:TPU lowers the SVD of a tall matrix to a long iterative
program. cuSOLVER has no such limit, so on the card eigh is an arm to
compare, not a default. Callers resolve the device through
``device.resolve``, which pins full-f32 matmuls.
"""

import os

import torch

from flake16_framework_tpu_torch.config import PREP_NONE, PREP_SCALING, PREP_PCA
from flake16_framework_tpu_torch.ops.trees import _fma


# XLA:CPU's summation window, a fidelity constant and not a tunable.
WINDOW = 32  # f16lint: disable=G108 (XLA:CPU's bits, not a tunable)


def _colsum(x):
    """Column sums of ``x`` [N, F] in XLA:CPU's order for ``x.sum(axis=0)``:
    windows of 32 rows summed in row order from 0, each level zero-padded to
    a multiple of 32 (``pad // 2`` rows before, the rest after), until at
    most 32 rows are left, which are summed in order. Elementwise f32
    additions in a fixed order give the same bits on the card."""
    f = x.shape[1]
    while x.shape[0] > WINDOW:
        pad = -x.shape[0] % WINDOW
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2))
        rows = x.reshape(-1, WINDOW, f)
        acc = torch.zeros_like(rows[:, 0])
        for i in range(WINDOW):
            acc = acc + rows[:, i]
        x = acc
    acc = torch.zeros(f, dtype=x.dtype, device=x.device)
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc


def _colsum_sq(d):
    """Column sums of ``d * d`` in XLA:CPU's order. Above 32 rows the square
    is a fusion of its own, rounded before the windowed sum; at 32 rows or
    fewer XLA fuses it into the one reduce and contracts each step into a
    multiply-add."""
    if d.shape[0] > WINDOW:
        return _colsum(d * d)
    acc = torch.zeros(d.shape[1], dtype=d.dtype, device=d.device)
    for i in range(d.shape[0]):
        acc = _fma(d[i], d[i], acc)
    return acc


def _inv_n(x):
    """float32(1/N), the constant XLA multiplies by in place of ``/ N``."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return one / torch.full((), float(x.shape[0]), dtype=x.dtype,
                            device=x.device)


def _scaler_params(x):
    """StandardScaler, ddof=0; zero-variance columns get scale 1. The
    reference's bits: ``mean = colsum(x) * (1/N)``, ``var = colsum(d * d) *
    (1/N)`` and a correctly rounded square root (taken in f64: the CPU's
    vector f32 ``sqrt`` is not)."""
    inv_n = _inv_n(x)
    mu = _colsum(x) * inv_n
    var = _colsum_sq(x - mu) * inv_n
    sd = torch.sqrt(torch.clamp(var, min=0.0).double()).to(x.dtype)
    sd = torch.where(sd == 0.0, torch.ones_like(sd), sd)
    return mu, sd


def pca_impl_of(pca_impl=None):
    """The PCA factorization: ``pca_impl``, else ``F16_PCA_IMPL``, else
    "svd" (read at call time); ValueError in the JAX package's words for
    anything but svd|eigh."""
    impl = pca_impl or os.environ.get("F16_PCA_IMPL", "") or "svd"
    if impl not in ("svd", "eigh"):
        raise ValueError(
            f"pca_impl/F16_PCA_IMPL must be svd|eigh, got {impl!r}")
    return impl


def _pca_basis(xc, impl):
    """Component basis vt [F, F] (rows are components, descending
    variance) of the centred ``xc`` under the resolved ``impl``; each
    row's sign is the caller's."""
    if impl == "svd":
        return torch.linalg.svd(xc, full_matrices=False)[2]
    _, evecs = torch.linalg.eigh(xc.T @ xc)
    return torch.flip(evecs, [1]).T


def fit_preprocess(x, prep_code, pca_impl=None):
    """(mu [F], W [F,F]) with transform(x) == (x - mu) @ W for ``prep_code``
    (PREP_NONE / PREP_SCALING / PREP_PCA); ``pca_impl`` (svd|eigh, else
    ``pca_impl_of``, resolved for every code as the JAX package's trace
    resolves it) picks the PCA factorization."""
    impl = pca_impl_of(pca_impl)
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
    mu2 = _colsum(xs) * _inv_n(x)
    xc = xs - mu2
    vt = _pca_basis(xc, impl)
    # svd_flip(u_based): the sign of each component is that of U's
    # largest-|.| entry in its column; U's column is xc @ v / s.
    proj = xc @ vt.T
    idx = torch.argmax(proj.abs(), dim=0)
    signs = torch.sign(proj[idx, torch.arange(f, device=x.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    vt = vt * signs[:, None]
    # XLA:CPU contracts ``mu + mu2 * sd`` with mu's own product,
    # colsum(x) * (1/N), into one fused multiply-add.
    return _fma(_colsum(x), _inv_n(x), mu2 * sd), torch.diag(1.0 / sd) @ vt.T


def transform(x, mu, w):
    return (x - mu[None, :]) @ w
