"""A CPU model of the Tree SHAP unit kernel's arithmetic
(``csrc/treeshap_unit.cu``), run with the wrapper's own ``unit_tables``,
against the port's plain unit and the JAX package's XLA unit on the same
inputs, at rtol 1e-5, atol 1e-6 (the kernel's products, reciprocals and
sums round in another order than the reference's divisions). Also: the
row order that ``bucket_inputs`` hands to the kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu.ops import treeshap as jshap
from flake16_framework_tpu_torch.kernels import treeshap_unit as tunit
from flake16_framework_tpu_torch.ops import treeshap as tshap
from flake16_framework_tpu_torch.weights import forest_from_numpy

BIG = np.float32(3.4e38)
R, S = 16, 37  # the JAX units take whole blocks of 8 work items


@pytest.fixture(autouse=True)
def _jax_x64_off():
    with jax.enable_x64(False):
        yield


def _fma(a, b, c):
    """f32 fused multiply-add: the exact product and sum in f64, rounded
    once more to f32."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def kernel_model(fid, z, lo, hi, u, scale, x, tables):
    """The kernel's recurrences, one work item at a time over all samples:
    EXTEND in the scaled basis, the shared o = 0 sum S0 and the
    division-free o = 1 unwind, with coefficients from ``tables``."""
    f32 = np.float32
    c_t, e_t, h_t, f_t = tables.numpy()
    n_feat = x.shape[1]
    phi = np.zeros((n_feat, x.shape[0]), f32)
    for r in range(fid.shape[0]):
        uu = min(max(int(u[r]), 0), fid.shape[1])
        if uu == 0:
            continue
        zk = z[r, :uu]
        zs = np.maximum(zk, f32(1e-30))
        r1 = (f32(1) - zk) * scale[r]
        r0 = -(zk * (f32(1) / zs)) * scale[r]
        d = zs[:, None] * e_t[uu, None, :uu]                   # [k, j]
        xk = x[:, fid[r, :uu]].T                               # [k, S]
        o = (xk > lo[r, :uu, None]) & (xk <= hi[r, :uu, None])
        w = np.zeros((uu + 1, x.shape[0]), f32)
        w[0] = 1
        for k in range(uu):
            zm = zk[k] * np.arange(k + 1, 0, -1, dtype=f32)    # z (k + 1 - i)
            w[k + 1] = np.where(o[k], w[k], f32(0))
            for i in range(k, 0, -1):
                w[i] = _fma(zm[i], w[i], np.where(o[k], w[i - 1], f32(0)))
            w[0] = w[0] * zm[0]
        w = w * f_t[uu, :uu + 1, None]
        s0 = np.zeros(x.shape[0], f32)
        for j in range(uu - 1, -1, -1):
            s0 = _fma(w[j], h_t[uu, j], s0)
        for k in range(uu):
            total = np.zeros(x.shape[0], f32)
            nxt = w[uu]
            for j in range(uu - 1, -1, -1):
                total = _fma(nxt, c_t[uu, j], total)
                nxt = _fma(-nxt, d[k, j], w[j])
            phi[fid[r, k]] += np.where(o[k], total * r1[k], s0 * r0[k])
    return phi


def _case(name):
    """(fid, z, lo, hi, u, scale, x) of one edge case: R work items,
    S samples."""
    cap, n_feat = {"cap1": (1, 16), "cap2": (2, 16), "cap4": (4, 16),
                   "cap7": (7, 7), "cap8": (8, 16)}.get(name, (16, 16))
    rs = np.random.RandomState(sum(map(ord, name)))
    fid = np.stack([rs.permutation(n_feat)[:cap] for _ in range(R)])
    u = rs.randint(1, cap + 1, size=R)
    u[:2] = (0, 1)                                  # a dead row, a 1-slot row
    z = rs.uniform(0.05, 1.0, size=(R, cap))
    thr = np.sort(rs.randn(R, cap, 2), -1)
    lo = np.where(rs.rand(R, cap) < 0.4, -BIG, thr[..., 0])
    hi = np.where(rs.rand(R, cap) < 0.4, BIG, thr[..., 1])
    x = rs.randn(S, n_feat)
    if name == "u1":
        u[:] = 1
    elif name == "z0":
        z[rs.rand(R, cap) < 0.3] = 0.0
    elif name == "all_o0":
        lo = hi = thr[..., 0]                       # empty intervals
    elif name == "all_o1":
        lo, hi = np.full_like(lo, -BIG), np.full_like(hi, BIG)
    elif name == "on_edges":
        for s in range(S):                          # x exactly on lo or hi
            r, k = rs.randint(R), rs.randint(cap)
            edge = (lo if s % 2 else hi)[r, k]
            if abs(edge) < BIG:
                x[s, fid[r, k]] = edge
    f32 = np.float32
    return (fid.astype(np.int32), z.astype(f32), lo.astype(f32),
            hi.astype(f32), u.astype(np.int32), rs.rand(R).astype(f32),
            x.astype(f32))


CASES = ["cap1", "cap2", "cap4", "cap7", "cap8", "cap16", "u1", "z0",
         "all_o0", "all_o1", "on_edges"]


@pytest.mark.parametrize("name", CASES)
def test_kernel_model_matches_plain_and_jax(name):
    args = _case(name)
    got = kernel_model(*args, tunit.unit_tables())
    plain = tunit.unit_shap_plain(*map(torch.from_numpy, args)).numpy()
    xla = np.asarray(jshap._unit_shap_xla(*map(jnp.asarray, args)))
    n_feat = args[-1].shape[1]
    assert np.isfinite(got).all()
    for want in (plain, xla.sum(0)[:n_feat, :S]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if name != "all_o0":
        assert np.abs(got).max() > 1e-3
    if name == "on_edges":      # the edges did land on some live slots
        fid, _, lo, hi, u = args[:5]
        live = np.arange(fid.shape[1]) < u[:, None]
        xv = args[-1][:, fid]                           # [S, R, cap]
        assert ((xv == lo) & live).any() and ((xv == hi) & live).any()


def test_unit_tables():
    t32 = tunit.unit_tables()
    assert t32.dtype == torch.float32 and t32.shape == (4, 17, 17)
    t = t32.double()
    for uu in (1, 7, 16):
        j = torch.arange(uu, dtype=torch.float64)
        ref = {tunit.TABLE_C: (uu + 1) / (j + 1),
               tunit.TABLE_E: (uu - j) / (j + 1),
               tunit.TABLE_H: (uu + 1) / (uu - j)}
        for row, want in ref.items():
            torch.testing.assert_close(t[row, uu, :uu], want, rtol=1e-7,
                                       atol=0)
            assert not t[row, uu, uu:].any()
        f = t[tunit.TABLE_F, uu, :uu + 1]
        torch.testing.assert_close(f[1:] / f[:-1],
                                   torch.arange(1, uu + 1).double(),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("model", ["rf", "et"])
def test_bucket_rows_sorted_by_u(model):
    """``bucket_inputs`` hands each bucket's rows over sorted by u: the same
    rows as ``pack_work_items``'s bucket (a permutation), u non-decreasing;
    and ``forest_shap_class0`` on the CPU still matches the JAX package at
    atol 1e-6."""
    rs = np.random.RandomState(4)
    x = rs.randn(160, 16).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + 0.5 * rs.randn(160)) > 0.5
    jf = jtrees.fit_forest_hist(
        jnp.asarray(x), jnp.asarray(y), jnp.ones(160), jax.random.PRNGKey(4),
        n_trees=5, sqrt_features=True, max_depth=10, max_nodes=640,
        bootstrap=model == "rf", random_splits=model == "et")
    tf = forest_from_numpy(jtrees.Forest(*[np.asarray(a) for a in jf]),
                           device="cpu")
    buckets = tshap.bucket_inputs(tf, 16)
    m_trim = max(128, -(-int(tf.n_nodes.max()) // 128) * 128)
    comp = tshap.compact_paths(
        tshap.trim_nodes(tf, m_trim) if m_trim < tf.feature.shape[1] else tf,
        int(tf.max_depth), 16)
    plan = tshap.pack_work_items(comp["u"].numpy(), comp["valid"].numpy(),
                                 n_features=16, depth=int(tf.max_depth))
    assert [c for c, _ in buckets] == [c for c, _ in plan]
    assert len(buckets) > 1
    for (cap, got), (_, rows) in zip(buckets, plan):
        u = got[4].numpy()
        assert (np.diff(u) >= 0).all()
        want = [comp[k][rows, :cap] if comp[k].dim() == 2 else comp[k][rows]
                for k in ("fid", "z", "lo", "hi", "u", "scale")]

        def table(cols):
            return np.concatenate([c.reshape(len(rows), -1).numpy()
                                   .astype(np.float64) for c in cols], 1)

        a, b = table(got), table(want)
        np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])
    xq = rs.randn(45, 16).astype(np.float32)
    want = np.asarray(jshap.forest_shap_class0(jf, jnp.asarray(xq),
                                               impl="xla"))
    got = tshap.forest_shap_class0(tf, torch.from_numpy(xq))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
