"""The histogram step (flake16_framework_tpu_torch/kernels/hist.py): its
plain version against the JAX package's Pallas kernel (interpret mode off
the TPU) and the wrapper's dispatch. Grade: bitwise (integer weights, exact
in f32). The CUDA kernel's own test is test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu_torch.kernels import hist
from torch_hist_cases import EDGE_CASES, hist_inputs as _inputs


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


@pytest.mark.parametrize("case", [
    pytest.param(dict(seed=0), id="0"),
    pytest.param(dict(seed=1), id="1"),
    *[pytest.param(kw, id=name) for name, kw in EDGE_CASES.items()],
])
def test_plain_bitwise_vs_pallas_kernel(case):
    rel, w, wy, bins, n_nodes, n_bins = _inputs(**case)
    cw, cwy = hist.cum_hists_plain(*map(torch.from_numpy, (rel, w, wy, bins)),
                                   n_nodes, n_bins)
    if set(case) == {"seed"}:
        # per-node sums reach well past 256: the f32 contraction is exact
        assert float(cw[..., -1].max()) > 256
    if case.get("mode") in ("empty", "zero_w"):
        assert not bool(cw.any()) and not bool(cwy.any())
    ohfb = jax.nn.one_hot(jnp.asarray(bins.T), n_bins, dtype=jnp.bfloat16)
    for t in range(rel.shape[0]):
        onehot = jnp.asarray(rel[t])[:, None] == jnp.arange(n_nodes)[None, :]
        ohw = (onehot * jnp.asarray(w[t])[:, None]).astype(jnp.bfloat16)
        ohwy = (onehot * jnp.asarray(wy[t])[:, None]).astype(jnp.bfloat16)
        jw, jwy = jtrees._pallas_cum_hists(ohw, ohwy, ohfb)
        assert cw[t].numpy().tobytes() == np.asarray(jw).tobytes()
        assert cwy[t].numpy().tobytes() == np.asarray(jwy).tobytes()


def test_wrapper_takes_plain_version_on_cpu_only():
    args = [torch.from_numpy(a) for a in _inputs(2)[:4]]
    before = hist.cum_hists.launches
    got = hist.cum_hists(*args, 4, 16)
    want = hist.cum_hists_plain(*args, 4, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert hist.cum_hists.launches == before      # no kernel launched
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        hist.cum_hists(*meta, 4, 16)


@pytest.mark.parametrize("n_nodes,n_bins,want", [
    (128, 64, 4 * 128 * 64 * 4 + 128 + 16),        # the main path's window
    (128, 112, 4 * 128 * 112 * 4 + 128 + 16),      # the widest B that fits
    (1, 3, 4 * 3 * 4 + 16 + 16),                   # marks rounded up to 16
    (17, 2, 4 * 17 * 2 * 4 + 32 + 16),
])
def test_smem_bytes(n_nodes, n_bins, want):
    assert hist.smem_bytes(n_nodes, n_bins) == want


def test_check_inputs_rejects_what_the_kernel_cannot_take():
    rel, w, wy, bins = (torch.from_numpy(a) for a in _inputs(0)[:4])
    hist.check_inputs(rel, w, wy, bins, 4, 16)        # accepted
    with pytest.raises(ValueError, match="contiguous"):
        hist.check_inputs(rel, w.double(), wy, bins, 4, 16)
    with pytest.raises(ValueError, match="contiguous"):
        hist.check_inputs(rel, w, wy, bins[:, ::2], 4, 16)
    # a view that starts 4 bytes into its storage: not 16-byte aligned
    off = torch.zeros(rel.numel() + 1, dtype=torch.int32)[1:].view(rel.shape)
    assert off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        hist.check_inputs(off, w, wy, bins, 4, 16)
    with pytest.raises(ValueError, match="n_bins"):
        hist.check_inputs(rel, w, wy, bins, 4, 257)
    with pytest.raises(ValueError, match="shared memory"):
        hist.check_inputs(rel, w, wy, bins, 1024, 64)
    with pytest.raises(ValueError, match="shared memory"):
        hist.check_inputs(rel, w, wy, bins, 128, 128)    # 256 KB
    hist.check_inputs(rel, w, wy, bins, 128, 112)        # 224 KB fits
    # a grid holds fewer than 2^31 (tree, 4 features) tiles; meta tensors
    # give the shapes without storage
    bins16 = torch.empty((16, 1), dtype=torch.uint8, device="meta")
    for n_tree, ok in ((2 ** 29 - 1, True), (2 ** 29, False)):
        big = [torch.empty((n_tree, 1), dtype=d, device="meta")
               for d in (torch.int32, torch.float32, torch.float32)]
        if ok:
            hist.check_inputs(*big, bins16, 4, 16)
        else:
            with pytest.raises(ValueError, match="tiles"):
                hist.check_inputs(*big, bins16, 4, 16)


@pytest.mark.parametrize("groups,case", [
    (3, dict(seed=12, n_tree=6)),
    (2, dict(seed=13, n_tree=4, n_nodes=1)),
    (6, dict(seed=14, n_tree=6, mode="halves")),
    (1, dict(seed=15)),
])
def test_plain_groups_bitwise_vs_one_group_each(groups, case):
    """``cum_hists_plain`` with G bin groups equals G separate calls, one
    group's trees against its own bins each; a [F, N] ``bin_t`` is one
    group."""
    rel, w, wy, _, n_nodes, n_bins = _inputs(**case)
    n = rel.shape[1]
    bins = np.random.RandomState(case["seed"]).randint(
        0, n_bins, size=(groups, 5, n)).astype(np.uint8)
    rel, w, wy, bins = map(torch.from_numpy, (rel, w, wy, bins))
    got = hist.cum_hists_plain(rel, w, wy, bins, n_nodes, n_bins)
    hist.check_inputs(rel, w, wy, bins, n_nodes, n_bins)
    tpg = rel.shape[0] // groups
    for g in range(groups):
        t = slice(g * tpg, (g + 1) * tpg)
        for flat in (bins[g], bins[g:g + 1]):
            want = hist.cum_hists_plain(rel[t], w[t], wy[t], flat, n_nodes,
                                        n_bins)
            for a, b in zip(got, want):
                assert a[t].numpy().tobytes() == b.numpy().tobytes()


def test_check_inputs_takes_groups_that_divide_the_trees():
    rel, w, wy, bins = (torch.from_numpy(a) for a in _inputs(0)[:4])
    hist.check_inputs(rel, w, wy, bins[None].expand(3, -1, -1).contiguous(),
                      4, 16)                    # 3 trees, 3 groups
    with pytest.raises(ValueError, match="do not split"):
        hist.check_inputs(rel, w, wy, bins[None].expand(2, -1, -1)
                          .contiguous(), 4, 16)
    with pytest.raises(ValueError, match=r"\[F, N\] or \[G, F, N\]"):
        hist.check_inputs(rel, w, wy, bins[None, None], 4, 16)
    with pytest.raises(ValueError, match="contiguous"):
        hist.check_inputs(rel, w, wy, bins[None, :, :-1], 4, 16)
