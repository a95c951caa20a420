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


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


def _inputs(seed, n_tree=3, n=600, n_feat=5, n_nodes=4, n_bins=16):
    rs = np.random.RandomState(seed)
    rel = rs.randint(-1, n_nodes + 2, size=(n_tree, n)).astype(np.int32)
    w = rs.randint(0, 6, size=(n_tree, n)).astype(np.float32)
    wy = w * (rs.rand(n) < 0.4)
    bins = rs.randint(0, n_bins, size=(n_feat, n)).astype(np.uint8)
    return rel, w, wy.astype(np.float32), bins, n_nodes, n_bins


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_bitwise_vs_pallas_kernel(seed):
    rel, w, wy, bins, n_nodes, n_bins = _inputs(seed)
    cw, cwy = hist.cum_hists_plain(*map(torch.from_numpy, (rel, w, wy, bins)),
                                   n_nodes, n_bins)
    # per-node sums reach well past 256: the f32 contraction is exact
    assert float(cw[..., -1].max()) > 256
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
