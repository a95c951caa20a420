"""The port's CUDA kernels against their plain PyTorch versions, and the
exact grower's forests on the card against the CPU's. Imports neither jax
nor the JAX package, so it also runs where jax is not installed:
``python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py``.
Without a CUDA device every test skips. Grades: K1 bitwise (weights
whose sums are exact in f32) and bitwise across two runs; K2 within
1e-5 * max|plain| + 1e-7 and bitwise across two runs; exact-grower
forests bitwise."""

import numpy as np
import pytest
import torch

from flake16_framework_tpu_torch.kernels import hist, treeshap_unit
from torch_hist_cases import EDGE_CASES, hist_inputs


def _hist_check(args, n_nodes, n_bins):
    """One launch against the plain version, bitwise, and against a second
    launch, bitwise."""
    before = hist.cum_hists.launches
    got = hist.cum_hists(*args, n_nodes, n_bins)
    again = hist.cum_hists(*args, n_nodes, n_bins)
    want = hist.cum_hists_plain(*args, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert hist.cum_hists.launches == before + 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


# The kernel's geometry cases, then the edge cases of its data.
HIST_CASES = [
    pytest.param(dict(seed=600, n_tree=3, n=600, n_feat=5, n_nodes=4,
                      n_bins=16), id="3-600-5-4-16"),
    pytest.param(dict(seed=3000, n_tree=7, n=3000, n_feat=16, n_nodes=128,
                      n_bins=64), id="7-3000-16-128-64"),
    pytest.param(dict(seed=8000, n_tree=2, n=8000, n_feat=7, n_nodes=128,
                      n_bins=64), id="2-8000-7-128-64"),
    # an odd n: tree rows start off 16-byte boundaries (head and tail)
    pytest.param(dict(seed=7, n_tree=5, n=1001, n_feat=16, n_nodes=128,
                      n_bins=64), id="5-1001-16-128-64"),
    # the bin counts of F16_HIST_BINS's arms, each at its widest window
    # (kernels/hist.max_window): one, two, four and eight bins a lane
    pytest.param(dict(seed=32, n_tree=4, n=4000, n_feat=16, n_nodes=128,
                      n_bins=32), id="4-4000-16-128-32"),
    pytest.param(dict(seed=48, n_tree=4, n=4000, n_feat=16, n_nodes=128,
                      n_bins=48), id="4-4000-16-128-48"),
    pytest.param(dict(seed=128, n_tree=4, n=4000, n_feat=16, n_nodes=113,
                      n_bins=128), id="4-4000-16-113-128"),
    pytest.param(dict(seed=256, n_tree=4, n=4000, n_feat=16, n_nodes=56,
                      n_bins=256), id="4-4000-16-56-256"),
    *[pytest.param(kw, id=name) for name, kw in EDGE_CASES.items()],
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", HIST_CASES)
def test_hist_cumsum_bitwise_vs_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rel, w, wy, bins, n_nodes, n_bins = hist_inputs(**case)
    _hist_check([torch.from_numpy(a).cuda() for a in (rel, w, wy, bins)],
                n_nodes, n_bins)


@pytest.mark.cuda
@pytest.mark.parametrize("case", HIST_CASES)
def test_hist_cumsum_f32_passes_bitwise_vs_plain(case):
    """The kernel's f32 path (one class a pass), which takes a tile whose
    weights the packed 16-bit counts cannot hold: every live weight is
    given an extra half, so every tile with a live sample in its window
    takes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rel, w, wy, bins, n_nodes, n_bins = hist_inputs(**case)
    w = np.where(w > 0, w + 0.5, 0.0).astype(np.float32)
    wy = np.where(wy > 0, w, 0.0).astype(np.float32)
    _hist_check([torch.from_numpy(a).cuda() for a in (rel, w, wy, bins)],
                n_nodes, n_bins)


@pytest.mark.cuda
@pytest.mark.parametrize("case", HIST_CASES)
def test_hist_cumsum_groups_bitwise_vs_plain(case):
    """Bins in groups, [G, F, N]: tree t reads group t // (T / G). One
    group a tree (G = T), and the trees in one group given as [1, F, N]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rel, w, wy, bins, n_nodes, n_bins = hist_inputs(**case)
    n_tree = rel.shape[0]
    grouped = np.random.RandomState(case["seed"] + 1).randint(
        0, n_bins, size=(n_tree,) + bins.shape).astype(np.uint8)
    for b in (grouped, bins[None]):
        _hist_check([torch.from_numpy(a).cuda() for a in (rel, w, wy, b)],
                    n_nodes, n_bins)


@pytest.mark.cuda
def test_hist_cumsum_bitwise_on_real_fit_steps(monkeypatch):
    """Every BFS step of a small card fit (8 trees, depth 12), RF and ET:
    the recorded inputs through the kernel, bitwise against plain and
    across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from flake16_framework_tpu_torch import rng
    from flake16_framework_tpu_torch.ops import trees

    steps = []

    def recorder(*args):
        steps.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return hist.cum_hists(*args)

    monkeypatch.setattr(trees, "cum_hists", recorder)
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(1500, 16).astype(np.float32)).cuda()
    y = x[:, 0] - x[:, 5] + 0.5 * torch.from_numpy(
        rs.randn(1500).astype(np.float32)).cuda() > 0.8
    w = torch.from_numpy((rs.rand(1500) > 0.1).astype(np.float32)).cuda()
    for boot, rand in ((True, False), (False, True)):
        trees.fit_forest_hist(x, y, w, rng.prng_key(11, "cuda"), n_trees=8,
                              bootstrap=boot, random_splits=rand,
                              sqrt_features=True, max_depth=12)
    assert len(steps) > 10
    for rel, w_s, wy, bins, n_nodes, n_bins in steps:
        _hist_check([rel, w_s, wy, bins], n_nodes, n_bins)


@pytest.mark.cuda
def test_hist_cumsum_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rel = torch.zeros((2, 10), dtype=torch.int32, device="cuda")
    w = torch.ones((2, 10), device="cuda")
    bins = torch.zeros((3, 10), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        hist.cum_hists(rel, w.double(), w, bins, 4, 16)
    with pytest.raises(ValueError, match="shared memory"):
        hist.cum_hists(rel, w, w, bins, 1024, 64)
    off = torch.zeros(21, dtype=torch.int32, device="cuda")[1:].view(2, 10)
    with pytest.raises(ValueError, match="16-byte"):
        hist.cum_hists(off, w, w, bins, 4, 16)


def _bucket(r, cap, n_feat, seed, mode=None, s=0):
    """A packed bucket on the card and its samples x [s, n_feat]: unique
    fids per row, u in [0, cap]. ``mode``: "sorted" rows by u (as
    ``bucket_inputs`` hands them over), "u1" every u = 1, "z0" some zero
    fractions 0, "all_o0" empty intervals, "all_o1" unbounded ones,
    "on_edges" samples exactly on interval ends."""
    rs = np.random.RandomState(seed)
    fid = np.stack([rs.permutation(n_feat)[:cap] for _ in range(r)])
    u = rs.randint(0, cap + 1, size=r)
    z = rs.uniform(0.05, 1.0, size=(r, cap))
    thr = np.sort(rs.randn(r, cap, 2), -1)
    lo = np.where(rs.rand(r, cap) < 0.4, -3.4e38, thr[..., 0])
    hi = np.where(rs.rand(r, cap) < 0.4, 3.4e38, thr[..., 1])
    x = np.random.RandomState(r).randn(s, n_feat)
    if mode == "sorted":
        u = np.sort(u)
    elif mode == "u1":
        u[:] = 1
    elif mode == "z0":
        z[rs.rand(r, cap) < 0.3] = 0.0
    elif mode == "all_o0":
        lo = hi = thr[..., 0]
    elif mode == "all_o1":
        lo, hi = np.full_like(lo, -3.4e38), np.full_like(hi, 3.4e38)
    elif mode == "on_edges":
        for i in range(s):
            row, k = rs.randint(r), rs.randint(cap)
            edge = (lo if i % 2 else hi)[row, k]
            if abs(edge) < 3.4e38:
                x[i, fid[row, k]] = edge
    arrays = (fid.astype(np.int32), z.astype(np.float32),
              lo.astype(np.float32), hi.astype(np.float32),
              u.astype(np.int32), rs.rand(r).astype(np.float32),
              x.astype(np.float32))
    return [torch.from_numpy(a).cuda() for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n_feat,r,s,mode", [
    (1, 16, 40, 300, None),
    (2, 16, 2500, 128, None),
    (4, 16, 1500, 333, None),
    (7, 7, 2100, 129, None),
    (8, 16, 1024, 500, None),
    (16, 16, 1100, 257, None),
    (16, 16, 40000, 512, None),  # chunk 128: many stages, ragged last chunk
    (8, 16, 300, 128, "sorted"),    # u changes inside stages and chunks
    (16, 16, 100, 128, "sorted"),   # chunk 32 over 17 u values: 5-6 a chunk
    # chunk 128: 157 chunks, about 16 of them span a u boundary
    (16, 16, 20000, 4000, "sorted"),
    (16, 16, 512, 200, "u1"),
    (16, 16, 512, 200, "z0"),
    (16, 16, 512, 200, "all_o0"),
    (16, 16, 512, 200, "all_o1"),
    (16, 16, 512, 200, "on_edges"),
    # the grid's explain width (S = 64, half a tile) and one sample
    (16, 16, 20000, 64, "sorted"),
    (7, 7, 3000, 64, "sorted"),
    (4, 16, 600, 64, None),
    (16, 16, 5000, 1, "sorted"),
    (2, 7, 50, 1, None),
])
def test_treeshap_unit_vs_plain(cap, n_feat, r, s, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    *args, x = _bucket(r, cap, n_feat, seed=cap, mode=mode, s=s)
    before = treeshap_unit.unit_shap.launches
    got = treeshap_unit.unit_shap(*args, x)
    again = treeshap_unit.unit_shap(*args, x)
    want = treeshap_unit.unit_shap_plain(*args, x)
    torch.cuda.synchronize()
    assert treeshap_unit.unit_shap.launches == before + 2
    assert got.shape == (n_feat, s)
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()) + 1e-7, err


@pytest.mark.cuda
def test_treeshap_unit_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    args = _bucket(8, 4, 16, seed=0)[:6]
    x = torch.zeros((10, 16), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        treeshap_unit.unit_shap(*args[:4], args[4].long(), args[5], x)
    wide = _bucket(8, 17, 20, seed=0)[:6]
    with pytest.raises(ValueError, match="cap must be"):
        treeshap_unit.unit_shap(*wide, torch.zeros((10, 20), device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("n_trees,bootstrap,random_splits,sqrt_features", [
    (1, False, False, False),          # Decision Tree
    (3, True, False, True),            # the exact tier's Random Forest
    (3, False, True, True),            # the exact tier's Extra Trees
], ids=["dt", "rf", "et"])
def test_exact_forest_card_equals_cpu(n_trees, bootstrap, random_splits,
                                      sqrt_features):
    """The exact grower (no kernel of its own: sorts, scans, gathers) on
    the card, bitwise against the CPU, at a fold's full width: 8000 rows
    of which a tenth have weight 0, 16 features, node capacity 16000."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from flake16_framework_tpu_torch import rng
    from flake16_framework_tpu_torch.ops import trees

    rs = np.random.RandomState(5)
    x = rs.lognormal(size=(8000, 16)).astype(np.float32)
    x[:, 4] = np.round(x[:, 4])
    y = (np.log(x[:, 0]) - np.log(x[:, 3]) + 0.5 * rs.randn(8000)) > 0.8
    w = (rs.rand(8000) > 0.1).astype(np.float32)
    forests = [trees.fit_forest(
        torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
        torch.from_numpy(w).to(dev), rng.prng_key(4, dev), n_trees=n_trees,
        bootstrap=bootstrap, random_splits=random_splits,
        sqrt_features=sqrt_features, max_depth=48, max_nodes=16000)
        for dev in ("cpu", "cuda")]
    for fld in trees.Forest._fields[:-1]:
        assert torch.equal(getattr(forests[0], fld),
                           getattr(forests[1], fld).cpu()), fld
    assert int(forests[0].n_nodes.min()) > 100


@pytest.mark.cuda
def test_classify_real_cuda_oom():
    """A real allocator failure on the card is ``oom`` (by its type), and
    the card still works after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from flake16_framework_tpu_torch.resilience import faults

    with pytest.raises(torch.OutOfMemoryError) as ei:
        torch.empty(2 ** 40, dtype=torch.uint8, device="cuda")
    assert faults.classify(ei.value) == faults.OOM
    torch.cuda.empty_cache()
    assert int(torch.ones(4, device="cuda").sum()) == 4


_DEVICE_ASSERT = """
import torch
from flake16_framework_tpu_torch.resilience import faults
x = torch.zeros(4, device="cuda")
try:
    x[torch.tensor([10], device="cuda")] += 1
    torch.cuda.synchronize()
    print("no fault")
except Exception as e:
    print(type(e).__name__, faults.classify(e))
    try:
        torch.ones(1, device="cuda").sum().item()
        print("context alive")
    except Exception as e2:
        print("context dead", faults.classify(e2))
"""


@pytest.mark.cuda
def test_classify_real_device_side_assert():
    """A real device-side assert (an out-of-range CUDA index), caught in a
    process of its own since it kills the CUDA context: ``deterministic``,
    and so is the next CUDA call's error in that process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _DEVICE_ASSERT],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=repo))
    lines = out.stdout.split("\n")
    assert lines[0].split()[-1] == "deterministic", out.stdout + out.stderr
    assert lines[1] == "context dead deterministic", out.stdout


@pytest.mark.cuda
def test_run_config_with_journal_equals_without(tmp_path, monkeypatch):
    """One RF config at full width (N = 4000 over 26 projects, 100 trees,
    depth 48) on the card: the fold-granular journal path gives the
    scores of the path without a journal, journals its 10 folds, and a
    second engine resumes the config from those folds alone, fitting
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pickle

    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.ops import trees
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
    from flake16_framework_tpu_torch.resilience import journal as rjournal
    from flake16_framework_tpu_torch.utils.synth import make_tests_json

    tj = str(tmp_path / "tests.json")
    make_tests_json(tj, n_tests=4000, n_projects=26, seed=0)
    arrays = tests_to_arrays(load_tests(tj))
    keys = ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest")
    engine = SweepEngine(*arrays)
    plain = engine.run_config(keys)
    path = str(tmp_path / "scores.pkl.journal")
    jr = rjournal.SweepJournal.open(path, ("probe",), warn_out=None)
    # as if killed between the last fold record and the config record
    jr.record_config = lambda config_keys, value: None
    engine.journal = jr
    journaled = engine.run_config(keys)
    assert pickle.dumps(journaled[2:]) == pickle.dumps(plain[2:])
    assert jr.n_appends == 1 + 10
    jr.close()
    jr = rjournal.SweepJournal.open(path, ("probe",), warn_out=None)
    assert len(jr.partial_folds(keys)) == 10
    engine = SweepEngine(*arrays)
    engine.journal = jr
    fits = []
    real = trees.fit_forest_hist
    monkeypatch.setattr(trees, "fit_forest_hist",
                        lambda *a, **k: fits.append(1) or real(*a, **k))
    resumed = engine.run_config(keys)
    jr.close()
    assert fits == []          # every fold came from the journal
    assert pickle.dumps(resumed[2:]) == pickle.dumps(plain[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("keys", [
    ("OD", "Flake16", "PCA", "SMOTE Tomek", "Extra Trees"),
    ("NOD", "Flake16", "Scaling", "SMOTE", "Decision Tree"),
], ids=["et", "dt"])
def test_fused_config_equals_run_config(tmp_path, keys):
    """A config at full width (N = 4000 over 26 projects, 100 trees,
    depth 48) on the card through the fused path (its 10 folds' trees
    grown as one batch: through K1 with 10 bin groups, or on the exact
    grower) gives the default path's scores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pickle

    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
    from flake16_framework_tpu_torch.utils.synth import make_tests_json

    tj = str(tmp_path / "tests.json")
    make_tests_json(tj, n_tests=4000, n_projects=26, seed=0)
    arrays = tests_to_arrays(load_tests(tj))
    plain = SweepEngine(*arrays).run_config(keys)
    before = hist.cum_hists.launches
    fused = SweepEngine(*arrays, fused=True).run_config(keys)
    assert pickle.dumps(fused[2:]) == pickle.dumps(plain[2:])
    assert (hist.cum_hists.launches > before) == (keys[4] != "Decision Tree")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["path", "interventional", "interaction"])
def test_shap_grid_card_equals_cpu(tmp_path, mode):
    """``shap_grid`` on the card against the CPU at a small size (N = 400,
    8 trees, depth 12): the same forests (bitwise on both growers), so
    values within 1e-5 * max|CPU| + 1e-7; interaction matrices exactly
    symmetric; K1 launched by the ensembles' fits, K2 by the path mode.
    No config scales its features: the card's and the CPU's column means
    may differ by an ulp, and so may forests grown on them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import io

    from flake16_framework_tpu_torch.pipeline import shap_grid
    from flake16_framework_tpu_torch.utils.synth import make_dataset

    feats, labels, _ = make_dataset(n_tests=400, n_projects=6, seed=5)
    kw = dict(mode=mode, n_explain=64, n_background=32, max_depth=12,
              arrays=(feats, labels), progress_out=io.StringIO(),
              tree_overrides={"Random Forest": 8, "Extra Trees": 8},
              configs=[("NOD", "Flake16", "None", "SMOTE",
                        "Random Forest"),
                       ("OD", "FlakeFlagger", "None", "Tomek Links",
                        "Extra Trees"),
                       ("NOD", "Flake16", "None", "ENN", "Decision Tree")])
    cpu = shap_grid(device="cpu", **kw)
    k1, k2 = hist.cum_hists.launches, treeshap_unit.unit_shap.launches
    gpu = shap_grid(**kw)
    assert hist.cum_hists.launches > k1
    assert (treeshap_unit.unit_shap.launches > k2) == (mode == "path")
    assert list(gpu) == list(cpu)
    for name, c in cpu.items():
        g = gpu[name]
        assert g.dtype == np.float32 and g.shape == c.shape
        assert np.isfinite(g).all()
        err = float(np.abs(g - c).max())
        assert err <= 1e-5 * float(np.abs(c).max()) + 1e-7, (name, err)
        if mode == "interaction":
            assert np.array_equal(g, g.transpose(0, 2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("keys", [
    ("NOD", "Flake16", "None", "SMOTE", "Random Forest"),
    ("OD", "FlakeFlagger", "None", "Tomek Links", "Extra Trees"),
], ids=["rf-cap16", "et-cap7"])
def test_forest_shap_graph_card_equals_cpu(keys):
    """The single-bucket engine the scoring service runs
    (``forest_shap_graph``: one K2 launch over every (tree, leaf slot)
    row, dead rows included) on the card against the same call on the
    CPU, given the same forest (grown on the CPU at N = 400, 8 trees,
    depth 12, trimmed as the registry trims it), at the serving buckets'
    sample counts: within 1e-5 * max|CPU| + 1e-7, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from flake16_framework_tpu_torch.ops import trees, treeshap
    from flake16_framework_tpu_torch.serve.registry import fit_model
    from flake16_framework_tpu_torch.utils.synth import make_dataset

    feats, labels, _ = make_dataset(n_tests=400, n_projects=6, seed=5)
    model = fit_model(keys, feats, labels, max_depth=12, device="cpu",
                      tree_overrides={"Random Forest": 8, "Extra Trees": 8})
    cpu_forest = model.forest
    gpu_forest = trees.Forest(*(t.cuda() for t in cpu_forest[:-1]),
                              cpu_forest.max_depth)
    xp = (torch.from_numpy(feats[:, list(model.cols)].astype(np.float32))
          - model.mu) @ model.wmat
    for s in (8, 32, 128):
        x = xp[:s].contiguous()
        want = treeshap.forest_shap_graph(cpu_forest, x)
        before = treeshap_unit.unit_shap.launches
        got = treeshap.forest_shap_graph(gpu_forest, x.cuda())
        torch.cuda.synchronize()
        assert treeshap_unit.unit_shap.launches == before + 1
        assert got.shape == want.shape == (s, len(model.cols))
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()) + 1e-7, (s, err)
        assert float(want.abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_guard_watchdog_on_the_card(device):
    """The dispatch guard with its watchdog on (``envelope_s``) runs the
    thunk in a worker thread, which sets the caller's CUDA device: given
    as plain "cuda" (no index, as ``device.resolve`` gives it) or with an
    index, the guarded call completes with the thunk's result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from flake16_framework_tpu_torch.resilience.guard import (
        BackoffPolicy, DispatchGuard,
    )

    g = DispatchGuard(policy=BackoffPolicy(max_attempts=1), envelope_s=60.0,
                      device=torch.device(device))
    x = torch.arange(8, device="cuda", dtype=torch.float32)
    out = g.call(lambda: (x * 2).sum(), label="watchdog")
    assert float(out) == 56.0 and not g.retries


@pytest.mark.cuda
def test_fleet_on_the_card_launches_k2_in_its_workers(tmp_path):
    """A 2-worker fleet on the default device (``cuda``) over a persisted
    registry of one small ET model: each worker warms on the card (one K2
    launch a bucket), and one SHAP request through the router adds one K2
    launch in the worker that served it, read through ``stats``; the
    answer equals the in-process service's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from flake16_framework_tpu_torch.serve import ModelRegistry, ScoringService
    from flake16_framework_tpu_torch.serve.fleet import Fleet
    from flake16_framework_tpu_torch.serve.router import FleetRouter
    from flake16_framework_tpu_torch.utils.synth import make_dataset

    feats, labels, _ = make_dataset(n_tests=400, n_projects=6, seed=5)
    registry = ModelRegistry(str(tmp_path / "registry"))
    registry.fit_and_register(
        ("NOD", "Flake16", "None", "SMOTE Tomek", "Extra Trees"), feats,
        labels, max_depth=12, tree_overrides={"Extra Trees": 8})
    mid = registry.ids()[0]
    buckets = (8, 32)
    with Fleet(registry.root, 2, workdir=str(tmp_path / "work"),
               buckets=buckets, ready_timeout_s=180) as fleet:
        # no hedge: one request, one dispatch
        with FleetRouter(fleet, hedge_ms=60000.0) as router:
            before = router.scrape_worker_stats()
            assert sorted(before) == [0, 1]
            for st in before.values():
                assert st["device"].startswith("cuda")
                assert st["launches"]["treeshap_unit"] == len(buckets)
                assert st["launches"]["hist_cumsum"] == 0
                assert st["max_memory_allocated_mb"] > 0
            got = router.score(mid, feats[:8], kind="shap", timeout=120)
            after = router.scrape_worker_stats()
    grew = sum(after[i]["launches"]["treeshap_unit"]
               - before[i]["launches"]["treeshap_unit"] for i in (0, 1))
    assert grew == 1
    with ScoringService(registry, buckets=buckets) as svc:
        want = svc.score(mid, feats[:8], kind="shap", timeout=120)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _graph_registry(tmp_path):
    """A registry of two small models (ET on K1, a Decision Tree) and the
    raw feature matrix."""
    from flake16_framework_tpu_torch.serve import ModelRegistry
    from flake16_framework_tpu_torch.utils.synth import make_dataset

    feats, labels, _ = make_dataset(n_tests=400, n_projects=6, seed=5)
    registry = ModelRegistry(str(tmp_path / "registry"))
    for keys in (("NOD", "Flake16", "None", "SMOTE Tomek", "Extra Trees"),
                 ("OD", "Flake16", "Scaling", "SMOTE", "Decision Tree")):
        registry.fit_and_register(keys, feats, labels, max_depth=12,
                                  tree_overrides={"Extra Trees": 8})
    return registry, feats


def _eager(store, model, kind, x):
    """The cache's eager body on the store's prepared model."""
    fn, args, _ = store.audit_handles(model, x)[f"serve.{kind}"]
    return fn(*args)


@pytest.mark.cuda
def test_serve_graph_replays_equal_eager_bodies(tmp_path):
    """The serving store's CUDA graphs (``obs/aot.py``): warm captures one
    graph a (model, kind, bucket) (``compiles`` grows by their number);
    each replay equals the eager body on the same batch, predict bitwise
    and SHAP within 1e-5 * max|eager| + 1e-7; a SHAP replay counts one K2
    launch and a predict replay none; a reload drops the model's graphs
    and the next call captures again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from flake16_framework_tpu_torch.obs import aot
    from flake16_framework_tpu_torch.serve.store import KINDS, ExecutableStore

    registry, feats = _graph_registry(tmp_path)
    store = ExecutableStore(registry)
    buckets = (8, 32)
    c0 = aot.dispatch_stats()["compiles"]
    for model in registry.models():
        store.warm(model, buckets)
    assert aot.dispatch_stats()["compiles"] - c0 == \
        len(registry) * len(KINDS) * len(buckets)
    rs = np.random.RandomState(0)
    for model in registry.models():
        for bucket in buckets:
            rows = rs.choice(len(feats), bucket)
            x = np.ascontiguousarray(feats[rows][:, list(model.cols)],
                                     dtype=np.float32)
            for kind in KINDS:
                k2 = treeshap_unit.unit_shap.launches
                got = store.call(model, kind, x)
                torch.cuda.synchronize()
                assert treeshap_unit.unit_shap.launches - k2 == \
                    (kind == "shap")
                want = _eager(store, model, kind, x)
                if kind == "predict":
                    assert torch.equal(got, want)
                else:
                    err = float((got - want).abs().max())
                    assert err <= 1e-5 * float(want.abs().max()) + 1e-7
    model = registry.models()[0]
    registry.register(type(model)(**{k: getattr(model, k)
                                     for k in model.__slots__}),
                      persist=False)
    reloaded = registry.get(model.model_id)
    assert reloaded is not model
    c1 = aot.dispatch_stats()["compiles"]
    x = np.zeros((8, len(model.cols)), dtype=np.float32)
    store.call(reloaded, "shap", x)
    assert aot.dispatch_stats()["compiles"] - c1 == 1


@pytest.mark.cuda
def test_serve_graph_replays_the_windows_walk(tmp_path, monkeypatch):
    """Under ``F16_PREDICT_IMPL=windows`` the store captures the windows
    walk: the warm-up run makes its plan, so the capture reads nothing
    from the device (a read would fail the capture). Each predict replay
    equals the eager windows and gather bodies bitwise and runs no K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from flake16_framework_tpu_torch.serve.store import ExecutableStore

    monkeypatch.setenv("F16_PREDICT_IMPL", "windows")
    registry, feats = _graph_registry(tmp_path)
    store = ExecutableStore(registry)
    rs = np.random.RandomState(1)
    for model in registry.models():
        store.warm(model, (8, 32))
        assert list(store._prepare(model).walk_plans) == [128]
        for bucket in (8, 32):
            x = np.ascontiguousarray(
                feats[rs.choice(len(feats), bucket)][:, list(model.cols)],
                dtype=np.float32)
            k2 = treeshap_unit.unit_shap.launches
            got = store.call(model, "predict", x)
            torch.cuda.synchronize()
            assert treeshap_unit.unit_shap.launches == k2
            windows = _eager(store, model, "predict", x)
            monkeypatch.setenv("F16_PREDICT_IMPL", "gather")
            gather = _eager(store, model, "predict", x)
            monkeypatch.setenv("F16_PREDICT_IMPL", "windows")
            assert torch.equal(got, windows) and torch.equal(got, gather)


@pytest.mark.cuda
def test_serve_graph_concurrent_replays(tmp_path):
    """Two threads replaying one (model, kind, bucket) graph with
    different batches each get their own answer (the graph's lock holds
    its static buffers for one caller at a time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import threading

    from flake16_framework_tpu_torch.serve.store import ExecutableStore

    registry, feats = _graph_registry(tmp_path)
    store = ExecutableStore(registry)
    model = registry.models()[0]
    store.warm(model, (32,))
    xs = [np.ascontiguousarray(feats[i * 32:(i + 1) * 32][:, list(model.cols)],
                               dtype=np.float32) for i in range(2)]
    want = [_eager(store, model, kind, x).cpu()
            for x in xs for kind in ("predict", "shap")]
    got = {}

    def run(i):
        torch.cuda.set_device(store.device)
        for _ in range(50):
            out = [store.call(model, kind, xs[i]).cpu()
                   for kind in ("predict", "shap")]
        got[i] = out

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(2):
        assert torch.equal(got[i][0], want[2 * i])
        err = float((got[i][1] - want[2 * i + 1]).abs().max())
        assert err <= 1e-5 * float(want[2 * i + 1].abs().max()) + 1e-7
    assert not torch.equal(got[0][0], got[1][0])
