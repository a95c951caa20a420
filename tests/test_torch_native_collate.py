"""The port's native collation module (``native/collate_fast.cc`` through
``native.load``): its two functions against the port's plain versions and
the JAX package's, on the seeded cases of ``tests/test_native_collate.py``;
two processes building at once; and a failed build, which raises with the
compiler's output instead of falling back to the Python bodies."""

import random
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from flake16_framework_tpu.runner import collate as JC
from flake16_framework_tpu_torch import native
from flake16_framework_tpu_torch.runner import collate as TC

REPO = Path(__file__).resolve().parents[1]


def _random_blob(rng, n):
    return bytes(rng.randrange(256) for _ in range(n))


def _coverage_case():
    rng = random.Random(1)
    cov = {
        f"src/m{i}.py": {rng.randrange(500) for _ in range(rng.randrange(80))}
        for i in range(30)
    }
    cov["tests/test_x.py"] = {1, 2, 3}
    test_files = {"tests/test_x.py", "tests/test_y.py"}
    churn = {
        f"src/m{i}.py": {line: rng.randrange(5) for line in range(0, 500, 3)}
        for i in range(0, 30, 2)
    }
    return cov, test_files, churn


@pytest.mark.parametrize("n", [0, 1, 7, 64, 1000])
def test_numbits_to_lines_native_equals_plain(n):
    rng = random.Random(0)
    for size in (0, 1, 7, 64, 1000):   # the JAX test's draws, in its order
        blob = _random_blob(rng, size)
        if size == n:
            break
    got = native.load().numbits_to_lines(blob)
    assert got == TC._numbits_to_lines_py(blob)
    assert got == JC._numbits_to_lines_py(blob)
    assert TC.numbits_to_lines(blob) == got
    assert TC.numbits_to_lines(b"\x81") == {0, 7}


def test_coverage_features_native_equals_plain():
    cov, test_files, churn = _coverage_case()
    mod = native.load()
    want = JC._coverage_features_py(cov, test_files, churn)
    assert mod.coverage_features(cov, test_files, churn) == want
    assert TC._coverage_features_py(cov, test_files, churn) == want
    assert TC.coverage_features(cov, test_files, churn) == want
    # empty churn, empty coverage, and a file missing from churn
    for case in (({}, test_files, {}), (cov, test_files, {}),
                 ({"src/m1.py": {1, 2}}, set(), churn)):
        assert TC.coverage_features(*case) == \
            JC._coverage_features_py(*case) == \
            TC._coverage_features_py(*case)


_BUILD_CHILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    from flake16_framework_tpu_torch import native
    native.BUILD_DIR = Path(sys.argv[1])
    mod = native.load()
    assert mod.numbits_to_lines(b"\\x03\\x80") == {0, 1, 15}
    assert mod.coverage_features({"a": {1, 2}}, set(), {"a": {2: 5}}) \\
        == (2, 5, 2)
    print("ok", flush=True)
""")


def test_two_processes_build_at_once(tmp_path):
    build = tmp_path / "_build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_CHILD, str(build)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all(out.strip() == "ok" for out, _ in outs)
    names = sorted(f.name for f in build.iterdir())
    assert len(names) == 1 and names[0].startswith("_collate_fast-") \
        and names[0].endswith(".so"), names


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_compile_cmd", lambda src, out: [
        sys.executable, "-c",
        "import sys; sys.stderr.write('boom: no such header'); sys.exit(3)"])
    with pytest.raises(native.NativeBuildError,
                       match="(?s)exit 3.*boom: no such header"):
        native.load()
    # the collation's entry points raise too: no Python path is taken
    with pytest.raises(native.NativeBuildError):
        TC.numbits_to_lines(b"\x01")
    with pytest.raises(native.NativeBuildError):
        TC.coverage_features({}, set(), {})
    assert list(tmp_path.iterdir()) == []
