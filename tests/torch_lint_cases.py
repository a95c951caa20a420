"""Seeded violations of the port's J pack (``analysis/rules_torch.py``),
at least one per rule id but J601, each marked ``# expect <RULE>`` on its
line. J601 scopes by module (``serve/batcher.py``, ``serve/queue.py``),
so its seed is written under such a path by the test.

Never imported or collected: ``tests/test_torch_lint.py`` parses it
through the port's lint engine and asserts each rule fires at its marked
lines and nowhere else. The imports exist so the alias resolver sees
realistic bindings.
"""

import pdb

import torch
from torch import cuda as tc

from flake16_framework_tpu_torch.kernels.hist import cum_hists
from flake16_framework_tpu_torch.kernels.treeshap_unit import unit_shap
from flake16_framework_tpu_torch.resilience import faults


def unordered_schedules(configs):
    out = []
    for keys in set(configs):                       # expect J202
        out.append(keys)
    out += [k for k in {"a", "b"}]                  # expect J202
    out += [k for k in sorted(set(configs))]
    return out


def debug_leftovers(x):
    breakpoint()                                    # expect J401
    pdb.set_trace()                                 # expect J401
    return x


def syncs_in_loops(xs):
    out = []
    for x in xs:
        tc.synchronize()                            # expect J402
        out.append(x.cpu())                         # expect J402
    while xs:
        torch.cuda.synchronize()                    # expect J402
        xs = xs[1:]
    torch.cuda.synchronize()
    return out


def swallowed_launch(rel, w, wy, bins):
    try:
        return cum_hists(rel, w, wy, bins, 8, 64)
    except Exception:                               # expect J501
        return None


def swallowed_cuda_call(x):
    try:
        return x.cuda()
    except:                                         # expect J501  # noqa: E722
        return x


def routed_launch(*args):
    try:
        return unit_shap(*args)
    except Exception as e:
        raise RuntimeError(faults.classify(e)) from e


def narrow_except(x):
    try:
        return torch.cuda.current_device()
    except RuntimeError:
        return x


def torn_artifact_write(doc):
    with open("/tmp/artifact.json", "w") as fd:     # expect J701
        fd.write(doc)
    with open("/tmp/artifact.bin", mode="wb") as fd:  # expect J701
        fd.write(b"")
    with open("/tmp/events.jsonl", "a") as fd:
        fd.write(doc)


def suppressed_examples(xs):
    """Inline suppressions — the test asserts these do NOT surface."""
    breakpoint()  # f16lint: disable=J401
    for x in xs:
        torch.cuda.synchronize()  # f16lint: disable=J402
    return xs
