"""Executable store: the serving layer's prepared programs.

PyTorch has no ahead-of-time executable, so where the JAX package
compiles each (kind, bucket) program once, this store *prepares* each
model once on its device: the forest, mu and W, and the single-bucket
SHAP rows (``treeshap.graph_inputs``), which depend only on the model.
``warm`` then runs one zero batch for each (kind, bucket), so the kernel
library is loaded and the allocator's blocks exist before the first
request.

The preprocessing affine is applied on the device (``transform(x, mu,
W)`` before the forest walk), so a request carries raw selected-column
features and the padded batch crosses to the device exactly once. SHAP
values are w.r.t. the transformed coordinates — the same convention the
study's explain stage uses.

SHAP on a CUDA tensor goes through ``kernels.treeshap_unit.unit_shap``,
which launches the kernel or raises: there is no fallback arm. A warm
failure stops the service from starting; a call-time fault goes to the
batcher's guard and quarantine.

``audit_handles`` gives the audit (``analysis/rules_ir.serve_entries``)
the serving entry points as calls on a prepared model. The port has no
ahead-of-time cache and one SHAP route, so where the JAX store hands out
``serve.predict``, ``serve.shap_xla`` and ``serve.shap_pallas``, this one
hands out ``serve.predict`` and ``serve.shap``.
"""

import hashlib
import json
from typing import NamedTuple

import numpy as np
import torch

from flake16_framework_tpu_torch.device import resolve
from flake16_framework_tpu_torch.ops import trees, treeshap
from flake16_framework_tpu_torch.ops.preprocess import transform
from flake16_framework_tpu_torch.serve.registry import artifact_signature
from flake16_framework_tpu_torch.utils.atomic import atomic_write

KINDS = ("predict", "shap")

MANIFEST_FILE = "aot_manifest.json"
MANIFEST_SCHEMA = "flake16-serve-aot-manifest-v1"


def signature_digest(sig):
    """Short stable digest of one dispatch signature — the JSON-able form
    the warm manifest stores."""
    return hashlib.sha1(repr(sig).encode()).hexdigest()[:16]


class _Prepared(NamedTuple):
    """The request-independent part of one model on the store's device."""

    model: object
    forest: trees.Forest
    mu: torch.Tensor
    wmat: torch.Tensor
    shap_rows: tuple
    n_trees: int


class ExecutableStore:
    """Prepared predict + SHAP programs for a registry's models on
    ``device`` (``cuda`` unless the caller asks for another). A CUDA
    device without an index is pinned to the current one, so that the
    dispatcher threads can set it."""

    def __init__(self, registry, *, device=None):
        self.registry = registry
        dev = resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._prepared = {}

    # -- internals -------------------------------------------------------

    def _prepare(self, model):
        """The model's prepared part, made on first use and whenever the
        registry's model object for its id changed (a reload)."""
        prep = self._prepared.get(model.model_id)
        if prep is not None and prep.model is model:
            return prep
        dev = self.device
        forest = trees.Forest(*(t.to(dev) for t in model.forest[:-1]),
                              model.forest.max_depth)
        prep = _Prepared(model, forest, model.mu.to(dev),
                         model.wmat.to(dev),
                         treeshap.graph_inputs(forest, len(model.cols)),
                         forest.feature.shape[0])
        self._prepared[model.model_id] = prep
        return prep

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- warm / signatures ----------------------------------------------

    def warm(self, model, bucket_sizes):
        """Prepare one model and run a zero batch of every (kind,
        bucket). Returns {(kind, bucket): signature}. Any failure
        (a kernel that does not build or launch included) propagates: an
        unservable model must fail at start, not at the first request."""
        self._prepare(model)
        sigs = {}
        for bucket in bucket_sizes:
            x = np.zeros((bucket, len(model.cols)), dtype=np.float32)
            keys = self.signatures(model, bucket)
            for kind in KINDS:
                self.call(model, kind, x)
                sigs[(kind, bucket)] = keys[kind]
        self._sync()
        return sigs

    def signatures(self, model, bucket):
        """The dispatch keys one model produces at one bucket, computed
        WITHOUT running anything: the artifact's shapes, the batch shape
        and, for SHAP, the depth bound. Models with equal shapes share
        them; register -> persist -> reload keeps them."""
        shapes = artifact_signature(model)[1]
        x = ((int(bucket), len(model.cols)), "float32")
        return {"predict": ("serve.predict", shapes, x),
                "shap": ("serve.shap", shapes, x, model.depth)}

    def warm_manifest(self, models, buckets):
        """{model_id: {"kind@bucket": digest}} over every registered
        (kind, bucket) pair, from :meth:`signatures` (nothing runs).
        Equal manifests before a drain and after a reload mean the
        reloaded service dispatches on the very keys the drained one
        warmed — the reload-warm contract's check value."""
        out = {}
        for model in models:
            entry = {}
            for bucket in buckets:
                sigs = self.signatures(model, bucket)
                for kind in KINDS:
                    entry[f"{kind}@{int(bucket)}"] = signature_digest(
                        sigs[kind])
            out[model.model_id] = entry
        return out

    def flush_manifest(self, path, models, buckets):
        """Atomically write the warm manifest JSON — the drain path's
        store flush. ``backend`` is the torch device type. Returns the
        manifest dict."""
        manifest = {
            "schema": MANIFEST_SCHEMA,
            "backend": self.device.type,
            "buckets": [int(b) for b in buckets],
            "models": self.warm_manifest(models, buckets),
        }
        with atomic_write(path, "w") as fd:
            json.dump(manifest, fd, indent=1, sort_keys=True)
        return manifest

    def audit_handles(self, model, x):
        """{entry name: (fn, args, kwargs)} for every serving entry point:
        ``serve.predict`` and ``serve.shap``, each ``call`` of ``model``
        (prepared here, so that the preparation is not part of an entry)
        on the padded host batch ``x`` [bucket, F] f32 — what every live
        request dispatches through, run by the audit's recorder."""
        self._prepare(model)
        x = np.ascontiguousarray(x, dtype=np.float32)
        return {f"serve.{kind}": (self.call, (model, kind, x), {})
                for kind in KINDS}

    # -- dispatch --------------------------------------------------------

    def call(self, model, kind, x):
        """One padded batch x [bucket, F] (host f32) through ``kind``:
        predict gives the soft vote [bucket, 2], SHAP the class-0 values
        [bucket, F] (one unit launch on the prepared rows). Returns a
        tensor on the device; called from inside the batcher's guard."""
        prep = self._prepare(model)
        xp = transform(torch.as_tensor(x, device=self.device), prep.mu,
                       prep.wmat)
        if kind == "predict":
            return trees.predict_proba(prep.forest, xp)
        if kind != "shap":
            raise ValueError(f"unknown serve kind: {kind!r}")
        return treeshap.graph_shap(prep.shap_rows, prep.n_trees,
                                   xp.contiguous())
