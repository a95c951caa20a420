"""Executable store: the serving layer's captured programs.

Each model is *prepared* once on the store's device: the forest, mu and
W, and the single-bucket SHAP rows (``treeshap.graph_inputs``), which
depend only on the model. Predict and SHAP then go through two
``obs.aot.AotExecutableCache``s, ``serve.predict`` and ``serve.shap``,
the counterparts of the JAX package's compiled executables: on the card,
``warm`` captures one CUDA graph per (model, kind, bucket), and ``call``
copies the padded batch into the graph's static input, replays it and
returns a clone of its output. A graph bakes its model's tensors in by
address, so models of equal shapes share a signature (the warm
manifest's keys) but not a graph. A graph also keeps the predict walk
(``F16_PREDICT_IMPL``, ``F16_PREDICT_WINDOW``) it was captured with: a
change of either after warm takes effect on new captures only (a model
reloaded, or a bucket first called), and on a ``cpu`` device at the next
call. ``_prepare``'s reload (a new model
object for an id) drops that model's graphs; each is captured anew at its
first call.

The preprocessing affine is applied on the device (``transform(x, mu,
W)`` before the forest walk, inside the graph), so a request carries raw
selected-column features and the padded batch crosses to the device
exactly once. SHAP values are w.r.t. the transformed coordinates — the
same convention the study's explain stage uses.

SHAP is one K2 launch on the prepared rows (``kernels.treeshap_unit.
unit_shap``, which launches the kernel or raises). There is no fallback:
a capture or warm failure stops the service from starting; a call-time
fault, a replay's included, surfaces at the guard's synchronize and goes
to the batcher's guard and quarantine. On a ``cpu`` device the caches run
the eager bodies.

``audit_handles`` gives the audit (``analysis/rules_ir.serve_entries``)
the eager bodies (``traceable()``), as the JAX store hands out its
executables' traceable functions, so the audit never touches the
dispatch census. The port has one SHAP route, so where the JAX store
hands out ``serve.predict``, ``serve.shap_xla`` and ``serve.shap_pallas``,
this one hands out ``serve.predict`` and ``serve.shap``.
"""

import hashlib
import json
from typing import NamedTuple

import numpy as np
import torch

from flake16_framework_tpu_torch.device import resolve
from flake16_framework_tpu_torch.obs.aot import AotExecutableCache
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
    walk_plans: dict


def _predict_body(prep, x):
    """The soft vote [bucket, 2] of a device batch x [bucket, F], through
    the walk ``F16_PREDICT_IMPL`` names. The windows walk's plan is kept
    in ``prep.walk_plans``: the warm-up run before a capture makes it, so
    the capture reads nothing from the device."""
    return trees.predict_proba(prep.forest, transform(x, prep.mu, prep.wmat),
                               plans=prep.walk_plans)


def _shap_body(prep, x):
    """The class-0 SHAP values [bucket, F] of a device batch x: one unit
    launch on the prepared rows."""
    return treeshap.graph_shap(prep.shap_rows, prep.n_trees,
                               transform(x, prep.mu, prep.wmat).contiguous())


def _model(arg):
    return getattr(arg, "model", arg)


def _batch_key(x):
    return (tuple(int(d) for d in np.shape(x)), "float32")


def _predict_key(args, kwargs):
    """The artifact's shapes and the batch shape; ``args[0]`` is a model
    or its prepared part."""
    return (artifact_signature(_model(args[0]))[1], _batch_key(args[1]))


def _shap_key(args, kwargs):
    """``_predict_key`` and the model's depth bound."""
    return (*_predict_key(args, kwargs), _model(args[0]).depth)


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
        self._caches = {
            "predict": AotExecutableCache(_predict_body, "serve.predict",
                                          _predict_key, device=dev),
            "shap": AotExecutableCache(_shap_body, "serve.shap", _shap_key,
                                       device=dev)}

    # -- internals -------------------------------------------------------

    def _prepare(self, model):
        """The model's prepared part, made on first use and whenever the
        registry's model object for its id changed (a reload, which drops
        the old object's graphs)."""
        prep = self._prepared.get(model.model_id)
        if prep is not None and prep.model is model:
            return prep
        if prep is not None:
            for cache in self._caches.values():
                cache.drop(model.model_id)
        dev = self.device
        forest = trees.Forest(*(t.to(dev) for t in model.forest[:-1]),
                              model.forest.max_depth)
        prep = _Prepared(model, forest, model.mu.to(dev),
                         model.wmat.to(dev),
                         treeshap.graph_inputs(forest, len(model.cols)),
                         forest.feature.shape[0], {})
        self._prepared[model.model_id] = prep
        return prep

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _cache(self, kind):
        cache = self._caches.get(kind)
        if cache is None:
            raise ValueError(f"unknown serve kind: {kind!r}")
        return cache

    # -- warm / signatures ----------------------------------------------

    def warm(self, model, bucket_sizes):
        """Prepare one model and capture every (kind, bucket) on a zero
        batch (on the CPU: run it). Returns {(kind, bucket): signature}.
        Any failure (a kernel that does not build or launch, a capture
        error) propagates: an unservable model must fail at start, not at
        the first request."""
        prep = self._prepare(model)
        sigs = {}
        for bucket in bucket_sizes:
            x = np.zeros((bucket, len(model.cols)), dtype=np.float32)
            for kind in KINDS:
                sigs[(kind, bucket)] = self._caches[kind].warm(
                    model.model_id, prep, x)
        self._sync()
        return sigs

    def signatures(self, model, bucket):
        """The dispatch keys one model produces at one bucket, computed
        WITHOUT running anything: the artifact's shapes, the batch shape
        and, for SHAP, the depth bound. Models with equal shapes share
        them; register -> persist -> reload keeps them."""
        x = np.empty((int(bucket), len(model.cols)), dtype=np.float32)
        return {kind: self._caches[kind].signature((model, x), {})
                for kind in KINDS}

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
        ``serve.predict`` and ``serve.shap``, each its cache's eager body
        (``traceable()``) on ``model``'s prepared part (made here, so that
        the preparation is not part of an entry) and the padded batch
        ``x`` [bucket, F] f32 on the store's device — what every graph
        replays, run by the audit's recorder without a dispatch."""
        prep = self._prepare(model)
        x = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                            device=self.device)
        return {cache.name: (cache.traceable(), (prep, x), {})
                for cache in self._caches.values()}

    # -- dispatch --------------------------------------------------------

    def call(self, model, kind, x):
        """One padded batch x [bucket, F] (host f32) through ``kind``'s
        graph: predict gives the soft vote [bucket, 2], SHAP the class-0
        values [bucket, F] (one unit launch on the prepared rows). Returns
        a tensor on the device; called from inside the batcher's guard,
        whose synchronize surfaces a replay's fault."""
        cache = self._cache(kind)
        return cache(model.model_id, self._prepare(model),
                     np.ascontiguousarray(x, dtype=np.float32))
