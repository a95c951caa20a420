"""Model registry: trained-config artifacts the scoring service serves.

A *registered model* is the trained artifact of one grid config — the
node-trimmed forest, the preprocessing affine (mu, W), the feature
columns, and the config's identity (key tuple + canonical 216-order
index, the same index the fault-injection plan addresses). Registration
reuses the SHAP stage's fit (``pipeline.fit_shap_model``: preprocess ->
transform -> resample -> fit on the balanced full set) under the key
``prng_key(seed)``, so for equal data and seed it grows the JAX
package's forest bitwise (for a config that scales its features, the
scaler's mean and variance may differ from XLA's by an ulp, and so may
the forest).

Identity is the **artifact signature**: (config code, per-array name,
shape and numpy dtype) of the (forest, mu, W) artifact. Models with equal
shapes share the executable store's dispatch keys, and register ->
persist -> reload yields the same signature.

The sweep's scores ledger is the artifact *source*: ``configs_from_
ledger`` reads a (partial or complete) ``scores.pkl`` and returns its
config keys in canonical grid order. Persistence is one pickle per model
under the registry root plus a ``registry.json`` index, both in the JAX
package's ``flake16-serve-registry-v1`` schema with numpy arrays, so each
package loads the other's registry directory.
"""

import hashlib
import json
import os
import pickle
import types

import numpy as np
import torch

from flake16_framework_tpu_torch import config as cfg, rng
from flake16_framework_tpu_torch.device import resolve
from flake16_framework_tpu_torch.ops import trees
from flake16_framework_tpu_torch.pipeline import fit_shap_model
from flake16_framework_tpu_torch.utils.atomic import atomic_write
from flake16_framework_tpu_torch.weights import forest_from_numpy

REGISTRY_SCHEMA = "flake16-serve-registry-v1"
INDEX_FILE = "registry.json"


def model_id_for(config_keys):
    """Stable, filesystem-safe id for a config's artifact slot (the key
    tuple is unique per grid config, so no hash suffix is needed)."""
    return "-".join("".join(ch for ch in k.lower() if ch.isalnum())
                    for k in config_keys)


def config_index_for(config_keys):
    """The config's index in the canonical 216-order
    (config.iter_config_keys) — the address fault-injection plans and the
    sweep's per-config RNG both use. None for an off-grid tuple."""
    for i, keys in enumerate(cfg.iter_config_keys()):
        if tuple(keys) == tuple(config_keys):
            return i
    return None


class RegisteredModel:
    """One trained-config artifact: everything a serve dispatch needs.
    ``forest`` is the port's ``Forest`` and ``mu``, ``wmat`` f32 tensors,
    all on the registry's device."""

    __slots__ = ("model_id", "config_keys", "config_index", "forest",
                 "mu", "wmat", "cols", "depth", "seed", "max_depth")

    def __init__(self, *, model_id, config_keys, config_index, forest,
                 mu, wmat, cols, depth, seed, max_depth):
        self.model_id = model_id
        self.config_keys = tuple(config_keys)
        self.config_index = config_index
        self.forest = forest
        self.mu = mu
        self.wmat = wmat
        self.cols = tuple(cols)
        self.depth = int(depth)
        self.seed = int(seed)
        self.max_depth = int(max_depth)


def _artifact_arrays(model):
    """The persisted arrays of a model, {name: numpy array}: every
    ``Forest`` field (``max_depth`` as an int32 scalar), then mu and W."""
    forest = {f: getattr(model.forest, f).cpu().numpy()
              for f in trees.Forest._fields[:-1]}
    forest["max_depth"] = np.asarray(model.forest.max_depth, np.int32)
    return forest, model.mu.cpu().numpy(), model.wmat.cpu().numpy()


def artifact_signature(model):
    """(config code, ((array name, shape, numpy dtype name), ...)) of the
    served artifact — the registry's identity key, deterministic across
    processes for the same trained shapes. The executable store's
    dispatch keys are built from its shape part, so equal artifact
    signatures give equal dispatch keys at every bucket. The JAX
    package's signature holds a ``PyTreeDef`` repr instead of the names,
    so the two packages' signatures (and digests) never match."""
    def entry(name, t):
        return name, tuple(t.shape), str(t.dtype).removeprefix("torch.")

    sig = [entry(f, getattr(model.forest, f))
           for f in trees.Forest._fields[:-1]]
    sig.append(("max_depth", (), "int32"))  # persisted as an int32 scalar
    sig += [entry("mu", model.mu), entry("wmat", model.wmat)]
    return "/".join(model.config_keys), tuple(sig)


def signature_digest(model):
    return hashlib.sha1(repr(artifact_signature(model)).encode()) \
        .hexdigest()[:16]


def configs_from_ledger(scores_pkl):
    """Config key tuples present in a sweep scores ledger, in canonical
    grid order — the artifact source for "serve what the sweep scored"."""
    with open(scores_pkl, "rb") as fd:
        ledger = pickle.load(fd)
    if not isinstance(ledger, dict):
        raise ValueError(f"{scores_pkl}: not a scores ledger (want a dict)")
    present = {tuple(k) for k in ledger}
    return [keys for keys in cfg.iter_config_keys() if keys in present]


def fit_model(config_keys, feats, labels_raw, *, max_depth=48,
              tree_overrides=None, seed=0, device=None):
    """Train one config's artifact on ``device`` (``cuda`` by default) —
    ``pipeline.fit_shap_model`` with the key ``prng_key(seed)`` — then
    node-trim the forest once (to max(n_nodes) rounded up to 128 slots,
    as ``treeshap.bucket_inputs`` trims), so the artifact signature is
    stable and the SHAP rows are sized to the grown trees, not the
    fit-time bound."""
    dev = resolve(device)
    _, mu, wmat, forest = fit_shap_model(
        config_keys, feats, labels_raw, max_depth=max_depth,
        tree_overrides=tree_overrides, device=dev,
        key=rng.prng_key(seed, dev))
    # One registration-time host read (cold path, never per request).
    m = forest.feature.shape[-1]
    n_used = int(forest.n_nodes.max())
    m_trim = min(m, max(128, -(-n_used // 128) * 128))
    if m_trim < m:
        forest = trees.trim_nodes(forest, m_trim)
    return RegisteredModel(
        model_id=model_id_for(config_keys), config_keys=config_keys,
        config_index=config_index_for(config_keys), forest=forest,
        mu=mu, wmat=wmat, cols=cfg.resolve_config(config_keys)[1],
        depth=int(forest.max_depth), seed=seed, max_depth=max_depth,
    )


class ModelRegistry:
    """The registry: in-memory map + on-disk artifact store under
    ``root``, fitting and loading onto ``device`` (``cuda`` unless the
    caller asks for another; raises without CUDA). All writes are atomic
    replaces; ``load()`` rebuilds the map from disk (service restart)."""

    def __init__(self, root, *, device=None):
        self.root = root
        self.device = resolve(device)
        self._models = {}

    # -- access ----------------------------------------------------------

    def get(self, model_id):
        return self._models.get(model_id)

    def ids(self):
        return sorted(self._models)

    def models(self):
        return [self._models[m] for m in self.ids()]

    def __len__(self):
        return len(self._models)

    def __contains__(self, model_id):
        return model_id in self._models

    # -- registration ----------------------------------------------------

    def register(self, model, persist=True):
        self._models[model.model_id] = model
        if persist:
            self._persist(model)
        return model

    def fit_and_register(self, config_keys, feats, labels_raw, *,
                         max_depth=48, tree_overrides=None, seed=0,
                         persist=True):
        model = fit_model(config_keys, feats, labels_raw,
                          max_depth=max_depth, tree_overrides=tree_overrides,
                          seed=seed, device=self.device)
        return self.register(model, persist=persist)

    def register_from_ledger(self, scores_pkl, feats, labels_raw, *,
                             limit=None, **fit_kw):
        """Fit + register every config the sweep's scores ledger holds
        (canonical order; ``limit`` bounds the count for bounded service
        start)."""
        configs = configs_from_ledger(scores_pkl)
        if limit is not None:
            configs = configs[:limit]
        return [self.fit_and_register(keys, feats, labels_raw, **fit_kw)
                for keys in configs]

    # -- persistence -----------------------------------------------------

    def _persist(self, model):
        os.makedirs(self.root, exist_ok=True)
        path = os.path.join(self.root, f"{model.model_id}.pkl")
        forest, mu, wmat = _artifact_arrays(model)
        record = {
            "schema": REGISTRY_SCHEMA,
            "config_keys": list(model.config_keys),
            "config_index": model.config_index,
            "cols": list(model.cols),
            "depth": model.depth,
            "seed": model.seed,
            "max_depth": model.max_depth,
            "forest": forest,
            "mu": mu,
            "wmat": wmat,
        }
        with atomic_write(path, "wb") as fd:
            pickle.dump(record, fd)
        self._write_index()

    def _write_index(self):
        index = {
            "schema": REGISTRY_SCHEMA,
            "models": {
                m.model_id: {
                    "config": "/".join(m.config_keys),
                    "config_index": m.config_index,
                    "file": f"{m.model_id}.pkl",
                    "signature_sha1": signature_digest(m),
                } for m in self.models()
            },
        }
        path = os.path.join(self.root, INDEX_FILE)
        with atomic_write(path, "w") as fd:
            json.dump(index, fd, indent=1)

    def flush(self):
        """Re-write the on-disk index from the in-memory map — the
        drain path's registry flush. Safe on an empty registry."""
        os.makedirs(self.root, exist_ok=True)
        self._write_index()

    def load(self):
        """Rebuild the in-memory map from the on-disk index (this
        package's or the JAX package's). Returns the loaded models;
        unreadable entries are skipped (a torn artifact must not block
        serving the rest)."""
        path = os.path.join(self.root, INDEX_FILE)
        if not os.path.exists(path):
            return []
        with open(path) as fd:
            index = json.load(fd)
        loaded = []
        for model_id, entry in sorted(
                (index.get("models") or {}).items()):
            try:
                with open(os.path.join(self.root, entry["file"]),
                          "rb") as fd:
                    rec = pickle.load(fd)
                forest = forest_from_numpy(types.SimpleNamespace(
                    **{f: rec["forest"][f] for f in trees.Forest._fields}),
                    self.device)
                model = RegisteredModel(
                    model_id=model_id,
                    config_keys=tuple(rec["config_keys"]),
                    config_index=rec["config_index"], forest=forest,
                    mu=torch.as_tensor(np.asarray(rec["mu"], np.float32),
                                       device=self.device),
                    wmat=torch.as_tensor(
                        np.asarray(rec["wmat"], np.float32),
                        device=self.device),
                    cols=rec["cols"], depth=rec["depth"], seed=rec["seed"],
                    max_depth=rec["max_depth"],
                )
            except (OSError, KeyError, ValueError,
                    pickle.UnpicklingError, EOFError):
                continue
            self._models[model_id] = model
            loaded.append(model)
        return loaded
