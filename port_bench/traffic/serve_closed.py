"""A CI scoring service under a closed loop: ``clients`` callers, each a
CI job that sends its next request only once its last one is answered.

Parameters (``workloads/<cell>.json``):

- ``clients``: the callers.
- ``rows``: rows a request; client c's k-th request takes the ``rows``
  consecutive data rows from ``(base_c + k * rows) mod (N - rows)``, each
  ``base_c`` drawn from the seed (seeded sliding windows over the data).
- ``kinds``: the kinds asked for, in equal shares (``["predict",
  "shap"]``: 1:1). Each client takes the (model, kind) pairs in blocks:
  every block of ``models * len(kinds)`` requests asks each pair once,
  in an order drawn from the seed, the client and the block. So every
  pair gets the same share of every client's requests, and no two
  clients move from pair to pair in step (a fixed rotation would keep
  the clients that one dispatch answered together on one pair, and the
  batches would grow over the run).
- ``trace``: ``{"at": s, "seconds": d}``, the stretch the traced run
  profiles; the traced run lets the service fall idle before and after
  it.
- ``check``: ``{"requests": n, "limits": {...}}``, the answers the
  reference recomputes (drawn from the seed among the window's answers
  once it has closed) and the limits of the numbers compared.

The clients are one thread of the benchmark's, not a thread each: the
service's collector and dispatchers run Python too, and a thread a client
would take the interpreter's lock from them at every answer (on the H100
that cut the service's rate by more than half). The thread sends each
client's request, then polls the requests in flight every ``POLL_S``
seconds and sends a client's next request as soon as its answer is seen.
Each request is timed from just before ``submit`` to the poll that sees
its answer (late by at most ``POLL_S`` and one pass over the clients). At
the deadline no client sends again; the requests in flight complete and
count, and the window ends at the last answer. A request refused or
failed counts as failed.

Set-up makes the data from the seed, fits and registers each of the
configuration's models (``ModelRegistry`` under the run's ``TMPDIR``) and
starts one ``ScoringService``, which captures a CUDA graph for each
(model, kind, bucket). The entry is ``ScoringService.submit``."""

import os
import random
import time

import numpy as np

from port_bench.harness import data, stats
from port_bench.reference import cv

# How often the clients' thread looks at the requests in flight.
POLL_S = 0.0002
# How long a request may stay unanswered before it counts as failed.
ANSWER_WAIT_S = 60.0


def tree_overrides(config):
    n = int(config["n_estimators"])
    return {} if n == 100 else {"Random Forest": n, "Extra Trees": n}


def setup(run):
    from flake16_framework_tpu_torch.serve.registry import ModelRegistry
    from flake16_framework_tpu_torch.serve.service import ScoringService

    cfg = run.config
    study = data.study_data(cfg, run.seed)
    registry = ModelRegistry(os.path.join(run.tmpdir, "registry"),
                             device=run.device)
    model_ids = []
    for keys in cfg["models"]:
        model = registry.fit_and_register(
            tuple(keys), study.features, study.labels,
            max_depth=int(cfg["max_depth"]),
            tree_overrides=tree_overrides(cfg), seed=data.seed32(run.seed))
        model_ids.append(model.model_id)
    service = ScoringService(registry, buckets=tuple(cfg["buckets"]),
                             device=run.device).start()
    return {"run": run, "study": study, "registry": registry,
            "service": service, "model_ids": model_ids}


class Plan:
    """Which request client c sends k-th: (model index, kind, first
    row)."""

    def __init__(self, seed, n_rows, rows, models, kinds, clients):
        rnd = random.Random(seed)
        self.bases = [rnd.randrange(n_rows - rows) for _ in range(clients)]
        self.span, self.rows = n_rows - rows, rows
        self.pairs = [(m, kind) for m in range(models) for kind in kinds]
        self.seed = seed
        self._blocks = {}

    def request(self, c, k):
        b, i = divmod(k, len(self.pairs))
        order = self._blocks.get((c, b))
        if order is None:
            order = random.Random(f"{self.seed}/{c}/{b}").sample(
                self.pairs, len(self.pairs))
            self._blocks[(c, b)] = order
        m, kind = order[i]
        return m, kind, (self.bases[c] + k * self.rows) % self.span


def plan_of(state):
    run, p = state["run"], state["run"].params
    return Plan(run.seed, state["study"].features.shape[0], int(p["rows"]),
                len(state["model_ids"]), p["kinds"], int(p["clients"]))


class _Clients:
    """The callers, driven by one thread. ``run(seconds)`` sends until the
    deadline and waits for every answer; a later ``run`` goes on with
    each client's sequence. Per client: its latencies, its answers ((k,
    answer)), its errors and when its last answer came."""

    def __init__(self, service, feats, plan, model_ids, clients):
        self.service, self.feats = service, feats
        self.plan, self.model_ids = plan, model_ids
        self.next = [0] * clients
        self.latency = [[] for _ in range(clients)]
        self.answers = [[] for _ in range(clients)]
        self.errors = [[] for _ in range(clients)]
        self.last = [0.0] * clients

    def _send(self, c, flight, deadline):
        """Client c's next request, into ``flight``; a refused one counts
        as failed and the client sends the one after, until the
        deadline."""
        while True:
            k = self.next[c]
            self.next[c] += 1
            m, kind, off = self.plan.request(c, k)
            t = time.perf_counter()
            try:
                flight[c] = (k, t, self.service.submit(
                    self.model_ids[m], self.feats[off:off + self.plan.rows],
                    kind=kind))
                return
            except Exception as e:  # refused at admission: failed
                self.errors[c].append(repr(e))
                if time.perf_counter() >= deadline:
                    return

    def run(self, seconds):
        """Every client for ``seconds``; returns the requests answered."""
        if seconds <= 0:
            return 0
        before = sum(map(len, self.latency))
        deadline = time.perf_counter() + seconds
        flight = {}
        for c in range(len(self.next)):
            self._send(c, flight, deadline)
        while flight:
            seen = False
            for c in list(flight):
                k, t, req = flight[c]
                now = time.perf_counter()
                if not req.done():
                    if now - t > ANSWER_WAIT_S:
                        self.errors[c].append("no answer")
                        del flight[c]
                    continue
                seen = True
                del flight[c]
                try:
                    out = req.result(0)
                except Exception as e:  # a request that fails: failed
                    self.errors[c].append(repr(e))
                else:
                    self.latency[c].append(now - t)
                    self.answers[c].append((k, out))
                    self.last[c] = now
                if now < deadline:
                    self._send(c, flight, deadline)
            if not seen:
                time.sleep(POLL_S)
        return sum(map(len, self.latency)) - before


def window(state, seconds, tracer):
    """The clients for ``seconds``: the rate is the requests answered over
    the time from the start to the last answer, the tail that of every
    request's latency. A traced run splits the window in three at the
    ``trace`` stretch and lets the service fall idle between them, so
    that the profiler starts and stops with nothing in flight."""
    p = state["run"].params
    clients = _Clients(state["service"], state["study"].features,
                       plan_of(state), state["model_ids"], int(p["clients"]))
    stretches = [(seconds, False)]
    if tracer.enabled:
        trace = p.get("trace", {})
        at = min(float(trace.get("at", 0.0)), seconds)
        traced = min(float(trace.get("seconds", seconds)), seconds - at)
        stretches = [(at, False), (traced, True),
                     (seconds - at - traced, False)]
    t0 = time.perf_counter()
    for length, traced in stretches:
        if traced:
            tracer.start()
        n = clients.run(length)
        if traced:
            tracer.stop(requests=n)
    lat_ms = [1e3 * v for lat in clients.latency for v in lat]
    errors = [e for errs in clients.errors for e in errs]
    done = len(lat_ms)
    return {"serve_rps": stats.rate(done, t0, max(clients.last)),
            "serve_p95_ms": stats.percentile(lat_ms, 95),
            "answers": {(c, k): out for c, got in enumerate(clients.answers)
                        for k, out in got},
            "plan": clients.plan,
            "attempted": done + len(errors), "failed": len(errors),
            "extra": {"answered": done,
                      "p50_ms": stats.percentile(lat_ms, 50),
                      "p99_ms": stats.percentile(lat_ms, 99),
                      "errors": errors[:4],
                      "window_s": max(clients.last) - t0}}


def release(state):
    service = state.pop("service", None)
    if service is not None:
        service.stop()
    state.pop("registry", None)


def sample(state, record):
    """The answers the reference recomputes: ``check.requests`` of the
    window's answered requests, drawn from the seed."""
    k = int(state["run"].params["check"]["requests"])
    got = sorted(record["answers"])
    return sorted(random.Random(state["run"].seed + 1).sample(
        got, min(k, len(got))))


def reference_models(state):
    run, study = state["run"], state["study"]
    n_trees = int(run.config["n_estimators"])
    return [cv.fit_served(tuple(k), study.features, study.labels,
                          seed=data.seed32(run.seed), device=run.device,
                          max_depth=int(run.config["max_depth"]),
                          n_trees=None if n_trees == 100 else n_trees)
            for k in run.config["models"]]


def gaps(state, record, models, answers=None):
    """The numbers compared, over the sampled answers: ``predict_max_abs``
    the widest gap of a served probability from the reference's, and
    ``shap_max_rel`` the widest gap of a served SHAP value over the
    largest reference value among the sampled SHAP answers. The reference
    answers each (model, kind)'s sampled requests in one call.
    ``answers`` ((c, k) -> answer) stands in for the served ones (the
    control's readings)."""
    feats = state["study"].features
    plan = record["plan"]
    groups = {}
    for ck in sample(state, record):
        m, kind, off = plan.request(*ck)
        groups.setdefault((m, kind), []).append((ck, off))
    pred_gap, shap_gap, shap_scale = 0.0, 0.0, 0.0
    rows = plan.rows
    for (m, kind), items in sorted(groups.items()):
        block = np.concatenate([feats[off:off + rows] for _, off in items])
        want = cv.served_answers(models[m], block, kind)
        for i, (ck, _) in enumerate(items):
            got = record["answers"][ck] if answers is None else answers[ck]
            got = np.asarray(got, np.float64)
            ref = want[i * rows:(i + 1) * rows].astype(np.float64)
            gap = float(np.abs(got - ref).max()) \
                if got.shape == ref.shape else float("inf")
            if kind == "predict":
                pred_gap = max(pred_gap, gap)
            else:
                shap_gap = max(shap_gap, gap)
                shap_scale = max(shap_scale, float(np.abs(ref).max()))
    out = {"predict_max_abs": pred_gap}
    if "shap" in state["run"].params["kinds"]:
        out["shap_max_rel"] = shap_gap / max(shap_scale, 1e-30)
    return out


def check(state, record):
    """``gaps``' numbers under the cell's limits, and the window's
    requests that were refused or failed (exact: limit 0)."""
    limits = state["run"].params["check"]["limits"]
    got = gaps(state, record, reference_models(state))
    out = {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
    out["requests_failed"] = {"value": record["failed"], "limit": 0}
    return out


def control(state, record):
    """The control's readings of ``gaps``' numbers: the reference's
    answers computed with the requests' transformed features in bfloat16,
    put in place of the served answers, against the float32 reference."""
    models = reference_models(state)
    feats = state["study"].features
    plan = record["plan"]
    answers = {}
    for ck in sample(state, record):
        m, kind, off = plan.request(*ck)
        answers[ck] = cv.served_answers(
            models[m], feats[off:off + plan.rows], kind, lowp=True)
    return gaps(state, record, models, answers=answers)
