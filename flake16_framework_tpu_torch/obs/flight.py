"""Flight recorder: a crash-surviving ring buffer of the last N
telemetry events (a copy of the JAX package's ``obs/flight.py``: the same
file format, so each package replays the other's ring).

The JSONL sink is append-only and unbounded: a SIGKILL'd serving worker
leaves a sink whose useful tail is buried in hours of events. The flight
recorder is the complement: a FIXED-SIZE mmap'd ring file holding only
the most recent events, written with the journal's CRC record discipline
(resilience/journal.py), so the fleet manager can replay a valid tail
out of the corpse no matter where the kill landed.

Arming — same contract as ``F16_TELEMETRY``: unset/empty = off with
zero overhead; ``F16_FLIGHT=1`` = ring at ``<run_dir>/flight.bin``;
any other value = the ring file path (what the fleet manager uses — the
parent must know the path to dump it). When armed, ``obs.core._emit``
mirrors every event into the ring.

On-disk format:

- 64-byte header: ``<8sIIQQ`` — magic ``F16FLT01``, version, capacity
  (ring bytes, excluding the header), ``head`` and ``tail`` (logical
  monotonic byte offsets; the ring region holds bytes
  ``[head % cap, tail % cap)`` wrap-around).
- records: ``<II`` (payload length, crc32) + UTF-8 JSON payload (the
  replayer runs in a DIFFERENT process and must never unpickle a
  corpse's bytes).

Torn-tail rule (longest valid prefix): the writer makes room by
advancing ``head`` past whole old records, writes the record bytes,
THEN publishes ``tail`` — so a kill between any two instructions leaves
``[head, tail)`` a valid record sequence and at worst an unpublished
torn record past ``tail``. ``replay`` walks records from ``head``,
validating length sanity + CRC, and stops at the first invalid record
with ``torn=True`` instead of failing.
"""

import json
import mmap
import os
import struct
import sys
import threading
import time
import zlib

_MAGIC = b"F16FLT01"
_VERSION = 1
_HEADER = struct.Struct("<8sIIQQ")  # magic, version, capacity, head, tail
HEADER_SIZE = 64
_REC = struct.Struct("<II")         # payload length, crc32(payload)
DEFAULT_CAPACITY = 1 << 18          # 256 KiB of tail ~ thousands of events


class FlightRecorder:
    """The writer half: an mmap'd ring this process appends events to.

    Opening RESETS the ring (head = tail = 0): one process = one flight;
    the previous occupant's tail is the fleet manager's to dump BEFORE it
    restarts the child. ``record`` is called under obs.core's emit path
    only (telemetry on + F16_FLIGHT armed), so the disabled path stays
    zero-overhead."""

    def __init__(self, path, capacity=DEFAULT_CAPACITY):
        self.path = path
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._head = 0
        self._tail = 0
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            os.ftruncate(fd, HEADER_SIZE + self.capacity)
            self._mm = mmap.mmap(fd, HEADER_SIZE + self.capacity)
        finally:
            os.close(fd)
        self._write_header()

    def _write_header(self):
        _HEADER.pack_into(self._mm, 0, _MAGIC, _VERSION, self.capacity,
                          self._head, self._tail)

    def _record_size_at(self, pos):
        """Whole-record size (framing + payload) at logical offset
        ``pos`` — the writer's room-making step; [head, tail) is valid
        by construction so the prefix is always readable."""
        prefix = self._read_ring(pos, _REC.size)
        length, _ = _REC.unpack(prefix)
        return _REC.size + length

    def _read_ring(self, pos, n):
        cap = self.capacity
        off = pos % cap
        first = min(n, cap - off)
        out = self._mm[HEADER_SIZE + off:HEADER_SIZE + off + first]
        if first < n:
            out += self._mm[HEADER_SIZE:HEADER_SIZE + (n - first)]
        return out

    def _write_ring(self, pos, data):
        cap = self.capacity
        off = pos % cap
        first = min(len(data), cap - off)
        self._mm[HEADER_SIZE + off:HEADER_SIZE + off + first] = data[:first]
        if first < len(data):
            self._mm[HEADER_SIZE:HEADER_SIZE + len(data) - first] = \
                data[first:]

    def record(self, obj):
        """Append one event dict; oldest records fall off the ring."""
        payload = json.dumps(obj, default=str).encode()
        rec = _REC.pack(len(payload), zlib.crc32(payload)) + payload
        if len(rec) > self.capacity:
            return  # pathological single record; never wedge the ring
        with self._lock:
            # Make room: advance head past whole old records, publish it
            # BEFORE overwriting their bytes (a kill mid-write must not
            # leave head pointing into clobbered bytes).
            while self._tail + len(rec) - self._head > self.capacity:
                self._head += self._record_size_at(self._head)
            self._write_header()
            self._write_ring(self._tail, rec)
            self._tail += len(rec)
            self._write_header()

    def close(self):
        # Under the ring lock: a record() racing close() must either
        # complete against the live mmap or see the closed one's
        # ValueError — never interleave with flush (f16race dogfood).
        with self._lock:
            try:
                self._mm.flush()
                self._mm.close()
            except (ValueError, OSError):
                pass


# -- replay (the parent / report side; plain reads, no mmap) ------------


def replay(path):
    """(records, meta) from a flight ring file — the longest valid
    record prefix of ``[head, tail)``. ``meta`` carries head/tail, the
    record count, and ``torn`` (True when an invalid record cut the walk
    short — expected after a kill mid-append, never an error)."""
    with open(path, "rb") as fd:
        blob = fd.read()
    if len(blob) < HEADER_SIZE:
        raise ValueError(f"flight file {path!r} too short for a header")
    magic, version, cap, head, tail = _HEADER.unpack_from(blob, 0)
    if magic != _MAGIC:
        raise ValueError(f"flight file {path!r} has bad magic {magic!r}")
    ring = blob[HEADER_SIZE:HEADER_SIZE + cap]

    def ring_read(pos, n):
        off = pos % cap
        first = min(n, cap - off)
        out = ring[off:off + first]
        if first < n:
            out += ring[:n - first]
        return out

    records = []
    torn = False
    pos = head
    while pos + _REC.size <= tail:
        length, crc = _REC.unpack(ring_read(pos, _REC.size))
        if length > cap - _REC.size or pos + _REC.size + length > tail:
            torn = True
            break
        payload = ring_read(pos + _REC.size, length)
        if zlib.crc32(payload) != crc:
            torn = True
            break
        try:
            records.append(json.loads(payload))
        except ValueError:
            torn = True
            break
        pos += _REC.size + length
    if pos != tail and not torn:
        torn = True  # trailing bytes too short for a record prefix
    return records, {"head": head, "tail": tail, "capacity": cap,
                     "n": len(records), "torn": torn,
                     "valid_end": pos}


def last_gauges(records):
    """{gauge name: last value} over a replayed record list — the
    killed process's final readings (queue depth, p99, memory)."""
    out = {}
    for ev in records:
        if ev.get("kind") == "gauge" and isinstance(
                ev.get("value"), (int, float)):
            out[ev.get("name", "?")] = ev["value"]
    return out


def flush_gauges_to_manifest(records, root=None, out=None):
    """Merge a replayed flight's gauge last-values into the dead run's
    manifest.json (a SIGKILL'd serve process
    keeps its final queue-depth/p99 readings even though its own
    heartbeat/shutdown flush never ran). The run directory is found by
    the records' ``run`` token under ``root`` (default: the telemetry
    root). Returns the list of manifest paths updated."""
    from flake16_framework_tpu_torch.obs import core, schema
    from flake16_framework_tpu_torch.utils.atomic import atomic_write

    root = root or core.default_root()
    updated = []
    by_run = {}
    for ev in records:
        run = ev.get("run")
        if isinstance(run, str):
            by_run.setdefault(run, []).append(ev)
    for run, evs in by_run.items():
        gauges = last_gauges(evs)
        if not gauges:
            continue
        path = os.path.join(root, f"run-{run}", schema.MANIFEST_FILE)
        if not os.path.isfile(path):
            continue
        try:
            with open(path) as fd:
                manifest = json.load(fd)
        except (OSError, ValueError):
            continue
        manifest.setdefault("gauges", {}).update(gauges)
        manifest["flight_dump_ts"] = round(time.time(), 4)
        with atomic_write(path, "w") as fd:
            json.dump(manifest, fd, indent=1, default=str)
        updated.append(path)
        if out is not None:
            out.write(f"flight: flushed {len(gauges)} gauge last-value(s) "
                      f"into {path}\n")
    return updated


def dump(path, out=None, last=40, flush_manifest=True):
    """Replay ``path`` and pretty-print its tail — the fleet manager's
    worker-death hook. Also flushes
    gauge last-values into the dead run's manifest (see above) and
    writes the full replay next to the ring as ``<path>.dump.json``.
    Returns the (records, meta) pair; never raises on a torn tail."""
    from flake16_framework_tpu_torch.obs import core
    from flake16_framework_tpu_torch.utils.atomic import atomic_write

    out = out or sys.stdout
    records, meta = replay(path)
    core.event("flight", action="dump", path=str(path), n=meta["n"],
               torn=meta["torn"])
    out.write(f"flight {path}: {meta['n']} record(s), "
              f"bytes [{meta['head']}, {meta['tail']})"
              + (" — TORN tail (valid prefix shown)\n" if meta["torn"]
                 else "\n"))
    gauges = last_gauges(records)
    if gauges:
        out.write("final gauges: " + "  ".join(
            f"{k}={v}" for k, v in sorted(gauges.items())) + "\n")
    for ev in records[-last:]:
        ts = ev.get("ts")
        stamp = time.strftime("%H:%M:%S", time.localtime(ts)) \
            if isinstance(ts, (int, float)) else "?"
        fields = {k: v for k, v in ev.items()
                  if k not in ("kind", "ts", "run")}
        out.write(f"  {stamp} {ev.get('kind', '?'):<10} "
                  + " ".join(f"{k}={v}" for k, v in fields.items())[:160]
                  + "\n")
    dump_path = str(path) + ".dump.json"
    with atomic_write(dump_path, "w") as fd:
        json.dump({"meta": meta, "gauges": gauges, "records": records},
                  fd, indent=1, default=str)
    out.write(f"wrote {dump_path}\n")
    if flush_manifest:
        flush_gauges_to_manifest(records, out=out)
    return records, meta


def env_path(environ=None, run_dir=None):
    """The armed flight-ring path from ``F16_FLIGHT`` (None = off).
    ``1`` means ``<run_dir>/flight.bin`` — only resolvable with an
    active run; an explicit value is the path itself (the form the
    fleet manager can dump).

    Under a serving fleet every worker inherits the SAME
    ``F16_FLIGHT`` value from the fleet manager — without
    uniquification W workers would mmap one ring file and clobber each
    other's headers. When ``F16_FLEET_WORKER`` is present the path
    gains a ``.w<index>`` suffix before the extension
    (``flight.bin`` → ``flight.w2.bin``); the fleet manager computes
    the identical path with the worker's env to dump the corpse ring,
    and ``replay_dir`` merges a directory of per-worker rings."""
    env = os.environ if environ is None else environ
    raw = env.get("F16_FLIGHT", "")
    if not raw:
        return None
    if raw == "1":
        if not run_dir:
            return None
        path = os.path.join(run_dir, "flight.bin")
    else:
        path = raw
    worker = env.get("F16_FLEET_WORKER", "")
    if worker != "":
        stem, ext = os.path.splitext(path)
        path = f"{stem}.w{worker}{ext or '.bin'}"
    return path


def ring_worker_index(name):
    """The fleet worker index a ring filename encodes (the ``.w<i>``
    suffix ``env_path`` appends under ``F16_FLEET_WORKER``), or None for
    a non-worker ring (the router/parent's own ``flight.bin``)."""
    stem, ext = os.path.splitext(os.path.basename(name))
    stem, dot, tag = stem.rpartition(".")
    if dot and tag.startswith("w") and tag[1:].isdigit():
        return int(tag[1:])
    return None


def replay_dir(dirpath):
    """(records, metas) merged by timestamp over every flight ring in a
    directory — the fleet form of ``replay`` (one ring per worker; the
    merged stream is the fleet's interleaved last seconds). Non-ring
    files are skipped; per-ring metas carry each ring's path + torn
    flag plus the source count. Every replayed event is annotated with
    the ring it came out of — ``fleet_worker`` = the ``.w<i>`` index
    for a worker ring (the merged stream stays attributable per process
    after the sort interleaves it)."""
    records = []
    metas = []
    for name in sorted(os.listdir(dirpath)):
        if not name.endswith(".bin"):
            continue
        path = os.path.join(dirpath, name)
        try:
            recs, meta = replay(path)
        except (OSError, ValueError):
            continue
        worker = ring_worker_index(name)
        if worker is not None:
            recs = [dict(ev, fleet_worker=worker) for ev in recs]
        meta = dict(meta, path=path, worker=worker)
        metas.append(meta)
        records.extend(recs)
    records.sort(key=lambda ev: ev.get("ts") or 0.0)
    return records, {"rings": metas, "n": len(records),
                     "torn": any(m["torn"] for m in metas)}


def dump_dir(dirpath, out=None, last=60, flush_manifest=True):
    """Replay + pretty-print a DIRECTORY of flight rings merged by
    timestamp (a fleet's rings). Same contract
    as ``dump``: never raises on torn tails, writes the merged replay
    as ``<dir>/flight.merged.dump.json``."""
    from flake16_framework_tpu_torch.obs import core
    from flake16_framework_tpu_torch.utils.atomic import atomic_write

    out = out or sys.stdout
    records, meta = replay_dir(dirpath)
    core.event("flight", action="dump-dir", path=str(dirpath),
               rings=len(meta["rings"]), n=meta["n"], torn=meta["torn"])
    out.write(f"flight dir {dirpath}: {len(meta['rings'])} ring(s), "
              f"{meta['n']} record(s) merged by timestamp"
              + (" — TORN tail(s)\n" if meta["torn"] else "\n"))
    for ring in meta["rings"]:
        who = (f" (worker {ring['worker']})"
               if ring.get("worker") is not None else "")
        out.write(f"  ring {ring['path']}{who}: {ring['n']} record(s)"
                  + (" TORN" if ring["torn"] else "") + "\n")
    gauges = last_gauges(records)
    if gauges:
        out.write("final gauges: " + "  ".join(
            f"{k}={v}" for k, v in sorted(gauges.items())) + "\n")
    for ev in records[-last:]:
        ts = ev.get("ts")
        stamp = time.strftime("%H:%M:%S", time.localtime(ts)) \
            if isinstance(ts, (int, float)) else "?"
        fw = ev.get("fleet_worker")
        who = f"w{fw}" if isinstance(fw, int) else "--"
        fields = {k: v for k, v in ev.items()
                  if k not in ("kind", "ts", "run", "fleet_worker")}
        out.write(f"  {stamp} {who:<3} {ev.get('kind', '?'):<10} "
                  + " ".join(f"{k}={v}" for k, v in fields.items())[:160]
                  + "\n")
    dump_path = os.path.join(dirpath, "flight.merged.dump.json")
    with atomic_write(dump_path, "w") as fd:
        json.dump({"meta": meta, "gauges": gauges, "records": records},
                  fd, indent=1, default=str)
    out.write(f"wrote {dump_path}\n")
    if flush_manifest:
        flush_gauges_to_manifest(records, out=out)
    return records, meta
