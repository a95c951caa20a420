"""Write-ahead sweep journal: fold-granular crash consistency (a copy of
the JAX package's, byte-compatible with it: a journal written by either
package replays in the other).

Without it the resume unit is the whole config, and the pickle
checkpoint is written only every few configs, so a kill loses every
completed fold since then. The journal makes the FOLD the restart
quantum: confusion counts are int32 and fold-additive, so per-fold
[P, 3] counts journaled as they land sum bit-exactly to the config total
an uninterrupted run would have produced.

Format — ``<scores.pkl>.journal``, a sequence of length+CRC32-prefixed
pickle records::

    <u32 little-endian payload length> <u32 crc32(payload)> <payload>

- record 0 is ``("header", fingerprint)`` — the run identity (seed, cv
  scheme, fold count, grower, data digest). A journal whose fingerprint
  disagrees with the resuming run is DISCARDED whole: replaying folds
  keyed by a different seed or fold split would corrupt scores silently.
- ``("fold", config_keys, fold_index, rng_key_bytes, counts)`` — one
  fold's confusion counts (numpy int32 [P, 3]), appended (and fsync'd)
  the moment they reach the host. ``rng_key_bytes`` is the fold's PRNG
  key as two little-endian uint32 words (8 bytes, as jax's 32-bit keys
  serialise); the resuming engine recomputes the key table and drops any
  journaled fold whose key disagrees rather than trusting it.
- ``("config", config_keys, value)`` — the config's full 4-element
  reference-schema value (clocks + scores). Completed configs keep the
  clocks of the run that actually computed them across resumes.

Every append is flushed and fsync'd before ``record_*`` returns: a kill
at ANY instruction boundary leaves a journal whose longest valid prefix
is exactly the work that completed. ``replay`` truncates the torn tail
(a partial record at EOF is the expected kill signature, not
corruption) and hands back completed configs + partial fold sets;
``SweepJournal.open`` physically truncates the file to the valid prefix
before appending, so one torn tail can never shadow a later record.

Single-writer discipline: ``<journal>.lock`` holds the writer's pid.
A second resumer fails fast with ``JournalLocked``; a lock whose pid is
dead (the killed run's) is taken over, so a supervised restart proceeds
without human cleanup.

The kill drill hooks in here: ``record_fold`` consults the injection
plan's process entries (resilience/inject.py, ``<config>:<fold>:sigkill``)
AFTER the fsync and delivers the scheduled signal to its own process —
the deterministic kill point where the record is durable and everything
after it is lost.
"""

import os
import pickle
import struct
import sys
import time
import zlib

SCHEMA = "f16-journal-v1"
_PREFIX = struct.Struct("<II")
# Length sanity bound: a corrupt length prefix must not trigger a
# multi-GB read before the CRC gets a chance to reject the record.
_MAX_RECORD = 1 << 28


class JournalLocked(RuntimeError):
    """Another LIVE process holds the journal's writer lock."""


def journal_path(out_file):
    """The journal sibling of a scores artifact."""
    return str(out_file) + ".journal"


def lock_path(path):
    return str(path) + ".lock"


def _encode(obj):
    payload = pickle.dumps(obj, protocol=4)
    return _PREFIX.pack(len(payload), zlib.crc32(payload)) + payload


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class JournalLock:
    """Pid-stamped exclusive lock with stale-holder (dead-pid) takeover."""

    def __init__(self, path):
        self.path = path
        self.held = False

    def acquire(self):
        while True:
            try:
                fd = os.open(self.path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
            except FileExistsError:
                pid = self._holder()
                if pid is not None and _pid_alive(pid):
                    raise JournalLocked(
                        f"journal locked by live pid {pid} ({self.path}); "
                        f"a second resumer must not append")
                # Stale holder (killed run) or unreadable lock: take over.
                try:
                    os.unlink(self.path)
                except FileNotFoundError:
                    pass
                continue
            try:
                os.write(fd, str(os.getpid()).encode())
                os.fsync(fd)
            finally:
                os.close(fd)
            self.held = True
            return self

    def _holder(self):
        try:
            with open(self.path, "rb") as fd:
                return int(fd.read().strip() or b"-1")
        except (OSError, ValueError):
            return None

    def release(self):
        if not self.held:
            return
        self.held = False
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()


class Replay:
    """The recoverable state of a journal file.

    - ``ledger``     — {config_keys: 4-element value} for completed configs
    - ``partial``    — {config_keys: {fold: (rng_key_bytes, counts)}} for
                       configs with journaled folds but no config record
    - ``valid_end``  — byte offset of the longest valid record prefix
    - ``truncated``  — a torn tail was dropped past ``valid_end``
    - ``reset_reason`` — non-None when the WHOLE file is unusable
                       (missing/garbled header, fingerprint mismatch)
    """

    def __init__(self):
        self.ledger = {}
        self.partial = {}
        self.valid_end = 0
        self.truncated = False
        self.reset_reason = None

    @property
    def n_partial_folds(self):
        return sum(len(v) for v in self.partial.values())


def _iter_records(fd):
    """Yield (obj, end_offset) for the longest valid record prefix; a
    short read, CRC mismatch, or unpicklable payload ends iteration (the
    torn-tail rule). Raises nothing on corruption — the caller decides
    whether a truncated tail is expected (kill) or alarming."""
    while True:
        hdr = fd.read(_PREFIX.size)
        if len(hdr) < _PREFIX.size:
            return len(hdr) > 0
        length, crc = _PREFIX.unpack(hdr)
        if length > _MAX_RECORD:
            return True
        payload = fd.read(length)
        if len(payload) < length or zlib.crc32(payload) != crc:
            return True
        try:
            obj = pickle.loads(payload)
        except Exception:
            return True
        yield obj, fd.tell()


def replay(path, fingerprint=None, warn_out=sys.stderr):
    """Read-only recovery scan of a journal file (see ``Replay``).
    ``fingerprint`` (when given) must match the header record's — a
    mismatch marks the whole journal unusable (``reset_reason``)."""
    rep = Replay()
    if not os.path.exists(path):
        return rep
    with open(path, "rb") as fd:
        it = _iter_records(fd)
        first = True
        while True:
            try:
                obj, end = next(it)
            except StopIteration as stop:
                rep.truncated = bool(stop.value)
                break
            if first:
                first = False
                if not (isinstance(obj, tuple) and len(obj) == 2
                        and obj[0] == "header"):
                    rep.reset_reason = "missing header"
                    break
                if fingerprint is not None and obj[1] != fingerprint:
                    rep.reset_reason = "fingerprint mismatch"
                    break
                rep.valid_end = end
                continue
            try:
                kind = obj[0]
                if kind == "fold":
                    _, keys, fold, key_bytes, counts = obj
                    keys = tuple(keys)
                    if keys not in rep.ledger:
                        rep.partial.setdefault(keys, {})[int(fold)] = (
                            key_bytes, counts)
                elif kind == "config":
                    _, keys, value = obj
                    keys = tuple(keys)
                    rep.ledger[keys] = value
                    rep.partial.pop(keys, None)
                # Unknown kinds skip silently: forward compatibility.
            except (TypeError, ValueError, IndexError, KeyError):
                rep.truncated = True
                break
            rep.valid_end = end
    if rep.reset_reason and warn_out is not None:
        warn_out.write(
            f"warning: sweep journal {path} unusable ({rep.reset_reason}); "
            f"discarding it and restarting affected configs\n")
    elif rep.truncated and warn_out is not None:
        warn_out.write(
            f"warning: sweep journal {path} has a torn tail (expected "
            f"after a kill); truncating to byte {rep.valid_end}\n")
    return rep


class SweepJournal:
    """The writer half: exclusive, append-only, fsync-per-record.

    ``append_wall_s`` accumulates the wall spent inside ``record_*`` (the
    journal's overhead on a sweep) over ``n_appends`` records.
    """

    def __init__(self, path, fd, lock, rep, plan=None):
        self.path = path
        self._fd = fd
        self._lock = lock
        self.ledger = rep.ledger
        self.partial = rep.partial
        self.reset_reason = rep.reset_reason
        self.plan = plan
        self.append_wall_s = 0.0
        self.n_appends = 0

    @classmethod
    def open(cls, path, fingerprint, *, warn_out=sys.stderr, plan=None):
        """Acquire the lock, replay, truncate the torn tail, and return
        an appendable journal whose ``ledger``/``partial`` hold the
        recovered state. A fingerprint-mismatched or headerless journal
        is discarded and restarted fresh."""
        lock = JournalLock(lock_path(path)).acquire()
        try:
            rep = replay(path, fingerprint=fingerprint, warn_out=warn_out)
            if rep.reset_reason is not None:
                rep_state = Replay()
                rep_state.reset_reason = rep.reset_reason
                rep = rep_state
            # O_CREAT without O_TRUNC: the valid prefix is the recovered
            # state; only the torn tail (or a discarded journal's whole
            # body) is cut.
            fd = os.fdopen(os.open(path, os.O_RDWR | os.O_CREAT, 0o644),
                           "r+b")
            try:
                fd.truncate(rep.valid_end)
                fd.seek(rep.valid_end)
                jr = cls(path, fd, lock, rep, plan=plan)
                if rep.valid_end == 0:
                    jr._append(("header", fingerprint))
            except BaseException:
                fd.close()
                raise
        except BaseException:
            lock.release()
            raise
        return jr

    def _append(self, obj):
        t0 = time.time()
        self._fd.write(_encode(obj))
        self._fd.flush()
        os.fsync(self._fd.fileno())
        self.append_wall_s += time.time() - t0
        self.n_appends += 1

    def partial_folds(self, config_keys):
        """{fold: (rng_key_bytes, counts)} journaled for an unfinished
        config (empty for fresh ones)."""
        return self.partial.get(tuple(config_keys), {})

    def record_fold(self, config_keys, fold, key_bytes, counts, *,
                    config_index=None):
        """Journal one completed fold. After the fsync, deliver any
        process signal the injection plan schedules for this
        (config, fold) point — the kill drill's deterministic kill."""
        keys = tuple(config_keys)
        self._append(("fold", keys, int(fold), bytes(key_bytes), counts))
        self.partial.setdefault(keys, {})[int(fold)] = (
            bytes(key_bytes), counts)
        if self.plan is not None and config_index is not None:
            sig = self.plan.process_signal(config_index, int(fold) + 1)
            if sig is not None:
                os.kill(os.getpid(), sig)

    def record_config(self, config_keys, value):
        """Journal a config's completion with its full reference-schema
        value; its fold records are superseded."""
        keys = tuple(config_keys)
        self._append(("config", keys, value))
        self.ledger[keys] = value
        self.partial.pop(keys, None)

    def close(self, remove=False):
        if self._fd is not None:
            try:
                self._fd.close()
            finally:
                self._fd = None
        if remove:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
        self._lock.release()

    def finalize(self):
        """The run's durable artifact (scores.pkl) is on disk and
        supersedes the journal: drop journal + lock."""
        self.close(remove=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
