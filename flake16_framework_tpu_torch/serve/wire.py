"""Fleet wire protocol: length-prefixed JSON frames over a stream
socket (a copy of the JAX package's ``serve/wire.py``: a message packs to
the same bytes in either package, so a router of one package can route
to the workers of the other).

One frame = a 4-byte big-endian payload length followed by a UTF-8 JSON
document. Numpy arrays ride inside the JSON as tagged base64 blobs
(``{"__nd__": [shape], "dtype": ..., "b64": ...}``) so a scoring batch
crosses the socket as raw little-endian bytes, not a float-per-token
decimal list. The framing is deliberately the flight ring's discipline
minus the CRC — TCP/AF_UNIX already guarantees integrity; what the
length prefix buys is record boundaries a reader can trust after any
interleaving of sender threads (every ``send_msg`` writes its frame
under the caller's send lock in one ``sendall``).

Message grammar (schema tag ``flake16-fleet-wire-v1``):

router -> worker requests (``id`` is the router-minted request id —
the coalescing key for hedged duplicates):

    {"id": N, "op": "score", "model": mid, "kind": k, "x": <array>,
     "trace_id": t, "parent_id": s}                # trace ctx, sampled only
    {"id": N, "op": "ping"}
    {"id": N, "op": "stats"}
    {"id": N, "op": "drain", "deadline_s": S}

``trace_id``/``parent_id`` are the cross-process trace context: the
router-minted ``obs.mint_trace()`` trace id plus the router's
request span id. Both appear ONLY when the router sampled the request
(``F16_TRACE_SAMPLE`` coin) — an unsampled request's frame is
byte-identical to the pre-trace wire, so the propagation is zero-cost
when tracing is off. The worker adopts the inbound context via
``obs.adopt_trace`` so its ``serve.request`` spans nest under the
router's span on the SAME trace id; hedged duplicates carry the same
context, which is what lets one fleet-merged Perfetto render stitch a
request across every process it touched.

worker -> router responses (matched to the pending request by ``id``):

    {"id": N, "ok": true,  "out": <array>}        # score
    {"id": N, "ok": true,  ...}                   # ping/stats/drain
    {"id": N, "ok": false, "error": msg, "retriable": bool,
     "error_type": name}

worker -> router pushes (no ``id``; the router's reader consumes them
out of band):

    {"hb": {"ts": ..., "worker": i, "pid": p, "queue_depth": d,
            "inflight": n, "p50_ms": ..., "p99_ms": ..., "requests": c,
            "shedding": bool, "burn_fast": ..., "burn_slow": ...,
            "quarantined": [...], "launches": {kernel: n}}}

(``launches``, the worker's kernel launch counts, is this package's
addition; the JAX router ignores it.) ``retriable`` carries the
:class:`~flake16_framework_tpu_torch.serve.queue.ServeError` client
contract across the process boundary: True means the worker never
dispatched on the request's behalf (draining rejection,
queue full), so the router may re-dispatch the SAME request id to
another worker — the zero-drop half of rolling restarts.
"""

import base64
import json
import socket
import struct

import numpy as np

WIRE_SCHEMA = "flake16-fleet-wire-v1"

# Field census for the three frame kinds above. A frame key that is not
# in its kind's census is wire drift: either the docstring grammar above
# and this census grow together (a deliberate protocol rev) or the
# emitter is wrong. Trace-context fields are first-class members of the
# request census, not an extension.
TRACE_FIELDS = frozenset({"trace_id", "parent_id"})
REQUEST_FIELDS = frozenset(
    {"id", "op", "model", "kind", "x", "deadline_s"}) | TRACE_FIELDS
RESPONSE_FIELDS = frozenset(
    {"id", "ok", "out", "error", "retriable", "error_type",
     "worker", "pid", "stats", "acct"})
PUSH_FIELDS = frozenset({"hb"})
WIRE_FIELDS = {
    "request": REQUEST_FIELDS,
    "response": RESPONSE_FIELDS,
    "push": PUSH_FIELDS,
}

_LEN = struct.Struct(">I")
# A score frame is <= bucket_max x n_features float32 + envelope; 64 MiB
# is orders of magnitude above any legal batch — a larger length prefix
# means a corrupt/foreign stream, better torn down than buffered.
MAX_FRAME = 64 << 20


class WireError(ConnectionError):
    """A framing violation (oversize length, truncated frame mid-read).
    Both sides treat it like a dead peer: tear the connection down."""


def _encode_arrays(obj):
    """Deep-copy ``obj`` with numpy arrays replaced by tagged b64 blobs."""
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        return {"__nd__": list(a.shape), "dtype": str(a.dtype),
                "b64": base64.b64encode(a.tobytes()).decode("ascii")}
    if isinstance(obj, dict):
        return {k: _encode_arrays(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode_arrays(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def _decode_hook(d):
    if "__nd__" in d and "b64" in d:
        arr = np.frombuffer(base64.b64decode(d["b64"]),
                            dtype=np.dtype(d.get("dtype", "float32")))
        return arr.reshape([int(s) for s in d["__nd__"]]).copy()
    return d


def pack(obj):
    """One wire frame (length prefix + JSON payload) for a message."""
    payload = json.dumps(_encode_arrays(obj), default=str).encode()
    if len(payload) > MAX_FRAME:
        raise WireError(f"frame of {len(payload)} bytes exceeds "
                        f"MAX_FRAME ({MAX_FRAME})")
    return _LEN.pack(len(payload)) + payload


def unpack_payload(payload):
    return json.loads(payload.decode(), object_hook=_decode_hook)


def send_msg(sock, obj):
    """Write one frame. The CALLER serializes concurrent senders (the
    router's per-link send lock, the worker's per-connection send lock)
    — one sendall per frame keeps records atomic under that lock."""
    sock.sendall(pack(obj))


def _recv_exact(sock, n):
    """Read exactly ``n`` bytes, or None on a clean EOF at a record
    boundary. EOF mid-record raises WireError (a torn frame)."""
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except (OSError, ValueError):
            chunk = b""
        if not chunk:
            if got == 0:
                return None
            raise WireError(f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock):
    """Read one frame; None on clean EOF. Raises WireError on a torn or
    oversize frame (treat as a dead peer)."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (length,) = _LEN.unpack(head)
    if length > MAX_FRAME:
        raise WireError(f"frame length {length} exceeds MAX_FRAME")
    payload = _recv_exact(sock, length)
    if payload is None:
        raise WireError("peer closed between length prefix and payload")
    return unpack_payload(payload)


def connect_unix(path, timeout=None):
    """One connected AF_UNIX stream socket (the router's side)."""
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    if timeout is not None:
        sock.settimeout(timeout)
    sock.connect(path)
    sock.settimeout(None)
    return sock


def listen_unix(path, backlog=8):
    """One listening AF_UNIX socket (the worker's side); a stale socket
    file from a previous occupant is unlinked first."""
    try:
        import os

        os.unlink(path)
    except OSError:
        pass
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.bind(path)
    sock.listen(backlog)
    return sock
