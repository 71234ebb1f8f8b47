"""Binary tensor RPC over TCP (counterpart of distributed_faiss_tpu/parallel/rpc.py).

Frame layout (little-endian), the JAX package's ``DFT1`` frames:

  magic b"DFT1" | kind u8 | skel_len u32 | narr u32 | skel bytes |
  narr x [ dtype_len u8 | dtype utf8 | ndim u8 | dims u64* | data bytes ]

numpy arrays travel as raw buffers; only the object skeleton (method name,
scalars, metadata lists) is pickled, and unpickled through an allowlist
(``_RestrictedUnpickler``): numpy reconstruction, a few safe builtins, and
exact (module, name) pairs of this package — ``IndexCfg``, ``IndexState``
and ``_TensorRef``. A class of the JAX package is refused like any other
global, so the two packages do not talk RPC to each other; their parity
link is the snapshot on disk.

Multiplexing: every CALL from a multiplexed ``Client`` carries ``req_id``
in its trailing meta dict (with ``deadline_s`` when the call has a
deadline, and ``trace_id`` when the request is sampled,
observability/spans.py); the server answers with the tagged kinds
(``KIND_*_MUX``, payload ``({"req_id": n}, body)``), so many calls are in
flight per connection and complete out of order. A frame without
``req_id`` is served on the synchronous in-order path and answered
untagged: that is the serial client's dialect (``Client(mux=False)``, or
DFT_RPC_MUX=0), one call per connection at a time, whose CALL frames carry
a meta element only when a deadline or a trace sets a key.

Binary skeletons (parallel/wire.py): a frame whose kind byte carries
``WIRE_BINARY_FLAG`` holds a compact binary skeleton instead of pickle
bytes; the header and the tensor planes are unchanged. Negotiation is per
connection and costs no round trip. Every pickle CALL from a wire-capable
``Client`` carries ``{"wire": 1}`` in its meta ("I decode binary frames");
a wire-capable server then answers the search family in binary on that
connection, and the first binary-flagged frame the stub's demux receives
proves the server speaks it, so later search CALLs go out binary too. The
state resets with the connection. Control ops, a peer that never
advertises, and ``DFT_RPC_WIRE=pickle`` keep pickle skeletons, and any
payload outside the binary schema falls back to pickle for that one frame
(``wire.WireEncodeError`` is the fallback signal, never an error on the
wire). The serial client never advertises, so it is answered in pickle.
"""

import io
import itertools
import os
import pickle
import random
import socket
import struct
import threading
import time

import numpy as np

from distributed_faiss_tpu_torch.observability import spans as obs_spans
from distributed_faiss_tpu_torch.parallel import wire
from distributed_faiss_tpu_torch.utils.config import WireCfg
from distributed_faiss_tpu_torch.utils.tracing import LatencyStats

DEFAULT_PORT = 12032

_jitter_rng = random.Random()  # private: retry jitter never touches the global RNG

_SAFE_BUILTINS = frozenset({"set", "frozenset", "complex", "bytearray", "slice", "range"})
_SAFE_NUMPY = frozenset({
    "ndarray", "dtype", "_reconstruct", "scalar", "bool_",
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "longlong", "ulonglong",
})
_PACKAGE = __name__.split(".")[0]
_SAFE_PACKAGE_GLOBALS = frozenset({
    (f"{_PACKAGE}.utils.config", "IndexCfg"),
    (f"{_PACKAGE}.utils.state", "IndexState"),
    (__name__, "_TensorRef"),
})


def _unsafe_pickle_ok() -> bool:
    # strictly '1': a security opt-out must not widen to other spellings
    return os.environ.get("DFT_RPC_UNSAFE_PICKLE") == "1"


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        # a dotted name would getattr-walk past the allowlisted symbol
        if "." not in name:
            if module == "builtins" and name in _SAFE_BUILTINS:
                return super().find_class(module, name)
            if (module == "numpy" or module.startswith(("numpy.core.", "numpy._core."))) \
                    and name in _SAFE_NUMPY:
                return super().find_class(module, name)
            if (module, name) in _SAFE_PACKAGE_GLOBALS:
                return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"RPC payload references disallowed global {module}.{name} "
            "(set DFT_RPC_UNSAFE_PICKLE=1 to trust peers with arbitrary pickles)")


def restricted_loads(data) -> object:
    """``pickle.loads`` for wire bytes, through the allowlisted Unpickler."""
    if _unsafe_pickle_ok():
        return pickle.loads(data)
    return _RestrictedUnpickler(io.BytesIO(bytes(data))).load()


MAGIC = b"DFT1"
KIND_CALL = 0
KIND_RESULT = 1
KIND_ERROR = 2
KIND_CLOSE = 3
# structured admission-control rejection: {"reason": "queue_full" |
# "deadline" | "stopping", ...}; retryable load shedding, not an exception
KIND_BUSY = 4
# req_id-tagged response variants: payload ({"req_id": n}, body)
KIND_RESULT_MUX = 5
KIND_ERROR_MUX = 6
KIND_BUSY_MUX = 7
# shard transfer: FETCH carries ``(index_id,)``, SHARD_DATA answers with the
# engine's export_snapshot dict (its arrays ride the raw tensor planes).
# Both travel on a dedicated connection, never a serving stub's, so bulk
# bytes block no mux window and the demux reader never sees them.
KIND_SHARD_FETCH = 8
KIND_SHARD_DATA = 9
# anti-entropy digest exchange, also on a short-lived dedicated connection:
# DIGEST carries ``{"rank", "group", "want"}``, DIGEST_RESP the peer's
# ``{"rank", "shard_group", "digests", "watermarks", "compaction"}``. The
# round trip doubles as the failure detector's heartbeat.
KIND_DIGEST = 10
KIND_DIGEST_RESP = 11

# kind-byte flag of a frame whose skeleton is binary (parallel/wire.py);
# every KIND_* value stays below it
WIRE_BINARY_FLAG = 0x80
WIRE_META_KEY = "wire"

MUX_RESPONSE_KINDS = {KIND_RESULT: KIND_RESULT_MUX, KIND_ERROR: KIND_ERROR_MUX,
                      KIND_BUSY: KIND_BUSY_MUX}
_MUX_TO_BASE = {v: k for k, v in MUX_RESPONSE_KINDS.items()}

_HDR = struct.Struct("<4sBII")


def mux_enabled_by_env() -> bool:
    """DFT_RPC_MUX (default on): 0 gives the serial one-call-per-connection
    client."""
    raw = os.environ.get("DFT_RPC_MUX")
    return raw is None or raw not in ("0", "false", "False", "")


def wire_binary_by_env() -> bool:
    """DFT_RPC_WIRE (default ``binary``): ``pickle`` turns binary-skeleton
    negotiation off on this end, so frames stay byte-identical to the
    pickle-only protocol. Parsed by ``WireCfg``, the server's schema, so a
    bad value fails the same way on both ends."""
    return WireCfg.from_env().encoding == "binary"

# kernel-level bound on one zero-progress frame write (SO_SNDTIMEO): a peer
# that stops draining TCP becomes a transport error instead of a wedged
# thread holding a write lock
SEND_TIMEOUT_S = 30.0


def bound_send_timeout(sock: socket.socket, seconds: float = SEND_TIMEOUT_S) -> None:
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                        struct.pack("ll", int(seconds), 0))
    except (OSError, struct.error):  # pragma: no cover - exotic platform
        pass


class ClientExit(Exception):
    """Raised server-side when a client sends a CLOSE frame."""


class ServerException(Exception):
    """A remote exception, carrying the server-side traceback text."""


class BusyError(Exception):
    """The server shed this request (scheduler queue full): retry after
    backoff; the rank is alive."""

    def __init__(self, message: str, info: dict = None):
        super().__init__(message)
        self.info = dict(info or {})


class DeadlineExceeded(Exception):
    """The call's deadline passed. Not retryable."""


class FrameError(RuntimeError):
    """The byte stream violated the frame protocol; the connection that
    produced it is never reused."""


# "the bytes never made it intact / the peer is gone"
TRANSPORT_ERRORS = (OSError, EOFError, FrameError, pickle.UnpicklingError)
RETRYABLE_ERRORS = TRANSPORT_ERRORS + (BusyError,)


class RetryPolicy:
    """Bounded exponential backoff with jitter for transport failures and
    BUSY rejections; application errors propagate at once."""

    retryable_errors = RETRYABLE_ERRORS

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.05,
                 multiplier: float = 2.0, max_delay: float = 2.0, jitter: float = 0.5):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.multiplier = multiplier
        self.max_delay = max_delay
        self.jitter = jitter

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retryable_errors)

    def delay(self, attempt: int) -> float:
        d = min(self.max_delay, self.base_delay * (self.multiplier ** attempt))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * _jitter_rng.random() - 1.0)
        return max(0.0, d)

    def run(self, fn, *args, **kwargs):
        return self.run_filtered(self.retryable_errors, None, fn, *args, **kwargs)

    def run_filtered(self, retryable, abs_deadline, fn, *args, **kwargs):
        """``run`` with an explicit retryable tuple and an optional absolute
        ``time.time()`` deadline no backoff sleep may cross."""
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except retryable:
                if attempt + 1 >= self.max_attempts:
                    raise
                d = self.delay(attempt)
                if abs_deadline is not None and time.time() + d >= abs_deadline:
                    raise
                time.sleep(d)


class _TensorRef:
    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx

    def __reduce__(self):
        return (_TensorRef, (self.idx,))


def _extract(obj, arrays):
    """Replace ndarrays in (nested) containers with _TensorRef placeholders."""
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        if a.dtype.hasobject:
            return obj  # object arrays can't travel as raw buffers
        arrays.append(a)
        return _TensorRef(len(arrays) - 1)
    if type(obj) is list:
        return [_extract(v, arrays) for v in obj]
    if type(obj) is tuple:
        return tuple(_extract(v, arrays) for v in obj)
    if type(obj) is dict:
        return {k: _extract(v, arrays) for k, v in obj.items()}
    return obj


def _restore(obj, arrays):
    if isinstance(obj, _TensorRef):
        return arrays[obj.idx]
    if type(obj) is list:
        return [_restore(v, arrays) for v in obj]
    if type(obj) is tuple:
        return tuple(_restore(v, arrays) for v in obj)
    if type(obj) is dict:
        return {k: _restore(v, arrays) for k, v in obj.items()}
    return obj


def send_parts(sock: socket.socket, parts) -> None:
    for p in parts:
        sock.sendall(p)


def _tensor_parts(arrays):
    """The raw-buffer plane section both skeleton encodings share: per
    plane ``dtype_len u8 | dtype | ndim u8 | dims u64* | data``."""
    parts = []
    for a in arrays:
        dt = a.dtype.str.encode()
        parts.append(struct.pack("<B", len(dt)) + dt + struct.pack("<B", a.ndim)
                     + struct.pack(f"<{a.ndim}Q", *a.shape))
        if a.size:  # zero-size arrays can't be cast to a byte view
            parts.append(memoryview(a).cast("B"))
    return parts


def pack_frame(kind: int, obj=None):
    arrays = []
    skel = pickle.dumps(_extract(obj, arrays), protocol=4)
    return [_HDR.pack(MAGIC, kind, len(skel), len(arrays)), skel] + _tensor_parts(arrays)


def send_frame(sock: socket.socket, kind: int, obj=None) -> None:
    send_parts(sock, pack_frame(kind, obj))


def pack_tagged_response(base_kind: int, obj, req_id: int):
    """Frame parts for a req_id-tagged RESULT/ERROR/BUSY response."""
    return pack_frame(MUX_RESPONSE_KINDS[base_kind], ({"req_id": int(req_id)}, obj))


def pack_binary_call(fname: str, args, kwargs, meta):
    """Frame parts for a binary-skeleton CALL, or None when the call falls
    outside the schema (the caller packs the pickle skeleton instead)."""
    try:
        skel, arrays = wire.encode_call(fname, args, kwargs, meta)
    except wire.WireEncodeError:
        return None
    return [_HDR.pack(MAGIC, KIND_CALL | WIRE_BINARY_FLAG, len(skel), len(arrays)),
            skel] + _tensor_parts(arrays)


_WIRE_ENCODERS = {KIND_RESULT: wire.encode_result, KIND_ERROR: wire.encode_error,
                  KIND_BUSY: wire.encode_busy}
_WIRE_DECODERS = {KIND_RESULT: wire.decode_result, KIND_ERROR: wire.decode_error,
                  KIND_BUSY: wire.decode_busy}


def pack_binary_response(base_kind: int, obj, req_id=None):
    """Frame parts for a binary-skeleton response (tagged when ``req_id`` is
    given), or None for a kind or payload outside the schema (the caller
    falls back to the pickle skeleton for that one frame)."""
    enc = _WIRE_ENCODERS.get(base_kind)
    if enc is None:
        return None
    try:
        skel, arrays = enc(obj)
    except wire.WireEncodeError:
        return None
    kind = base_kind
    if req_id is not None:
        kind = MUX_RESPONSE_KINDS[base_kind]
        skel = struct.pack("<Q", int(req_id)) + skel
    return [_HDR.pack(MAGIC, kind | WIRE_BINARY_FLAG, len(skel), len(arrays)),
            skel] + _tensor_parts(arrays)


def _decode_binary_skeleton(kind: int, skel: bytes, arrays):
    """A binary skeleton -> the exact payload the pickle path gives for the
    same kind (tagged kinds included), so every consumer is shared."""
    if kind == KIND_CALL:
        return wire.decode_call(skel, arrays)
    base, req_id = _MUX_TO_BASE.get(kind), None
    if base is not None:
        if len(skel) < 8:
            raise wire.WireDecodeError("tagged skeleton shorter than req_id")
        (req_id,) = struct.unpack_from("<Q", skel)
        skel = skel[8:]
        kind = base
    dec = _WIRE_DECODERS.get(kind)
    if dec is None:
        raise wire.WireDecodeError(f"kind {kind} has no binary schema")
    body = dec(skel, arrays)
    if req_id is None:
        return body
    return {"req_id": req_id}, body


class FrameReader:
    """Buffered frame reader owning one connection's read side: one
    ``recv`` usually covers a frame's header, skeleton and plane headers;
    bulk plane data lands straight in the destination array
    (``recv_into``). With a positive ``bufsize`` it may hold bytes of the
    next frame between calls, so the owner of a connection keeps one reader
    and serves ``pending`` frames before it blocks in a selector."""

    def __init__(self, sock: socket.socket, bufsize: int = 65536):
        self._sock = sock
        self._bufsize = max(0, int(bufsize))
        self._buf = bytearray()
        self._pos = 0
        self._frame_started = False

    @property
    def pending(self) -> bool:
        """Buffered bytes of a next frame wait: they will never make the
        socket readable."""
        return self._pos < len(self._buf)

    def _take(self, n: int) -> memoryview:
        while len(self._buf) - self._pos < n:
            if self._pos and self._pos == len(self._buf):
                self._buf = bytearray()
                self._pos = 0
            want = n - (len(self._buf) - self._pos)
            data = self._sock.recv(max(want, self._bufsize))
            if not data:
                raise EOFError("connection closed mid-frame"
                               if self._frame_started or self.pending
                               else "connection closed")
            self._buf += data
        out = memoryview(self._buf)[self._pos:self._pos + n]
        self._pos += n
        self._frame_started = True
        return out

    def _readinto(self, view: memoryview) -> None:
        n = len(view)
        got = min(len(self._buf) - self._pos, n)
        if got:
            view[:got] = memoryview(self._buf)[self._pos:self._pos + got]
            self._pos += got
        while got < n:
            r = self._sock.recv_into(view[got:], n - got)
            if r == 0:
                raise EOFError("connection closed mid-tensor")
            got += r

    def recv_frame_ex(self):
        """``(kind, payload, was_binary)`` for one frame; ``was_binary`` is
        the negotiation signal (the peer speaks binary skeletons)."""
        self._frame_started = False
        magic, kind, skel_len, narr = _HDR.unpack(self._take(_HDR.size))
        if magic != MAGIC:
            raise FrameError(f"bad frame magic {bytes(magic)!r}")
        binary = bool(kind & WIRE_BINARY_FLAG)
        kind &= ~WIRE_BINARY_FLAG
        skel_bytes = bytes(self._take(skel_len))
        arrays = []
        for _ in range(narr):
            (dt_len,) = struct.unpack("<B", self._take(1))
            try:
                dt = np.dtype(bytes(self._take(dt_len)).decode())
            except (TypeError, ValueError, UnicodeDecodeError) as e:
                raise FrameError(f"undecodable tensor plane header: {e}") from e
            if dt.hasobject:  # raw bytes never decode to Python objects
                raise FrameError(f"tensor plane of object dtype {dt}")
            (ndim,) = struct.unpack("<B", self._take(1))
            dims = struct.unpack(f"<{ndim}Q", self._take(8 * ndim))
            a = np.empty(dims, dtype=dt)
            if a.nbytes:
                self._readinto(memoryview(a).cast("B"))
            arrays.append(a)
        if self._pos:
            # frame boundary: trim the consumed prefix so a long-lived
            # connection's buffer stays bounded
            del self._buf[:self._pos]
            self._pos = 0
        if not binary:
            return kind, _restore(restricted_loads(skel_bytes), arrays), False
        try:
            payload = _decode_binary_skeleton(kind, skel_bytes, arrays)
        except Exception as e:
            # a garbled binary skeleton is corruption or desync: FrameError
            # keeps it a transport error, so the connection is dropped
            raise FrameError(f"undecodable binary skeleton (kind {kind}): {e}") from e
        return kind, payload, True

    def recv_frame(self):
        """``(kind, payload)`` for one frame."""
        kind, payload, _binary = self.recv_frame_ex()
        return kind, payload


def recv_frame_ex(sock: socket.socket):
    """One-shot unbuffered read of a single frame (never over-reads):
    ``(kind, payload, was_binary)``."""
    return FrameReader(sock, bufsize=0).recv_frame_ex()


def recv_frame(sock: socket.socket):
    """One-shot unbuffered read of a single frame (never over-reads)."""
    return FrameReader(sock, bufsize=0).recv_frame()


def _dedicated_exchange(host: str, port: int, kind: int, payload, timeout: float,
                        v6: bool = False):
    """One request frame and its answer on a connection of their own, the
    socket deadline bounding every step: ``(kind, payload)`` of the answer."""
    sock = socket.socket(socket.AF_INET6 if v6 else socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(timeout)
    try:
        sock.connect((host, port))
        send_frame(sock, kind, payload)
        out = recv_frame(sock)
        try:
            send_frame(sock, KIND_CLOSE, None)
        except OSError:
            pass  # a courtesy: the answer already landed
    finally:
        sock.close()
    return out


def fetch_shard(host: str, port: int, index_id: str, timeout: float = 120.0,
                v6: bool = False) -> dict:
    """A replica's shard snapshot (its engine's ``export_snapshot``) over a
    dedicated connection. A server-side failure raises ServerException."""
    kind, payload = _dedicated_exchange(host, port, KIND_SHARD_FETCH, (index_id,), timeout, v6)
    if kind == KIND_SHARD_DATA:
        return payload
    if kind == KIND_ERROR:
        raise ServerException(payload)
    raise FrameError(f"unexpected frame kind {kind} in answer to a shard fetch")


def digest_exchange(host: str, port: int, payload: dict, timeout: float = 5.0,
                    v6: bool = False) -> dict:
    """One anti-entropy digest round trip on a short-lived dedicated
    connection. A heartbeat too, so a silent peer fails within ``timeout``
    (socket.timeout is an OSError, one of TRANSPORT_ERRORS); a garbled
    answer kind is a FrameError for the same reason."""
    kind, resp = _dedicated_exchange(host, port, KIND_DIGEST, dict(payload), timeout, v6)
    if kind == KIND_DIGEST_RESP:
        return resp
    if kind == KIND_ERROR:
        raise ServerException(resp)
    raise FrameError(f"unexpected frame kind {kind} in answer to a digest exchange")


class _PendingCall:
    __slots__ = ("req_id", "fname", "event", "kind", "payload", "error", "sent_t")

    def __init__(self, req_id: int, fname: str):
        self.req_id = req_id
        self.fname = fname
        self.event = threading.Event()
        self.kind = None
        self.payload = None
        self.error = None
        self.sent_t = time.monotonic()


class Client:
    """Dynamic-dispatch RPC stub: any attribute is a remote method, over one
    persistent connection.

    Multiplexed (``mux``, default DFT_RPC_MUX): ``_lock`` is held only for
    the frame write, a demux reader thread routes tagged responses to their
    calls by ``req_id`` (untagged ones FIFO), and each caller waits on its
    own slot. A transport failure fails every in-flight call and drops the
    connection; the next call redials.

    Serial (``mux=False``): ``_lock`` is held across the whole round trip,
    one call per connection at a time, read through the connection's own
    buffered ``FrameReader``; the frame carries a meta element only when a
    deadline or a trace sets a key, and never advertises binary skeletons.
    Any failure mid-call drops the connection; the next call redials.

    ``wire_binary`` (default: DFT_RPC_WIRE; multiplexed only) advertises
    binary skeletons in every CALL's meta and sends search CALLs binary once
    this connection has received a binary-flagged frame (``_peer_wire``,
    reset with the connection: a redial may reach a pickle-only peer)."""

    RECONNECT_TIMEOUT = 2.0
    REDIAL_COOLDOWN = 2.0
    # slack on a deadline-derived socket wait, so the server's structured
    # deadline shed can arrive before the client's own timeout fires
    DEADLINE_GRACE = 0.5

    def __init__(self, client_id: int, host: str, port: int, v6: bool = False,
                 connect_timeout: float = 60.0, mux: bool = None, wire_binary: bool = None):
        self.id = client_id
        self.host = host
        self.port = port
        self._fam = socket.AF_INET6 if v6 else socket.AF_INET
        self._mux = mux_enabled_by_env() if mux is None else bool(mux)
        self._wire = (wire_binary_by_env() if wire_binary is None
                      else bool(wire_binary)) and self._mux
        self._peer_wire = False  # under _lock, reset per connection
        self._lock = threading.Lock()
        self._closed = False
        self._shutdown = False
        self._next_redial = 0.0
        self._pending = {}  # req_id -> _PendingCall, insertion order == send order
        self._last_rx = 0.0
        self._req_counter = itertools.count()
        self._epoch = 0  # bumped on every (re)connect and teardown
        self._reader = None
        self._inflight_peak = 0
        self.stats = LatencyStats()  # wire round-trip latency
        self._connect(connect_timeout)

    def _connect(self, connect_timeout: float) -> None:
        # a server may register in the discovery file moments before its
        # accept loop is up: retry with backoff inside the budget
        deadline = time.time() + connect_timeout
        delay = 0.05
        while True:
            self.sock = socket.socket(self._fam, socket.SOCK_STREAM)
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                self.sock.settimeout(max(0.05, min(connect_timeout, deadline - time.time())))
                self.sock.connect((self.host, self.port))
                self.sock.settimeout(None)
                bound_send_timeout(self.sock)
                break
            except OSError:
                self.sock.close()
                if time.time() + delay > deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 1.6, 2.0)
        self._epoch += 1
        self._last_rx = time.monotonic()
        self._peer_wire = False  # a restarted peer may be pickle-only
        # the serial path's reader; the demux reader keeps its own
        self._frame_reader = FrameReader(self.sock)
        if self._mux:
            self._reader = threading.Thread(
                target=self._reader_loop, args=(self.sock, self._epoch),
                name=f"rpc-demux:{self.host}:{self.port}:c{self.id}", daemon=True)
            self._reader.start()

    def _reader_loop(self, sock: socket.socket, epoch: int) -> None:
        try:
            reader = FrameReader(sock)
            while True:
                kind, payload, was_binary = reader.recv_frame_ex()
                base = _MUX_TO_BASE.get(kind)
                if base is not None:
                    meta, body = payload
                    rid = meta.get("req_id") if isinstance(meta, dict) else None
                else:
                    base, body, rid = kind, payload, None
                with self._lock:
                    if epoch != self._epoch:
                        return  # superseded by a redial/teardown
                    self._last_rx = time.monotonic()
                    if was_binary:
                        # the peer produces binary skeletons, so it decodes
                        # them too: search CALLs may now go out binary
                        self._peer_wire = True
                    if rid is None:
                        rid = next(iter(self._pending), None)
                    slot = self._pending.pop(rid, None)
                if slot is None:
                    continue  # response to an abandoned request
                slot.kind, slot.payload = base, body
                slot.event.set()
        except Exception as e:  # the reader's exit path: fail the window
            with self._lock:
                if epoch == self._epoch:
                    self._fail_locked(e, sock=sock)

    def _fail_locked(self, exc: BaseException, sock=None) -> None:
        """Tear down the connection (lock held) and fail every in-flight
        call with its own copy of ``exc``."""
        self._epoch += 1
        self._closed = True
        stranded = list(self._pending.values())
        self._pending.clear()
        sock = self.sock if sock is None else sock
        try:
            sock.shutdown(socket.SHUT_RDWR)  # wake a reader blocked in recv
        except OSError:
            pass
        sock.close()
        for slot in stranded:
            try:
                err = type(exc)(*exc.args)
                err.__cause__ = exc
            except Exception:
                err = exc
            slot.error = err
            slot.event.set()

    def _ensure_connected_locked(self) -> None:
        if self._shutdown:
            raise RuntimeError(f"client to {self.host}:{self.port} is closed")
        if self._closed:
            if time.time() < self._next_redial:
                raise ConnectionRefusedError(
                    f"rank at {self.host}:{self.port} is down (redial cooldown)")
            try:
                self._connect(self.RECONNECT_TIMEOUT)
            except OSError:
                self._next_redial = time.time() + self.REDIAL_COOLDOWN
                raise
            self._closed = False

    def generic_fun(self, fname: str, args=(), kwargs=None, timeout: float = None,
                    deadline: float = None, trace_id: str = None):
        """Remote call. ``timeout`` bounds the wait for this call's response;
        ``deadline`` is an absolute ``time.time()`` instant whose remaining
        budget rides the frame so the server can shed the request unserved.
        An already-expired deadline raises without touching the wire.

        ``trace_id`` (a sampled request's id) rides the frame meta so the
        server's stages record their spans under it; the stub records its
        own ``client.pack`` and ``client.rpc`` spans in the process-local
        ring and makes the id the round-trip histogram's exemplar. None adds
        no meta key and records nothing."""
        if deadline is not None and deadline - time.time() <= 0:
            raise DeadlineExceeded(f"deadline expired before calling {fname}")
        if not self._mux:
            return self._call_serial(fname, args, kwargs, timeout, deadline, trace_id)
        with self._lock:
            self._ensure_connected_locked()
            epoch = self._epoch
            peer_wire = self._wire and self._peer_wire
        rid = next(self._req_counter)
        meta = {"req_id": rid}
        if self._wire:
            meta[WIRE_META_KEY] = 1  # the capability advert
        if trace_id is not None:
            meta[obs_spans.TRACE_META_KEY] = trace_id
        wait = timeout
        if deadline is not None:
            budget = deadline - time.time()
            if budget <= 0:
                raise DeadlineExceeded(f"deadline expired before sending {fname}")
            meta["deadline_s"] = budget
            w = budget + self.DEADLINE_GRACE
            wait = w if wait is None else min(wait, w)
        # pack outside the lock and before touching the socket: a pickling
        # failure must not tear down a healthy connection
        if trace_id is not None:
            w0, p0 = time.time(), time.perf_counter()
        parts = None
        if peer_wire:
            # None (a call outside the binary schema) falls back to pickle
            # for this frame only
            parts = pack_binary_call(fname, tuple(args), kwargs or {}, meta)
        if parts is None:
            parts = pack_frame(KIND_CALL, (fname, tuple(args), kwargs or {}, meta))
        if trace_id is not None:
            obs_spans.local_buffer().record(trace_id, "client.pack", w0,
                                            time.perf_counter() - p0, fname=fname,
                                            server=self.id)
        slot = _PendingCall(rid, fname)
        w0 = time.time() if trace_id is not None else 0.0
        t0 = time.perf_counter()
        with self._lock:
            if self._shutdown:
                raise RuntimeError(f"client to {self.host}:{self.port} is closed")
            if self._closed or epoch != self._epoch:
                raise ConnectionResetError(
                    f"connection to {self.host}:{self.port} lost before sending {fname}")
            self._pending[rid] = slot
            self._inflight_peak = max(self._inflight_peak, len(self._pending))
            try:
                send_parts(self.sock, parts)
            except BaseException as e:
                # a torn mid-frame write desyncs the stream for every call
                self._fail_locked(e)
                raise
        if not slot.event.wait(wait):
            exc = socket.timeout(f"no response to {fname} within {wait:.3f}s")
            with self._lock:
                owned = self._pending.pop(rid, None) is not None
                if owned:
                    slot.error = exc
                    # nothing arrived since this call was sent: the peer is
                    # hung — drop the connection; otherwise only this call
                    # is slow, and its late response is dropped by req_id
                    if epoch == self._epoch and self._last_rx < slot.sent_t:
                        self._fail_locked(exc)
            if owned:
                slot.event.set()
            elif not slot.event.wait(timeout=3.0):
                raise exc
        if slot.error is not None:
            raise slot.error
        self._note_round_trip(fname, trace_id, w0, time.perf_counter() - t0)
        return self._interpret(slot.kind, slot.payload, fname)

    def _call_serial(self, fname, args, kwargs, timeout, deadline, trace_id=None):
        """The serial client: ``_lock`` held across the whole round trip;
        the frame carries a meta element only when a deadline or a trace
        sets a key."""
        with self._lock:
            self._ensure_connected_locked()
            meta = {}
            if trace_id is not None:
                meta[obs_spans.TRACE_META_KEY] = trace_id
            if deadline is not None:
                budget = deadline - time.time()
                if budget <= 0:
                    raise DeadlineExceeded(f"deadline expired before sending {fname}")
                wait = budget + self.DEADLINE_GRACE
                timeout = wait if timeout is None else min(timeout, wait)
                meta["deadline_s"] = budget
            payload = (fname, tuple(args), kwargs or {})
            if meta:
                payload = payload + (meta,)
            parts = pack_frame(KIND_CALL, payload)
            if timeout is not None:
                self.sock.settimeout(timeout)
            w0 = time.time() if trace_id is not None else 0.0
            t0 = time.perf_counter()
            try:
                send_parts(self.sock, parts)
                kind, payload = self._frame_reader.recv_frame()
            except Exception:
                # the stream position is unknown after any mid-call failure
                # (timeout, EOF, bad magic, unpickling): never reuse it
                self._closed = True
                self.sock.close()
                raise
            finally:
                if timeout is not None and not self._closed:
                    self.sock.settimeout(None)
        self._note_round_trip(fname, trace_id, w0, time.perf_counter() - t0)
        return self._interpret(kind, payload, fname)

    def _note_round_trip(self, fname, trace_id, w0: float, dt: float) -> None:
        """A completed round trip: the latency histogram (the trace as its
        exemplar) and, when traced, the ``client.rpc`` span: the wire both
        ways plus the server's time."""
        self.stats.record("round_trip_s", dt, exemplar=trace_id)
        if trace_id is not None:
            obs_spans.local_buffer().record(trace_id, "client.rpc", w0, dt, fname=fname,
                                            server=self.id, host=self.host, port=self.port)

    def fetch_shard(self, index_id: str, timeout: float = 120.0) -> dict:
        """This stub's rank's shard snapshot, on a connection of its own (the
        serving connection's mux window stays free)."""
        return fetch_shard(self.host, self.port, index_id, timeout,
                           self._fam == socket.AF_INET6)

    def _interpret(self, kind, payload, fname):
        if kind == KIND_RESULT:
            return payload
        if kind == KIND_ERROR:
            raise ServerException(payload)
        if kind == KIND_BUSY:
            info = payload if isinstance(payload, dict) else {}
            if info.get("reason") == "deadline":
                raise DeadlineExceeded(f"server shed {fname}: deadline expired before dispatch")
            raise BusyError(
                f"server shed {fname}: {info.get('reason', 'busy')} "
                f"(queue {info.get('queue_depth', '?')}/{info.get('max_queue', '?')})", info)
        raise RuntimeError(f"unexpected frame kind {kind}")

    def rpc_stats(self) -> dict:
        """This stub's view of its connection: serial or multiplexed, the
        wire encoding it offers and whether the peer answered in binary, the
        calls in flight now and at most, and the wire round-trip
        percentiles."""
        with self._lock:
            in_flight = len(self._pending)
            peak = self._inflight_peak
            peer_wire = self._peer_wire
        return {"mux": self._mux, "wire": "binary" if self._wire else "pickle",
                "peer_wire": peer_wire, "in_flight": in_flight, "in_flight_peak": peak,
                "round_trip_s": self.stats.summary().get("round_trip_s", {})}

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            return self.generic_fun(name, args, kwargs)

        call.__name__ = name
        return call

    def close(self):
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            reader = self._reader
            self._epoch += 1  # any live reader for this socket is now stale
            stranded = list(self._pending.values())
            self._pending.clear()
            if not self._closed:
                self._closed = True
                try:
                    send_frame(self.sock, KIND_CLOSE, None)
                except OSError:
                    pass
                finally:
                    try:
                        self.sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    self.sock.close()
        for slot in stranded:
            slot.error = RuntimeError(
                f"client to {self.host}:{self.port} closed with {slot.fname} in flight")
            slot.event.set()
        if reader is not None and reader is not threading.current_thread():
            reader.join(timeout=5.0)
