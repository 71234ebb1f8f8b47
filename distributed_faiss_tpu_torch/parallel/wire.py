"""Binary skeleton codec for the hot search/result frames (counterpart of
distributed_faiss_tpu/parallel/wire.py; the same bytes for the same
frame, pinned against it by the tests).

``rpc.pack_frame`` ships ndarrays as raw dtype/shape-tagged buffer planes;
what stays pickled is each frame's container *skeleton*. This module
encodes the skeletons of the frames that carry almost all production
bytes, the search CALL and its RESULT/ERROR/BUSY responses, as a compact
schema-fixed binary layout instead: fixed little-endian structs plus
length-prefixed UTF-8 strings, **no self-describing object graph**.
Anything outside the schema (unknown ops, extra kwargs, exotic metadata
types, future meta keys) raises :class:`WireEncodeError` and the caller
falls back to the pickle skeleton for that one frame.

Layouts (all little-endian; ``str`` = u32 length + UTF-8 bytes;
tensor planes ride the frame's raw-buffer section and are referenced by
u32 plane index):

``CALL`` (kind ``KIND_CALL | WIRE_BINARY_FLAG``)::

    u8 version (=1) | u8 op_id (index into BINARY_CALL_OPS) |
    u8 meta_flags (1=req_id, 2=deadline_s, 4=trace_id) |
    [u64 req_id] [f64 deadline_s] [str trace_id] |
    str index_id | u32 query_plane | u32 top_k | u8 return_embeddings

The query plane is pinned to contiguous float32, the dtype the serving
scheduler launches from, so the encoder casts once client-side and the
server's admission ``asarray`` is a view, never a copy.

``RESULT`` body (the engine's ``(scores, labels, embeddings)`` search
return)::

    u8 version | u8 flags (1=embeddings present) | u32 scores_plane |
    labels | [value embeddings]

``labels`` opens with a u8 layout tag. Two fast layouts cover the
production metadata shapes at memcpy speed:

- ``1`` (int ids): ``u32 nrows | u32 row_len* | u8 0 | u32 nbytes |
  raw little-endian int64`` of all ids in row order, inline in the
  skeleton;
- ``2`` (uniform int tuples): the same layout with arity > 0 and a
  ``(total, arity)`` int64 block; each row slice tuple-izes on decode;
- ``0`` (generic): a ``value``, the minimal tagged encoding of the one
  dynamic slot the schema has::

      tag u8: 0 None | 1 False | 2 True | 3 i64 | 4 f64 | 5 str |
              6 tuple (u32 count + values) | 7 list (u32 count + values) |
              8 tensor-ref (u32 plane index)

``ERROR`` body: ``u8 version | str traceback``.
``BUSY`` body: ``u8 version | u8 flags (1=queue_depth, 2=max_queue) |
str reason | [i64 queue_depth] [i64 max_queue]``.

Tagged (mux) responses prefix the body with ``u64 req_id``; the rpc
layer owns that framing, this module owns the bodies.

Decode is strict: bounds-checked reads, exact consume, dtype/ndim checks
on the query plane. A garbled binary skeleton raises
:class:`WireDecodeError`, which the rpc layer turns into ``FrameError``
(a transport error), so retry, reroute and teardown handle a corrupted
binary stream exactly like a corrupted pickle one.

This module imports neither ``pickle`` nor ``rpc``:
``rpc.restricted_loads`` stays the one pickle decode entry point on the
wire.
"""

import struct

import numpy as np

# ops whose CALL frames may travel with a binary skeleton; the u8 op_id
# on the wire is the index into this tuple, so ONLY APPEND: reordering or
# removing entries changes the meaning of frames from older peers
BINARY_CALL_OPS = ("search",)

# CALL-meta keys the binary layout can carry. An unknown key fails the
# encode and the frame falls back to pickle: a future meta key is never
# silently dropped off the wire by an old binary schema.
_META_REQ_ID = 1
_META_DEADLINE = 2
_META_TRACE = 4
_KNOWN_META = frozenset({"req_id", "deadline_s", "trace_id", "wire"})

_VERSION = 1
_MAX_DEPTH = 32

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

# labels-block layout tags (RESULT frames)
_L_GENERIC = 0
_L_I64 = 1
_L_I64_TUPLES = 2

_T_NONE = 0
_T_FALSE = 1
_T_TRUE = 2
_T_INT = 3
_T_FLOAT = 4
_T_STR = 5
_T_TUPLE = 6
_T_LIST = 7
_T_TENSOR = 8

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


class WireEncodeError(ValueError):
    """The value/frame is outside the binary schema: fall back to the
    pickle skeleton for this frame (never an error surfaced to users)."""


class WireDecodeError(RuntimeError):
    """The binary skeleton bytes are malformed/truncated: the rpc layer
    re-raises as FrameError so the connection is dropped and the failure
    is transport-classified."""


# ------------------------------------------------------------------ encoding


def _enc_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    out += _U32.pack(len(b))
    out += b


def _enc_value(out: bytearray, v, arrays, depth: int = 0) -> None:
    if depth > _MAX_DEPTH:
        raise WireEncodeError("value nesting too deep for the wire schema")
    if v is None:
        out += _U8.pack(_T_NONE)
    elif v is True:
        out += _U8.pack(_T_TRUE)
    elif v is False:
        out += _U8.pack(_T_FALSE)
    elif type(v) is int:
        if not _I64_MIN <= v <= _I64_MAX:
            raise WireEncodeError("int outside i64")
        out += _U8.pack(_T_INT)
        out += _I64.pack(v)
    elif type(v) is float:
        out += _U8.pack(_T_FLOAT)
        out += _F64.pack(v)
    elif type(v) is str:
        out += _U8.pack(_T_STR)
        _enc_str(out, v)
    elif type(v) is tuple or type(v) is list:
        out += _U8.pack(_T_TUPLE if type(v) is tuple else _T_LIST)
        out += _U32.pack(len(v))
        for e in v:
            _enc_value(out, e, arrays, depth + 1)
    elif isinstance(v, np.ndarray):
        if v.dtype.hasobject:
            raise WireEncodeError("object array has no raw-buffer plane")
        out += _U8.pack(_T_TENSOR)
        out += _U32.pack(len(arrays))
        arrays.append(np.ascontiguousarray(v))
    else:
        # np scalars, custom metadata classes, dicts, bytes, ...: the
        # pickle skeleton still carries them (per-frame fallback)
        raise WireEncodeError(f"type {type(v).__name__} not in wire schema")


def encode_call(fname: str, args, kwargs, meta):
    """``(skeleton bytes, tensor planes)`` for a search-family CALL, or
    raise :class:`WireEncodeError` when anything falls outside the
    schema (the caller then packs the pickle skeleton instead)."""
    try:
        op_id = BINARY_CALL_OPS.index(fname)
    except ValueError:
        raise WireEncodeError(f"op {fname!r} has no binary CALL schema")
    a = tuple(args)
    kw = dict(kwargs or {})
    if not 2 <= len(a) <= 4:
        raise WireEncodeError("unexpected search arity")
    index_id, query = a[0], a[1]
    top_k = a[2] if len(a) > 2 else kw.pop("top_k", None)
    return_embeddings = a[3] if len(a) > 3 else kw.pop(
        "return_embeddings", False)
    if kw:
        # min_version (read-your-writes) and anything future-shaped:
        # those calls keep the pickle skeleton per frame
        raise WireEncodeError(f"kwargs {sorted(kw)} not in wire schema")
    if type(index_id) is not str or type(top_k) is not int:
        raise WireEncodeError("index_id/top_k outside wire schema")
    if not 0 <= top_k <= 0xFFFFFFFF:
        raise WireEncodeError("top_k outside u32")
    if not isinstance(return_embeddings, bool):
        raise WireEncodeError("return_embeddings must be bool")
    try:
        q = np.ascontiguousarray(query, dtype=np.float32)
    except (TypeError, ValueError):
        raise WireEncodeError("query is not a float32-coercible array")
    if q.ndim != 2:
        raise WireEncodeError("query must be 2-D")
    md = dict(meta or {})
    md.pop("wire", None)  # the binary frame itself IS the capability advert
    flags = 0
    req_id = md.pop("req_id", None)
    deadline_s = md.pop("deadline_s", None)
    trace_id = md.pop("trace_id", None)
    if md:
        raise WireEncodeError(f"meta keys {sorted(md)} not in wire schema")
    out = bytearray()
    out += _U8.pack(_VERSION)
    out += _U8.pack(op_id)
    if req_id is not None:
        if type(req_id) is not int or not 0 <= req_id <= 0xFFFFFFFFFFFFFFFF:
            raise WireEncodeError("req_id outside u64")
        flags |= _META_REQ_ID
    if deadline_s is not None:
        flags |= _META_DEADLINE
    if trace_id is not None:
        if type(trace_id) is not str:
            raise WireEncodeError("trace_id must be str")
        flags |= _META_TRACE
    out += _U8.pack(flags)
    if req_id is not None:
        out += _U64.pack(req_id)
    if deadline_s is not None:
        out += _F64.pack(float(deadline_s))
    if trace_id is not None:
        _enc_str(out, trace_id)
    _enc_str(out, index_id)
    out += _U32.pack(0)  # query plane ref (always the first plane)
    out += _U32.pack(top_k)
    out += _U8.pack(1 if return_embeddings else 0)
    return bytes(out), [q]


def _label_fastpath(labels):
    """``(layout, flat int64 plane, row lengths, arity)`` when every
    label is a plain int (layout 1) or a same-arity tuple of plain ints
    (layout 2), else None (generic per-value encoding). ``type() is``
    checks are exact on purpose: bool subclasses int and np scalars
    duck-type, and both would come back as another type through an int64
    plane."""
    if type(labels) is not list or not labels:
        return None
    for row in labels:
        if type(row) is not list:
            return None
    items = [it for row in labels for it in row]
    if not items:
        return None
    lens = [len(row) for row in labels]
    if type(items[0]) is int:
        for it in items:
            if type(it) is not int:
                return None
        try:
            flat = np.asarray(items, dtype=np.int64)
        except (OverflowError, ValueError):
            return None
        return _L_I64, flat, lens, 0
    if type(items[0]) is tuple:
        arity = len(items[0])
        if not 0 < arity <= 0xFF:
            return None
        for it in items:
            if type(it) is not tuple or len(it) != arity:
                return None
            for e in it:
                if type(e) is not int:
                    return None
        try:
            flat = np.asarray(items, dtype=np.int64)
        except (OverflowError, ValueError):
            return None
        return _L_I64_TUPLES, flat, lens, arity
    return None


def _enc_labels(out: bytearray, labels, arrays) -> None:
    spec = _label_fastpath(labels)
    if spec is None:
        out += _U8.pack(_L_GENERIC)
        _enc_value(out, labels, arrays)
        return
    layout, flat, lens, arity = spec
    out += _U8.pack(layout)
    out += _U32.pack(len(lens))
    out += struct.pack(f"<{len(lens)}I", *lens)
    out += _U8.pack(arity)
    raw = np.ascontiguousarray(flat, dtype="<i8").tobytes()
    out += _U32.pack(len(raw))
    out += raw


def _dec_labels(r: "_Reader", arrays):
    layout = r.u8()
    if layout == _L_GENERIC:
        return _dec_value(r, arrays)
    if layout not in (_L_I64, _L_I64_TUPLES):
        raise WireDecodeError(f"unknown label layout {layout}")
    nrows = r.u32()
    if 4 * nrows > len(r.buf):
        raise WireDecodeError(f"label row count {nrows} exceeds frame")
    lens = struct.unpack(f"<{nrows}I", r.take(4 * nrows))
    arity = r.u8()
    nbytes = r.u32()
    flat = np.frombuffer(r.take(nbytes), dtype="<i8")
    total = sum(lens)
    if layout == _L_I64:
        if flat.shape[0] != total:
            raise WireDecodeError("label block shape mismatch")
        vals = flat.tolist()
    else:
        if flat.shape[0] != total * arity or arity == 0:
            raise WireDecodeError("label tuple block shape mismatch")
        vals = list(map(tuple, flat.reshape(total, arity).tolist()))
    out, ofs = [], 0
    for n in lens:
        out.append(vals[ofs:ofs + n])
        ofs += n
    return out


def encode_result(payload):
    """Binary body for a search RESULT: the engine's
    ``(scores, labels, embeddings)`` 3-tuple. Anything else (scalar
    results of other ops, unexpected shapes) raises and falls back."""
    if not (type(payload) is tuple and len(payload) == 3):
        raise WireEncodeError("result is not the (scores, labels, embs) "
                              "search shape")
    scores, labels, embs = payload
    if not isinstance(scores, np.ndarray) or scores.dtype.hasobject:
        raise WireEncodeError("scores is not a raw-buffer ndarray")
    if type(labels) is not list:
        raise WireEncodeError("labels is not a list")
    if embs is not None and type(embs) is not list:
        raise WireEncodeError("embeddings slot is neither None nor a list")
    arrays = [np.ascontiguousarray(scores)]
    out = bytearray()
    out += _U8.pack(_VERSION)
    out += _U8.pack(1 if embs is not None else 0)
    out += _U32.pack(0)  # scores plane ref
    _enc_labels(out, labels, arrays)
    if embs is not None:
        _enc_value(out, embs, arrays)
    return bytes(out), arrays


def encode_error(payload):
    """Binary body for an ERROR frame (a server traceback string)."""
    if type(payload) is not str:
        raise WireEncodeError("error payload is not a traceback string")
    out = bytearray()
    out += _U8.pack(_VERSION)
    _enc_str(out, payload)
    return bytes(out), []


def encode_busy(payload):
    """Binary body for a BUSY frame (the structured shed dict)."""
    if type(payload) is not dict:
        raise WireEncodeError("busy payload is not a dict")
    extra = set(payload) - {"reason", "queue_depth", "max_queue"}
    if extra:
        raise WireEncodeError(f"busy keys {sorted(extra)} not in wire schema")
    reason = payload.get("reason")
    if type(reason) is not str:
        raise WireEncodeError("busy reason is not a string")
    flags = 0
    qd, mq = payload.get("queue_depth"), payload.get("max_queue")
    for present, bit, v in ((qd is not None, 1, qd), (mq is not None, 2, mq)):
        if present:
            if type(v) is not int or not _I64_MIN <= v <= _I64_MAX:
                raise WireEncodeError("busy counter outside i64")
            flags |= bit
    out = bytearray()
    out += _U8.pack(_VERSION)
    out += _U8.pack(flags)
    _enc_str(out, reason)
    if qd is not None:
        out += _I64.pack(qd)
    if mq is not None:
        out += _I64.pack(mq)
    return bytes(out), []


# ------------------------------------------------------------------ decoding


class _Reader:
    """Offset-tracking reads over the skeleton bytes (bytes or a
    memoryview); only string fields pay a bytes() conversion for
    ``.decode``."""

    __slots__ = ("buf", "ofs")

    def __init__(self, buf):
        self.buf = buf
        self.ofs = 0

    def take(self, n: int):
        if self.ofs + n > len(self.buf):
            raise WireDecodeError("truncated binary skeleton")
        b = self.buf[self.ofs:self.ofs + n]
        self.ofs += n
        return b

    def u8(self) -> int:
        return _U8.unpack(self.take(1))[0]

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]

    def u64(self) -> int:
        return _U64.unpack(self.take(8))[0]

    def i64(self) -> int:
        return _I64.unpack(self.take(8))[0]

    def f64(self) -> float:
        return _F64.unpack(self.take(8))[0]

    def s(self) -> str:
        n = self.u32()
        try:
            return bytes(self.take(n)).decode("utf-8")
        except UnicodeDecodeError as e:
            raise WireDecodeError(f"non-UTF-8 string field: {e}")

    def done(self) -> None:
        if self.ofs != len(self.buf):
            raise WireDecodeError(
                f"{len(self.buf) - self.ofs} trailing bytes after skeleton")


def _plane(arrays, idx: int) -> np.ndarray:
    if not 0 <= idx < len(arrays):
        raise WireDecodeError(f"tensor plane {idx} out of range "
                              f"({len(arrays)} planes)")
    return arrays[idx]


def _dec_value(r: _Reader, arrays, depth: int = 0):
    if depth > _MAX_DEPTH:
        raise WireDecodeError("value nesting too deep")
    tag = r.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_FALSE:
        return False
    if tag == _T_TRUE:
        return True
    if tag == _T_INT:
        return r.i64()
    if tag == _T_FLOAT:
        return r.f64()
    if tag == _T_STR:
        return r.s()
    if tag in (_T_TUPLE, _T_LIST):
        n = r.u32()
        if n > len(r.buf):  # a garbled count cannot demand more elements
            raise WireDecodeError(f"container count {n} exceeds frame")
        vals = [_dec_value(r, arrays, depth + 1) for _ in range(n)]
        return tuple(vals) if tag == _T_TUPLE else vals
    if tag == _T_TENSOR:
        return _plane(arrays, r.u32())
    raise WireDecodeError(f"unknown value tag {tag}")


def _check_version(r: _Reader) -> None:
    v = r.u8()
    if v != _VERSION:
        raise WireDecodeError(f"unknown binary skeleton version {v}")


def decode_call(skel: bytes, arrays):
    """``(fname, args, kwargs, meta)``: the exact payload shape the pickle
    path produces, so the server's dispatch is shared. The query plane is
    checked float32 2-D: the scheduler's concat consumes it without a
    copy."""
    r = _Reader(skel)
    _check_version(r)
    op_id = r.u8()
    if not 0 <= op_id < len(BINARY_CALL_OPS):
        raise WireDecodeError(f"unknown binary op id {op_id}")
    fname = BINARY_CALL_OPS[op_id]
    flags = r.u8()
    meta = {"wire": 1}  # a binary frame is itself the capability advert
    if flags & _META_REQ_ID:
        meta["req_id"] = r.u64()
    if flags & _META_DEADLINE:
        meta["deadline_s"] = r.f64()
    if flags & _META_TRACE:
        meta["trace_id"] = r.s()
    index_id = r.s()
    q = _plane(arrays, r.u32())
    top_k = r.u32()
    return_embeddings = bool(r.u8())
    r.done()
    if q.dtype != np.float32 or q.ndim != 2:
        raise WireDecodeError(
            f"query plane is {q.dtype}/{q.ndim}-D, schema pins float32 2-D")
    return fname, (index_id, q, top_k, return_embeddings), {}, meta


def decode_result(skel: bytes, arrays):
    r = _Reader(skel)
    _check_version(r)
    flags = r.u8()
    scores = _plane(arrays, r.u32())
    labels = _dec_labels(r, arrays)
    embs = _dec_value(r, arrays) if flags & 1 else None
    r.done()
    if type(labels) is not list:
        raise WireDecodeError("labels block is not a list")
    if embs is not None and type(embs) is not list:
        raise WireDecodeError("embeddings block is not a list")
    return scores, labels, embs


def decode_error(skel: bytes, arrays):
    r = _Reader(skel)
    _check_version(r)
    tb = r.s()
    r.done()
    return tb


def decode_busy(skel: bytes, arrays):
    r = _Reader(skel)
    _check_version(r)
    flags = r.u8()
    out = {"reason": r.s()}
    if flags & 1:
        out["queue_depth"] = r.i64()
    if flags & 2:
        out["max_queue"] = r.i64()
    r.done()
    return out
