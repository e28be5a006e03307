"""Wire protocol for the serve network edge (port of
`mpisppy_tpu/serve/net/protocol.py`): versioned length-prefixed
frames with the `MTSHARD1`-style magic/format discipline
(streaming/store.py), spoken by `gateway.Gateway` and `client.Client`.

One MESSAGE on the wire is

    bytes 0..8     magic  b"MTNETP1\\0"
    bytes 8..12    uint32 header length H (little-endian)
    bytes 12..12+H header JSON: proto, kind ("request"/"response"),
                   verb, payload_len, payload_crc32, plus per-verb
                   fields (token, options, handle, result, ...)
    rest           payload bytes (payload_len long): an .npz holding
                   the request's ScenarioBatch (submit/solve) or the
                   result's array fields (result/solve responses);
                   empty for array-free messages

and `read_message` re-validates ALL of it on every read — magic,
header JSON, declared vs received payload length, CRC32 over the
payload bytes — mirroring the shard store's `read_checked` contract:
a torn, foreign, or corrupted frame raises `ProtocolError`, never a
partially-decoded message.

Verbs: ``submit / poll / result / solve / health / drain / roll``.
Error codes are the union of gateway-level frame/auth failures and the
router's structured reject reasons (the gateway maps one onto the
other — see ERROR_CODES and doc/src/serve.md's error-code matrix).

Trust boundary: payload bytes come from the NETWORK, so — unlike the
shard store, whose npz codec reads trusted on-disk data — this module
NEVER unpickles them.  Every `np.load` here passes
`allow_pickle=False`; the object-dtype fields a ScenarioBatch payload
needs (name tuples, `model_meta`) travel as a JSON sidecar plus a
pool of plain numeric arrays (`_meta_encode`/`_meta_decode`), so a
crafted pickle inside a frame is a decode error, not code execution.

The frames are the JAX package's byte for byte, so a client of either
package talks to a gateway of the other.

Layering (checked in tests/test_torch_no_jax.py): this module imports
no torch at module level — batch (de)serialization reuses the shard
store's npz payload helpers, imported inside the call; a decoded batch
holds CPU tensors.
"""

from __future__ import annotations

import io
import json
import struct
import zlib

import numpy as np

MAGIC = b"MTNETP1\0"
PROTO_FORMAT = 1

# hard caps: a single corrupt length field must not make the reader
# allocate unbounded memory
MAX_HEADER_BYTES = 1 << 20          # 1 MiB of JSON is already absurd
DEFAULT_MAX_PAYLOAD = 1 << 28       # 256 MiB per frame

VERBS = ("submit", "poll", "result", "solve", "health", "drain", "roll",
         # replica-worker verbs (serve/procworker.py): the gateway
         # rejects these with E_BAD_VERB — it has no handlers for them
         "peek", "peek_many", "statuses", "warm_from", "shutdown")

# -- error-code matrix (doc/src/serve.md) ----------------------------------
# gateway-level codes: the request never reached the router
E_BAD_FRAME = "bad_frame"            # torn/foreign/corrupt frame
E_BAD_VERB = "bad_verb"              # verb outside VERBS
E_BAD_PAYLOAD = "bad_payload"        # frame ok, batch/npz undecodable
E_UNAUTHORIZED = "unauthorized"      # bearer token unknown
E_UNKNOWN_HANDLE = "unknown_handle"  # poll/result for a foreign id
E_PAYLOAD_TOO_LARGE = "payload_too_large"
E_DRAINING = "draining"              # gateway OR replica drain closed
                                     # admission (one code, both layers)
E_INTERNAL = "internal"              # handler raised (bug, not client)

#: every wire error code -> which layer rejects, and why.  Router codes
#: are the structured reject/failure reasons of serve/router.py and
#: serve/service.py, passed through verbatim as `error_code` so a
#: client switch()es on ONE namespace.
ERROR_CODES = {
    E_BAD_FRAME: "gateway: magic/length/CRC/JSON validation failed",
    E_BAD_VERB: "gateway: verb not in protocol.VERBS",
    E_BAD_PAYLOAD: "gateway: payload npz undecodable",
    E_UNAUTHORIZED: "gateway: bearer token not in gateway_tokens",
    E_UNKNOWN_HANDLE: "gateway: handle id this router never issued",
    E_PAYLOAD_TOO_LARGE: "gateway: payload exceeds gateway_max_payload",
    E_DRAINING: "gateway drain() or a replica drain closed admission",
    E_INTERNAL: "gateway: handler error (server-side bug)",
    "over_quota": "router: tenant token bucket empty",
    "brownout_shed": "router: brownout level 3 shed low priority",
    "shutdown": "router/service: shut down",
    "queue_full": "service: bounded queue at capacity",
    "max_inflight": "service: inflight admission cap",
    "service_failed": "service: restart budget spent, failed closed",
    "drained": "service: request was drained to a checkpoint",
    "quarantined": "router: poison budget spent on this request",
    "timeout": "deadline exceeded (queued/dispatch/iteration/wait)",
    "failed": "solver/worker failure after the attempt budget",
}


class ProtocolError(RuntimeError):
    """A frame failed validation (torn, foreign, corrupt, oversized)."""


# -- framing ---------------------------------------------------------------

def pack_message(header, payload=b""):
    """One wire message's byte image: magic + header JSON + payload,
    with payload_len and an honest CRC32 stamped into the header."""
    hdr = dict(header)
    hdr["proto"] = PROTO_FORMAT
    hdr["payload_len"] = len(payload)
    hdr["payload_crc32"] = zlib.crc32(payload) & 0xFFFFFFFF
    hjson = json.dumps(hdr).encode("utf-8")
    if len(hjson) > MAX_HEADER_BYTES:
        raise ProtocolError(f"header too large ({len(hjson)} bytes)")
    return MAGIC + struct.pack("<I", len(hjson)) + hjson + payload


def recv_exact(sock, n):
    """Read exactly n bytes from a socket; raises ProtocolError on a
    mid-message EOF (a clean EOF at a message boundary is the caller's
    to detect via recv_opt)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ProtocolError(
                f"connection closed mid-message ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_message(sock, max_payload=DEFAULT_MAX_PAYLOAD, on_bytes=None):
    """Read + validate one message from a socket.  Returns
    (header_dict, payload_bytes); returns (None, None) on a clean EOF
    at a message boundary; raises ProtocolError on anything torn,
    foreign, oversized, or failing CRC.  `on_bytes` (if given) is
    called with the exact frame size on success — the gateway's
    bytes_in accounting tap."""
    first = sock.recv(1)
    if not first:
        return None, None
    head = first + recv_exact(sock, len(MAGIC) + 4 - 1)
    if head[:len(MAGIC)] != MAGIC:
        raise ProtocolError("bad magic (foreign or torn stream)")
    (hlen,) = struct.unpack("<I", head[len(MAGIC):])
    if hlen > MAX_HEADER_BYTES:
        raise ProtocolError(f"header length {hlen} exceeds cap")
    try:
        header = json.loads(recv_exact(sock, hlen).decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ProtocolError(f"unparseable header JSON: {e}")
    if int(header.get("proto", -1)) != PROTO_FORMAT:
        raise ProtocolError(
            f"unsupported protocol version {header.get('proto')!r}")
    plen = int(header.get("payload_len", 0))
    if plen < 0 or plen > max_payload:
        raise ProtocolError(
            f"payload length {plen} exceeds cap {max_payload}")
    payload = recv_exact(sock, plen) if plen else b""
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    if crc != int(header.get("payload_crc32", -1)):
        raise ProtocolError(
            f"payload CRC mismatch: computed {crc:#010x}, header "
            f"{int(header.get('payload_crc32', -1)):#010x}")
    if on_bytes is not None:
        on_bytes(len(MAGIC) + 4 + hlen + plen)
    return header, payload


def write_message(sock, header, payload=b""):
    """pack_message + sendall; returns the bytes written (the
    gateway's bytes_out accounting input)."""
    data = pack_message(header, payload)
    sock.sendall(data)
    return len(data)


# -- ScenarioBatch payloads ------------------------------------------------
#
# The shard store's payload dict holds object-dtype arrays (the name
# tuples, and model_meta — an arbitrary pytree of dicts/tuples/numpy
# arrays).  Saved as-is those would need allow_pickle=True on load,
# which at a network trust boundary means arbitrary code execution.
# The wire codec therefore splits them: strings and structure go into
# a JSON sidecar (stored as a uint8 array under _WIRE_JSON), numeric
# leaves of model_meta go into the npz array pool under reserved
# _WIRE_META_ARR keys, and decode reassembles with allow_pickle=False.

_WIRE_JSON = "_wire_json"
_WIRE_META_ARR = "_wire_meta_arr_"
_NAME_FIELDS = ("tree_nonant_names", "tree_scen_names", "var_names")
_TAG_ND = "__nd__"
_TAG_TUPLE = "__tuple__"


def _meta_encode(value, arrays):
    """model_meta pytree -> JSON-safe tagged tree.  ndarrays move into
    `arrays` under reserved npz keys (bit-exact); tuples are tagged so
    decode restores tuple-ness (pytree structure survives).  Anything
    not JSON/array-representable is a ProtocolError — the wire carries
    data, never pickled code."""
    if isinstance(value, np.ndarray):
        key = f"{_WIRE_META_ARR}{len(arrays)}"
        arrays[key] = value
        return {_TAG_ND: key}
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, dict):
        return {str(k): _meta_encode(v, arrays) for k, v in value.items()}
    if isinstance(value, tuple):
        return {_TAG_TUPLE: [_meta_encode(v, arrays) for v in value]}
    if isinstance(value, list):
        return [_meta_encode(v, arrays) for v in value]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    raise ProtocolError(
        f"model_meta value of type {type(value).__name__} is not "
        f"wire-encodable (JSON scalars, lists, tuples, dicts and "
        f"numpy arrays only)")


def _meta_decode(node, z):
    """Inverse of _meta_encode against the npz array pool `z`."""
    if isinstance(node, dict):
        if set(node) == {_TAG_ND}:
            key = node[_TAG_ND]
            if not (isinstance(key, str)
                    and key.startswith(_WIRE_META_ARR)):
                raise ProtocolError(f"bad meta array reference {key!r}")
            return np.asarray(z[key])
        if set(node) == {_TAG_TUPLE}:
            return tuple(_meta_decode(v, z) for v in node[_TAG_TUPLE])
        return {k: _meta_decode(v, z) for k, v in node.items()}
    if isinstance(node, list):
        return [_meta_decode(v, z) for v in node]
    return node


def encode_batch(batch):
    """ScenarioBatch -> npz bytes, reusing the shard store's payload
    codec so the A representation (dense / shared / SplitA) survives
    the wire exactly like it survives disk — minus its object arrays,
    which are re-encoded pickle-free (see the section comment)."""
    from ...streaming.store import _batch_payload
    raw = _batch_payload(batch)
    raw.pop("model_meta", None)        # re-encoded from batch below
    arrays, names = {}, {}
    for k, v in raw.items():
        a = np.asarray(v)
        if a.dtype == object:          # the *_names string tuples
            names[k] = [str(s) for s in a.tolist()]
        else:
            arrays[k] = a
    side = {"names": names}
    if batch.model_meta is not None:
        side["model_meta"] = _meta_encode(batch.model_meta, arrays)
    arrays[_WIRE_JSON] = np.frombuffer(
        json.dumps(side).encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    # uncompressed on purpose: payloads are a few KiB and zlib costs
    # ~40% of the encode on the submit path, which a process-replica
    # parent pays once per request on the loopback wire
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode_batch(data):
    """npz bytes -> ScenarioBatch (inverse of encode_batch).  Network
    bytes: `allow_pickle=False`, so a crafted object array raises
    instead of executing."""
    from ...streaming.store import _batch_from_payload
    z = np.load(io.BytesIO(data), allow_pickle=False)
    payload = {k: np.asarray(z[k]) for k in z.files
               if k != _WIRE_JSON and not k.startswith(_WIRE_META_ARR)}
    if _WIRE_JSON not in z.files:
        raise ProtocolError("batch payload missing wire sidecar")
    side = json.loads(
        np.asarray(z[_WIRE_JSON]).tobytes().decode("utf-8"))
    for k, v in (side.get("names") or {}).items():
        if k not in _NAME_FIELDS:
            raise ProtocolError(f"unexpected sidecar name field {k!r}")
        payload[k] = np.array([str(s) for s in v], dtype=object)
    if "model_meta" in side:
        meta = np.empty(1, dtype=object)
        meta[0] = _meta_decode(side["model_meta"], z)
        payload["model_meta"] = meta
    return _batch_from_payload(payload)


# -- result dicts ----------------------------------------------------------

def jsonable(value):
    """Recursively convert a structured result value to JSON-safe form:
    numpy scalars -> Python scalars, tuples -> lists.  Arrays are NOT
    accepted here — encode_result routes them to the npz payload."""
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, np.ndarray):
        raise TypeError("arrays belong in the payload, not the header")
    if isinstance(value, dict):
        return {str(k): jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set)):
        return [jsonable(v) for v in value]
    return value


def encode_result(res):
    """Split one structured result dict into (json_header_result,
    payload_bytes): ndarray values move to an npz payload (bit-exact),
    everything else is JSON — CPython's shortest-repr float round-trip
    keeps scalar doubles bitwise too, which is what lets a wire result
    stay bitwise-equal to the in-process one."""
    scalars, arrays = {}, {}
    for k, v in dict(res).items():
        if isinstance(v, np.ndarray):
            if v.dtype == object:      # would need pickle on the wire
                raise TypeError(
                    f"result field {k!r} is an object-dtype array; "
                    f"only numeric/string arrays are wire-encodable")
            arrays[k] = v
        else:
            scalars[k] = jsonable(v)
    payload = b""
    if arrays:
        buf = io.BytesIO()
        # uncompressed for the same reason as encode_batch: the codec
        # CPU, not the byte count, is what the wire path pays for
        np.savez(buf, **arrays)
        payload = buf.getvalue()
    scalars["_array_keys"] = sorted(arrays)
    return scalars, payload


def decode_result(header_result, payload):
    """Inverse of encode_result.  Network bytes: `allow_pickle=False`
    (a malicious or confused peer gets a decode error, not code
    execution in the client)."""
    res = dict(header_result)
    keys = res.pop("_array_keys", [])
    if keys:
        z = np.load(io.BytesIO(payload), allow_pickle=False)
        for k in keys:
            res[k] = np.asarray(z[k])
    return res
