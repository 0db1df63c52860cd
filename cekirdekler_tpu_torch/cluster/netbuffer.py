"""Cluster wire format: length-prefixed binary messages with typed array
records.

A copy of the reference's ``cluster/netbuffer.py`` kept in the port (which
never imports the JAX package), byte for byte on the wire: a message one
package encodes, the other decodes (``tests/test_torch_cluster.py``).  The
``socket-drop`` fault sites sit on the port's fault plane.  The text below
is the reference's.

The capability equivalent of the reference's ``NetworkBuffer``
(NetworkBuffer.cs): command codes (:109-126), typed per-array records
identified by client-side ids (:645-846), and a length header (:196-209).
The 8 KB segmentation is an artifact of its socket loop and is dropped —
Python sockets stream; framing is one ``!BQ`` header (command,
payload-length) followed by the payload.

Message payload layout (all little-endian via struct '<'):
  u32 n_meta | n_meta × (u16 key_len, key bytes, i64 value)   — int metadata
  u32 n_strs | n_strs × (u16 len, utf8)                       — string list
  u32 n_vals | n_vals × (u8 tag, f64|i64)                     — scalar values
  u32 n_arrs | n_arrs × array record
array record:
  u64 id | u8 dtype_code | u8 flags | u32 epw | u64 offset | u64 nbytes | raw
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from ..utils.faultinject import FAULTS

__all__ = [
    "Command",
    "ArrayRecord",
    "Message",
    "send_message",
    "recv_message",
]


class Command:
    """Command codes (reference: NetworkBuffer.cs:109-126)."""

    SETUP = 1
    COMPUTE = 2
    DISPOSE = 3
    CONTROL = 4
    NUM_DEVICES = 5
    SERVER_STOP = 6
    ANSWER_COMPUTE = 32
    ANSWER_SETUP = 33
    ANSWER_CONTROL = 34
    ANSWER_NUM_DEVICES = 35
    ANSWER_ERROR = 63


_DTYPES = [
    np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.int32),
    np.dtype(np.uint32), np.dtype(np.int64), np.dtype(np.uint8),
    np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.uint16),
    np.dtype(np.uint64),
]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}

FLAG_READ = 1
FLAG_PARTIAL = 2
FLAG_WRITE = 4
FLAG_WRITE_ALL = 8


@dataclass
class ArrayRecord:
    array_id: int
    data: np.ndarray          # the payload bytes view (may be a slice)
    flags: int = FLAG_READ | FLAG_WRITE
    epw: int = 1
    offset: int = 0           # element offset this record's data starts at


@dataclass
class Message:
    command: int
    meta: dict[str, int] = field(default_factory=dict)
    strings: list[str] = field(default_factory=list)
    values: list = field(default_factory=list)
    arrays: list[ArrayRecord] = field(default_factory=list)

    # -- encoding ------------------------------------------------------------
    def encode(self) -> bytes:
        parts: list[bytes] = []
        parts.append(struct.pack("<I", len(self.meta)))
        for k, v in self.meta.items():
            kb = k.encode()
            parts.append(struct.pack("<H", len(kb)) + kb + struct.pack("<q", int(v)))
        parts.append(struct.pack("<I", len(self.strings)))
        for s in self.strings:
            sb = s.encode()
            parts.append(struct.pack("<I", len(sb)) + sb)
        parts.append(struct.pack("<I", len(self.values)))
        for v in self.values:
            if isinstance(v, (int, np.integer)):
                parts.append(struct.pack("<Bq", 0, int(v)))
            else:
                parts.append(struct.pack("<Bd", 1, float(v)))
        parts.append(struct.pack("<I", len(self.arrays)))
        for rec in self.arrays:
            data = np.ascontiguousarray(rec.data)
            code = _DTYPE_CODE[data.dtype]
            raw = data.tobytes()
            parts.append(
                struct.pack(
                    "<QBBIQQ", rec.array_id, code, rec.flags, rec.epw,
                    rec.offset, len(raw),
                )
            )
            parts.append(raw)
        return b"".join(parts)

    @staticmethod
    def decode(command: int, payload: bytes) -> "Message":
        msg = Message(command)
        off = 0

        def take(fmt: str):
            nonlocal off
            size = struct.calcsize(fmt)
            out = struct.unpack_from(fmt, payload, off)
            off += size
            return out

        (n_meta,) = take("<I")
        for _ in range(n_meta):
            (klen,) = take("<H")
            key = payload[off : off + klen].decode()
            off += klen
            (val,) = take("<q")
            msg.meta[key] = val
        (n_strs,) = take("<I")
        for _ in range(n_strs):
            (slen,) = take("<I")
            msg.strings.append(payload[off : off + slen].decode())
            off += slen
        (n_vals,) = take("<I")
        for _ in range(n_vals):
            (tag,) = take("<B")
            if tag == 0:
                (v,) = take("<q")
                msg.values.append(int(v))
            else:
                (v,) = take("<d")
                msg.values.append(float(v))
        (n_arrs,) = take("<I")
        for _ in range(n_arrs):
            array_id, code, flags, epw, aoff, nbytes = take("<QBBIQQ")
            dt = _DTYPES[code]
            data = np.frombuffer(payload, dtype=dt, count=nbytes // dt.itemsize, offset=off)
            off += nbytes
            msg.arrays.append(ArrayRecord(array_id, data, flags, epw, aoff))
        return msg


_HEADER = struct.Struct("!BQ")


def send_message(sock, msg: Message) -> None:
    payload = msg.encode()
    data = _HEADER.pack(msg.command, len(payload)) + payload
    if FAULTS.enabled and FAULTS.fire("socket-drop", where="send"):
        # chaos plane: disconnect MID-message — half the frame lands,
        # then the socket dies (the peer's recv sees a torn message;
        # this side's next op sees a dead socket)
        try:
            sock.sendall(data[: max(1, len(data) // 2)])
        finally:
            try:
                sock.close()
            except OSError:
                pass
        raise ConnectionError("injected socket drop mid-send (CK_FAULTS)")
    sock.sendall(data)


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            raise ConnectionError("socket closed mid-message")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_message(sock) -> Message:
    if FAULTS.enabled and FAULTS.fire("socket-drop", where="recv"):
        try:
            sock.close()
        except OSError:
            pass
        raise ConnectionError("injected socket drop mid-recv (CK_FAULTS)")
    header = _recv_exact(sock, _HEADER.size)
    command, length = _HEADER.unpack(header)
    payload = _recv_exact(sock, length) if length else b""
    return Message.decode(command, payload)
