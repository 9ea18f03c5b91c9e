"""Binary message codec: native C fast path + pure-Python fallback.

Registered under the codec key ``"binary"``. Unlike the pickle codec, the
wire format is language-neutral (header map + payload, fixed-width
big-endian lengths — see ``native/codec.c`` for the layout), so non-Python
peers can speak it; the payload itself is raw bytes when ``Message.data``
is bytes/str, pickled otherwise (flagged in a reserved header).

The C extension is compiled on first use with the system compiler; if that
fails, :class:`_PyWire` implements the byte-identical format in struct
calls, so the codec works everywhere and the two paths interoperate.
"""

from __future__ import annotations

import pickle
import struct
from typing import Dict, Tuple

from ..models.message import Message
from .codecs import MessageCodec, register_message_codec

_DATA_KIND = "-bin-kind"  # reserved header: payload interpretation
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")


class _PyWire:
    """Pure-Python implementation of the native wire format."""

    @staticmethod
    def encode(headers: Dict[str, str], payload: bytes) -> bytes:
        parts = [b"S1", _U16.pack(len(headers))]
        for k, v in headers.items():
            kb, vb = k.encode(), v.encode()
            parts += [_U16.pack(len(kb)), kb, _U32.pack(len(vb)), vb]
        parts += [_U32.pack(len(payload)), payload]
        return b"".join(parts)

    @staticmethod
    def decode(buf: bytes) -> Tuple[Dict[str, str], bytes]:
        if len(buf) < 8 or buf[:2] != b"S1":
            raise ValueError("bad magic")
        (hcount,) = _U16.unpack_from(buf, 2)
        offset = 4
        headers: Dict[str, str] = {}
        try:
            for _ in range(hcount):
                (klen,) = _U16.unpack_from(buf, offset)
                offset += 2
                k = buf[offset : offset + klen].decode()
                offset += klen
                (vlen,) = _U32.unpack_from(buf, offset)
                offset += 4
                headers[k] = buf[offset : offset + vlen].decode()
                offset += vlen
            (plen,) = _U32.unpack_from(buf, offset)
            offset += 4
            payload = buf[offset : offset + plen]
            if len(payload) != plen:
                raise ValueError("truncated frame")
        except struct.error as e:
            raise ValueError("truncated frame") from e
        return headers, payload


def _load_wire():
    from ..native import load_codec

    return load_codec() or _PyWire


class BinaryMessageCodec(MessageCodec):
    """Message <-> native wire format (C extension when buildable).

    The wire backend resolves lazily on first use, so importing the
    transport package never shells out to a compiler; a failed build is
    cached (in native.load_codec) and falls back to the Python format."""

    def __init__(self, wire=None):
        self._wire_override = wire

    @property
    def _wire(self):
        if self._wire_override is None:
            self._wire_override = _load_wire()
        return self._wire_override

    @property
    def is_native(self) -> bool:
        return self._wire is not _PyWire

    def encode(self, message: Message) -> bytes:
        headers = dict(message.headers)
        data = message.data
        if data is None:
            kind, payload = "none", b""
        elif isinstance(data, bytes):
            kind, payload = "bytes", data
        elif isinstance(data, str):
            kind, payload = "str", data.encode()
        else:
            kind, payload = "pickle", pickle.dumps(data)
        headers[_DATA_KIND] = kind
        return self._wire.encode(headers, payload)

    def decode(self, payload: bytes) -> Message:
        headers, body = self._wire.decode(payload)
        kind = headers.pop(_DATA_KIND, "bytes")
        if kind == "none":
            data = None
        elif kind == "str":
            data = body.decode()
        elif kind == "pickle":
            data = pickle.loads(body)
        else:
            data = body
        return Message(data=data, headers=headers)


register_message_codec("binary", BinaryMessageCodec())
