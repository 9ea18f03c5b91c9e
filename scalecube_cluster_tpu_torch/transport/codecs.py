"""Pluggable wire codecs.

Parity with the reference codec layer: ``MessageCodec``
(``MessageCodec.java:8-27``, stream-based message serialization applied at the
channel boundary, ``TransportImpl.java:240-260``) and ``MetadataCodec``
(ByteBuffer-based); implementations are discovered via a registry (the
``META-INF/services`` ServiceLoader analogue). The reference ships JDK
serialization (default), Jackson-JSON and Jackson-Smile; here:

* ``jdk``  -> pickle (the platform-native object serialization, default);
* ``json`` -> UTF-8 JSON (cross-language, payload must be JSON-encodable);
* ``smile`` is a binary-JSON variant in the reference; our binary alternative
  is the pickle codec, so ``smile`` aliases ``jdk``.
"""

from __future__ import annotations

import json
import pickle
from abc import ABC, abstractmethod
from typing import Any, Dict

from ..models.message import Message


class MessageCodec(ABC):
    """Message <-> bytes (reference MessageCodec.java:8-27)."""

    @abstractmethod
    def encode(self, message: Message) -> bytes: ...

    @abstractmethod
    def decode(self, payload: bytes) -> Message: ...


class PickleMessageCodec(MessageCodec):
    """Platform-native serialization (reference JdkMessageCodec.java:9)."""

    def encode(self, message: Message) -> bytes:
        return pickle.dumps((message.headers, message.data), protocol=pickle.HIGHEST_PROTOCOL)

    def decode(self, payload: bytes) -> Message:
        headers, data = pickle.loads(payload)
        return Message(headers=headers, data=data)


class JsonMessageCodec(MessageCodec):
    """Cross-language JSON codec (reference JacksonMessageCodec.java:9)."""

    def encode(self, message: Message) -> bytes:
        return json.dumps({"headers": message.headers, "data": message.data}).encode("utf-8")

    def decode(self, payload: bytes) -> Message:
        obj = json.loads(payload.decode("utf-8"))
        return Message(headers=obj.get("headers", {}), data=obj.get("data"))


class MetadataCodec(ABC):
    """Metadata object <-> bytes (reference MetadataCodec interface)."""

    @abstractmethod
    def serialize(self, metadata: Any) -> bytes: ...

    @abstractmethod
    def deserialize(self, payload: bytes) -> Any: ...


class PickleMetadataCodec(MetadataCodec):
    def serialize(self, metadata: Any) -> bytes:
        return pickle.dumps(metadata, protocol=pickle.HIGHEST_PROTOCOL)

    def deserialize(self, payload: bytes) -> Any:
        return pickle.loads(payload)


class JsonMetadataCodec(MetadataCodec):
    def serialize(self, metadata: Any) -> bytes:
        return json.dumps(metadata).encode("utf-8")

    def deserialize(self, payload: bytes) -> Any:
        return json.loads(payload.decode("utf-8"))


_MESSAGE_CODECS: Dict[str, MessageCodec] = {}
_METADATA_CODECS: Dict[str, MetadataCodec] = {}


def register_message_codec(name: str, codec: MessageCodec) -> None:
    _MESSAGE_CODECS[name] = codec


def register_metadata_codec(name: str, codec: MetadataCodec) -> None:
    _METADATA_CODECS[name] = codec


def message_codec(name: str) -> MessageCodec:
    try:
        return _MESSAGE_CODECS[name]
    except KeyError:
        raise ValueError(f"unknown message codec {name!r}; registered: {sorted(_MESSAGE_CODECS)}") from None


def metadata_codec(name: str) -> MetadataCodec:
    try:
        return _METADATA_CODECS[name]
    except KeyError:
        raise ValueError(f"unknown metadata codec {name!r}; registered: {sorted(_METADATA_CODECS)}") from None


register_message_codec("jdk", PickleMessageCodec())
register_message_codec("smile", PickleMessageCodec())
register_message_codec("json", JsonMessageCodec())
register_metadata_codec("jdk", PickleMetadataCodec())
register_metadata_codec("json", JsonMetadataCodec())
