"""Metadata store: local metadata + cache of remote members' metadata.

Behavioral parity with reference ``MetadataStoreImpl``
(``cluster/metadata/MetadataStoreImpl.java:22-251``): serialized metadata
blobs cached per member; remote fetch over ``GET_METADATA_REQ/RESP``
request-response with ``metadata_timeout`` (``fetchMetadata`` :146-185); own
metadata served on request only when the requested member id matches
(``onMetadataRequest`` :201-240).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Any, Dict, Optional, Set

from ..models.member import Member
from ..models.message import (
    HEADER_CORRELATION_ID,
    Message,
    Q_METADATA_REQ,
    Q_METADATA_RESP,
)
from ..transport.api import Transport
from ..transport.codecs import MetadataCodec

_log = logging.getLogger(__name__)


@dataclass(frozen=True)
class GetMetadataRequest:
    """Reference GetMetadataRequest.java:12."""

    member: Member


@dataclass(frozen=True)
class GetMetadataResponse:
    """Reference GetMetadataResponse.java:15."""

    member: Member
    metadata: bytes


class MetadataStore:
    """One node's metadata component."""

    def __init__(
        self,
        local_member: Member,
        transport: Transport,
        codec: MetadataCodec,
        initial_metadata: Any,
        metadata_timeout: float,
    ) -> None:
        self._local = local_member
        self._transport = transport
        self._codec = codec
        self._metadata_timeout = metadata_timeout
        self._local_metadata: Optional[Any] = initial_metadata
        self._cache: Dict[str, bytes] = {}
        self._inflight: Set[asyncio.Task] = set()
        self._unsub = transport.listen().subscribe(self._on_message)

    def start(self) -> None:  # symmetry with other components
        pass

    def stop(self) -> None:
        self._unsub()
        for task in list(self._inflight):
            task.cancel()
        self._cache.clear()

    # -- local metadata ----------------------------------------------------
    def metadata(self) -> Optional[Any]:
        return self._local_metadata

    def update_local_metadata(self, metadata: Any) -> Optional[Any]:
        previous, self._local_metadata = self._local_metadata, metadata
        return previous

    # -- remote cache ------------------------------------------------------
    def member_metadata(self, member: Member) -> Optional[bytes]:
        return self._cache.get(member.id)

    def update_metadata(self, member: Member, metadata: bytes) -> Optional[bytes]:
        """Cache serialized metadata of a remote member; returns previous."""
        if member.id == self._local.id:
            raise ValueError("use update_local_metadata for the local member")
        previous = self._cache.get(member.id)
        self._cache[member.id] = metadata
        return previous

    def remove_metadata(self, member: Member) -> Optional[bytes]:
        return self._cache.pop(member.id, None)

    # -- rpc ---------------------------------------------------------------
    async def fetch_metadata(self, member: Member) -> bytes:
        """Fetch serialized metadata from ``member`` (fetchMetadata :146-185)."""
        request = Message.with_data(GetMetadataRequest(member), qualifier=Q_METADATA_REQ)
        response = await self._transport.request_response(
            member.address, request, timeout=self._metadata_timeout
        )
        data: GetMetadataResponse = response.data
        return data.metadata

    def _on_message(self, message: Message) -> None:
        if message.qualifier != Q_METADATA_REQ:
            return
        request: GetMetadataRequest = message.data
        if request.member.id != self._local.id:
            # Request for a different (restarted?) member on this address —
            # ignore; issuer's fetch times out (onMetadataRequest :201-240).
            _log.debug(
                "[%s] ignoring metadata request for %s", self._local, request.member
            )
            return
        blob = self.serialize_local()
        response = Message.with_data(
            GetMetadataResponse(self._local, blob), qualifier=Q_METADATA_RESP
        )
        if message.correlation_id is not None:
            response = response.with_header(HEADER_CORRELATION_ID, message.correlation_id)
        sender = message.sender
        if sender is None:
            return
        task = asyncio.ensure_future(self._send_quietly(sender, response))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    def serialize_local(self) -> bytes:
        return self._codec.serialize(self._local_metadata)

    def deserialize(self, blob: bytes) -> Any:
        return self._codec.deserialize(blob)

    async def _send_quietly(self, address: str, message: Message) -> None:
        try:
            await self._transport.send(address, message)
        except Exception as exc:  # noqa: BLE001
            _log.debug("[%s] failed to send metadata resp to %s: %s", self._local, address, exc)
