from . import codecs, local, native_codec, tcp, websocket  # register factories/codecs (ServiceLoader analogue)
from .api import (
    Listeners,
    PeerUnavailableError,
    Transport,
    TransportError,
    TransportEvent,
    bind_transport,
    create_transport,
    register_transport_factory,
    transport_factories,
)
from .emulator import (
    NetworkEmulator,
    NetworkEmulatorError,
    NetworkEmulatorTransport,
)
from .local import MemoryTransport, MemoryTransportRegistry
from .tcp import TcpTransport
from .websocket import WebsocketTransport

__all__ = [
    "Transport",
    "TransportError",
    "TransportEvent",
    "PeerUnavailableError",
    "Listeners",
    "bind_transport",
    "create_transport",
    "register_transport_factory",
    "transport_factories",
    "NetworkEmulator",
    "NetworkEmulatorError",
    "NetworkEmulatorTransport",
    "MemoryTransport",
    "MemoryTransportRegistry",
    "TcpTransport",
    "WebsocketTransport",
    "codecs",
]
