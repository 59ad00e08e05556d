"""The host layer's transports: the plugin boundary (``base``), the payload
framing (``codec``), the in-process ``local`` world and the TCP ``socket``
transport."""

from .base import ANY_SOURCE, ANY_TAG, Mailbox, RecvTimeout, Transport, TransportError
from .local import LocalTransport, LocalWorld, run_local
from .socket import SocketTransport

__all__ = ["ANY_SOURCE", "ANY_TAG", "LocalTransport", "LocalWorld", "Mailbox",
           "RecvTimeout", "SocketTransport", "Transport", "TransportError",
           "run_local"]
