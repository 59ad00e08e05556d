"""The host layer's transports: the plugin boundary (``base``), the payload
framing (``codec``), the in-process ``local`` world, the TCP ``socket``
transport and the fault-injecting wrapper (``faulty``)."""

from .base import ANY_SOURCE, ANY_TAG, Mailbox, RecvTimeout, Transport, TransportError
from .faulty import FaultyTransport, KilledRankError
from .local import KILLED, LocalTransport, LocalWorld, run_local
from .socket import SocketTransport

__all__ = ["ANY_SOURCE", "ANY_TAG", "FaultyTransport", "KILLED", "KilledRankError",
           "LocalTransport", "LocalWorld", "Mailbox",
           "RecvTimeout", "SocketTransport", "Transport", "TransportError",
           "run_local"]
