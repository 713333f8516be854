"""The port's TRPC front: a trimmed copy of ``brpc_tpu/rpc`` on the same
wire (server, single-server channel, controller, services, byte
streams), over the port's own native core (``brpc_tpu_torch/_core``).
Importing it builds and loads nothing; the core is built at the first
server or channel that needs it."""
from .channel import Channel, ChannelOptions  # noqa: F401
from .controller import Controller  # noqa: F401
from .server import MethodStatus, Server, ServerOptions  # noqa: F401
from .service import Service, method  # noqa: F401
from .stream import (Stream, StreamHandler, stream_accept,  # noqa: F401
                     stream_create)
