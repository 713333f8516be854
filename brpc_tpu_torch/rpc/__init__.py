"""The port's TRPC front: a copy of ``brpc_tpu/rpc`` on the same wire
(server, channels to one server or to a cluster, combo channels,
controller, services, byte streams) and its HTTP face (the HTTP client
channel, progressive responses), over the port's own native core
(``brpc_tpu_torch/_core``).  Importing it builds and loads nothing; the
core is built at the first server or channel that needs it."""
from .channel import Channel, ChannelOptions, RetryPolicy  # noqa: F401
from .combo_channels import (CallMapper, DynamicPartitionChannel,  # noqa: F401
                             ParallelChannel, PartitionChannel,
                             PartitionParser, ResponseMerger,
                             SelectiveChannel, SubCall, SumMerger)
from .controller import Controller  # noqa: F401
from .http import HttpChannel  # noqa: F401
from .progressive import ProgressiveResponse  # noqa: F401
from .server import MethodStatus, Server, ServerOptions  # noqa: F401
from .service import Service, method  # noqa: F401
from .stream import (Stream, StreamHandler, stream_accept,  # noqa: F401
                     stream_create)
