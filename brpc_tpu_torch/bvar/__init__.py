"""bvar: named, exposable metrics.

The subset of ``brpc_tpu/bvar`` the port uses: the registry
(``Variable``, ``find_exposed``, ``exposed_variables``,
``dump_exposed``), ``Adder`` and ``PassiveStatus``, ``Window`` and
``PerSecond``, ``IntRecorder`` and the native ``LatencyRecorder`` (on
the port's own core); ``collector.py`` (the speed-limited sample
collector rpcz rides) and ``default_variables.py`` (process cpu, rss,
fds) are imported by their users.
"""
from .variable import (Variable, dump_exposed,  # noqa: F401
                       exposed_variables, find_exposed)
from .reducer import Adder, PassiveStatus  # noqa: F401
from .window import PerSecond, Window  # noqa: F401
from .recorder import IntRecorder, LatencyRecorder  # noqa: F401
