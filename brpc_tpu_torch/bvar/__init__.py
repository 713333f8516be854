"""bvar: named, exposable metrics.

The subset of ``brpc_tpu/bvar`` the port's batcher, supervisor,
tensorframe and fault sites use: the registry (``Variable``,
``find_exposed``, ``exposed_variables``), ``Adder`` and
``PassiveStatus``, ``Window`` and ``PerSecond``, ``IntRecorder`` and
the native ``LatencyRecorder`` (on the port's own core).
"""
from .variable import Variable, exposed_variables, find_exposed  # noqa: F401
from .reducer import Adder, PassiveStatus  # noqa: F401
from .window import PerSecond, Window  # noqa: F401
from .recorder import IntRecorder, LatencyRecorder  # noqa: F401
