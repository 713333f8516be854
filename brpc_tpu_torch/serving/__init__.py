"""Serving: the continuous-batching decode engine, its draft proposers
for speculative decoding, and the ``Serving`` RPC service in front of
them."""
from .engine import DecodeEngine  # noqa: F401
from .service import ServingService, register_serving  # noqa: F401
from .speculative import (DraftModelProposer, DraftProposer,  # noqa: F401
                          NGramProposer, as_proposer)
