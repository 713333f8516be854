"""Serving: the continuous-batching decode engine and its draft
proposers for speculative decoding."""
from .engine import DecodeEngine  # noqa: F401
from .speculative import (DraftModelProposer, DraftProposer,  # noqa: F401
                          NGramProposer, as_proposer)
