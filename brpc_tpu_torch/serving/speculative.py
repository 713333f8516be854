"""Draft proposers for speculative decoding.

Port of ``brpc_tpu/serving/speculative.py``.  The engine's speculative
mode is propose -> verify -> commit: something cheap PROPOSES the next
tokens, the target model verifies the whole proposal in one paged
attention call per layer, and the longest greedy-matching prefix
commits -- the output is the plain greedy decode's, token for token;
only the cost per emitted token changes.  This module is the "something
cheap":

  :class:`DraftProposer`       the contract: ``propose(tokens, k)``
                               returns a list of BRANCHES, each a token
                               chain continuing the context, in order of
                               priority, at most ``k`` tokens in all.
                               One branch is a chain; several are a
                               draft tree.
  :class:`NGramProposer`       prompt-lookup decoding: the tokens that
                               followed the most recent earlier
                               occurrence of the context's longest
                               suffix n-gram.  Host work only.
  :class:`DraftModelProposer`  a draft model: greedy chains through the
                               dense forward of ``models/runner.py`` on
                               the parameters' device (and so through
                               the flash-attention kernel on a card),
                               one host read per proposed token.
                               ``width > 1`` branches from the top-w
                               first tokens.

``as_proposer`` adapts the engine's ``draft_runner=`` argument.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["DraftProposer", "NGramProposer", "DraftModelProposer",
           "as_proposer", "top_tokens"]


class DraftProposer:
    """The proposer contract (see the module docstring)."""

    name = "draft"

    def propose(self, tokens: Sequence[int], k: int) -> list[list[int]]:
        """Up to ``k`` draft tokens continuing ``tokens``, as a list of
        branches; empty when there is no basis for a guess (the engine
        then runs a plain step)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class NGramProposer(DraftProposer):
    """Prompt-lookup drafts over the last ``window`` tokens: the
    continuation of the most recent earlier occurrence of the longest
    suffix n-gram (n down to 1).  ``width > 1`` proposes one branch per
    DISTINCT first token over the most recent matches."""

    def __init__(self, n: int = 3, width: int = 1, window: int = 256,
                 name: str = "ngram"):
        if n < 1 or width < 1 or window < 2:
            raise ValueError("n, width and window must be sane")
        self.n = int(n)
        self.width = int(width)
        # a bounded lookback keeps the scan, which runs on the engine's
        # step-loop thread every iteration, independent of the context
        # length
        self.window = int(window)
        self.name = name

    @staticmethod
    def _matches(toks: list, g: int) -> list[int]:
        """End positions (exclusive) of earlier occurrences of the
        length-``g`` suffix, most recent first."""
        suf = toks[-g:]
        return [j + g for j in range(len(toks) - g - 1, -1, -1)
                if toks[j:j + g] == suf]

    def propose(self, tokens: Sequence[int], k: int) -> list[list[int]]:
        toks = [int(t) for t in tokens[-self.window:]]
        if k < 1 or len(toks) < 2:
            return []
        for g in range(min(self.n, len(toks) - 1), 0, -1):
            ends = self._matches(toks, g)
            if not ends:
                continue
            per = max(1, k // self.width)
            branches: list[list[int]] = []
            seen_first = set()
            budget = k
            for e in ends:
                if len(branches) >= self.width or budget <= 0:
                    break
                want = min(per, budget)
                cont = toks[e:e + want]
                if not cont or cont[0] in seen_first:
                    continue
                if len(cont) < want:
                    # the most recent occurrence sits too close to the
                    # end for a full chain: take an earlier occurrence of
                    # the same continuation with more road ahead
                    for e2 in ends:
                        c2 = toks[e2:e2 + want]
                        if c2 and c2[0] == cont[0] and len(c2) > len(cont):
                            cont = c2
                            if len(cont) >= want:
                                break
                seen_first.add(cont[0])
                branches.append(cont)
                budget -= len(cont)
            if branches:
                return branches
        return []


def top_tokens(logits: torch.Tensor, width: int) -> list[int]:
    """The ``width`` largest entries of a 1-D ``logits``, in the
    reference's order (``argsort(logits)[::-1][:width]``): descending
    value, and on a tie the LARGER index first.  A stable ascending sort
    keeps tied indices ascending, so its reverse puts them descending;
    ``torch.topk`` promises no order among ties."""
    order = torch.sort(logits, stable=True).indices
    return [int(i) for i in order[-width:].flip(0).tolist()]


class DraftModelProposer(DraftProposer):
    """A draft model as the proposer: greedy chains through the dense
    forward on the parameters' device.  ``width > 1`` branches on the
    top-w first tokens, each extended greedily (the draft-tree shape)."""

    def __init__(self, params: dict, cfg, *, width: int = 1,
                 name: str = "draft-model"):
        if width < 1:
            raise ValueError("width must be >= 1")
        self.params = params
        self.cfg = cfg
        self.width = int(width)
        self.name = name
        self.device = params["emb"].device

    def _next_logits(self, toks: list) -> torch.Tensor:
        from ..models.runner import dense_forward
        t = torch.tensor([toks], dtype=torch.int64, device=self.device)
        p = torch.arange(len(toks), dtype=torch.int32,
                         device=self.device)[None]
        return dense_forward(self.params, self.cfg, t, p)[0, -1]

    def _argmax(self, toks: list) -> int:
        return int(torch.argmax(self._next_logits(toks)))

    def propose(self, tokens: Sequence[int], k: int) -> list[list[int]]:
        toks = [int(t) for t in tokens]
        if k < 1 or not toks:
            return []
        width = min(self.width, k)
        if width == 1:
            firsts = [self._argmax(toks)]
        else:
            firsts = top_tokens(self._next_logits(toks), width)
        per = max(1, k // len(firsts))
        branches = []
        budget = k
        for t0 in firsts:
            if budget <= 0:
                break
            b = [t0]
            cur = toks + [t0]
            while len(b) < min(per, budget):
                nxt = self._argmax(cur)
                b.append(nxt)
                cur.append(nxt)
            branches.append(b)
            budget -= len(b)
        return branches


def as_proposer(draft) -> Optional[DraftProposer]:
    """Adapt the engine's ``draft_runner=`` argument: None and proposers
    pass through, a model runner carrying ``params``/``cfg``
    (TransformerRunner) wraps as a :class:`DraftModelProposer`."""
    if draft is None:
        return None
    if hasattr(draft, "propose"):
        return draft
    params = getattr(draft, "params", None)
    cfg = getattr(draft, "cfg", None)
    if params is not None and cfg is not None:
        return DraftModelProposer(
            params, cfg, name=f"draft:{getattr(draft, 'name', 'model')}")
    raise ValueError(
        f"draft_runner must be a DraftProposer or a model runner with "
        f"params/cfg, got {type(draft).__name__}")
