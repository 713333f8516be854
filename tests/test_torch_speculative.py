"""The port's speculative DecodeEngine and draft proposers held against
the JAX package.

Identity is the bar: a speculative engine streams exactly the plain
greedy decode's tokens -- the port's ``dense_generate`` over parameters
carried from the JAX package by ``params_from_jax`` -- at every draft
depth, cold and warm, for chain drafts, draft trees and side-branch
adoption, and those streams are the JAX package's greedy tokens: one
teacher-forced ``brpc_tpu.models.runner.dense_forward`` per prompt (the
Pallas flash kernel in interpret mode, as the JAX package's tests run
it) must pick every streamed token.  Around it: the per-request opt-out,
the eos and budget clamps, a crashing verify (EINTERNAL, no page left
behind), the constructor's checks, and both proposers against the
reference's on the same contexts.  Everything runs on ``device="cpu"``.
"""
import functools
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.serving import speculative as ref_spec
from brpc_tpu_torch import errors
from brpc_tpu_torch.models import runner as T
from brpc_tpu_torch.ops.paged_attention import MAX_LOCAL_WIDTH
from brpc_tpu_torch.serving import (DecodeEngine, DraftModelProposer,
                                    DraftProposer, NGramProposer,
                                    as_proposer)
from brpc_tpu_torch.serving.speculative import top_tokens

from test_torch_runner import (JCFG, JPARAMS, PROMPTS, TCFG, _tparams,
                               jax_dense_forward)

CPU = "cpu"
NEW = 12
DEPTHS = (2, 4, 8)
PARAMS = _tparams()


@functools.cache
def oracle(prompt: tuple) -> list:
    return T.dense_generate(PARAMS, TCFG, list(prompt), NEW, device=CPU)


@functools.cache
def _jax_greedy(seq: tuple) -> list:
    """The JAX package's greedy token after every position of `seq`."""
    logits = jax_dense_forward(JPARAMS, JCFG, jnp.asarray([seq], jnp.int32),
                               jnp.arange(len(seq), dtype=jnp.int32)[None])
    return np.asarray(jnp.argmax(logits[0], axis=-1)).tolist()


def assert_jax_greedy(prompt, stream):
    """Teacher-forced over prompt + stream[:-1], the JAX package picks
    every token of `stream`."""
    pred = _jax_greedy(tuple(prompt) + tuple(stream[:-1]))
    assert pred[len(prompt) - 1:] == list(stream)


class _Spec:
    """A speculative engine over the port runner on the CPU."""

    def __init__(self, name, proposer, depth=4, *, eos_token=None,
                 runner_cls=T.TransformerRunner):
        self.store = T.make_store_for(TCFG, page_tokens=4, max_blocks=16,
                                      device=CPU, name=name)
        self.runner = runner_cls(PARAMS, TCFG, store=self.store, device=CPU)
        self.engine = DecodeEngine(
            runner=self.runner, store=self.store, num_slots=2,
            max_pages_per_slot=24, prefill_buckets=(8, 16),
            eos_token=eos_token, draft_runner=proposer, draft_len=depth,
            device=CPU, name=name)

    def submit(self, prompt, n=NEW, **kw):
        rec = {"toks": [], "errs": [], "ev": threading.Event()}
        self.engine.submit(prompt, n, rec["toks"].append,
                           lambda e: (rec["errs"].append(e), rec["ev"].set()),
                           **kw)
        return rec

    def run(self, prompts, n=NEW, **kw):
        recs = [self.submit(p, n, **kw) for p in prompts]
        return [_ok(r) for r in recs]

    def spec(self):
        return self.engine.stats()["speculative"]

    def close(self):
        """Close; no live sequence and no leased page may remain."""
        self.engine.close()
        assert self.store.stats()["live_seqs"] == 0
        self.store.clear()
        assert self.store.pagepool.blocks_leased() == 0, \
            "pool not back at baseline"


def _done(rec, timeout=60):
    assert rec["ev"].wait(timeout), "generation hung"
    return rec


def _ok(rec):
    _done(rec)
    assert rec["errs"] == [None], rec["errs"]
    return rec["toks"]


class _Oracle(DraftProposer):
    """Scripted drafts from the oracle streams of known prompts; records
    every context it is asked about.  ``side=True``: branch 0 is a wrong
    token and branch 1 the oracle's continuation."""

    def __init__(self, prompts, side=False):
        self.known = {tuple(p): oracle(tuple(p)) for p in prompts}
        self.side = side
        self.calls = []

    def propose(self, tokens, k):
        self.calls.append(list(tokens))
        for p, want in self.known.items():
            if tuple(tokens[:len(p)]) == p:
                done = len(tokens) - len(p)
                if not self.side:
                    return [want[done:done + k]]
                cont = want[done:done + k - 1]
                return [[(cont[0] + 1) % TCFG.vocab], cont] if cont else []
        return []


# ---- identity --------------------------------------------------------------

@pytest.mark.parametrize("depth", DEPTHS)
def test_ngram_streams_equal_oracle_and_jax_greedy(depth):
    """Chain drafts (prompt lookup) at each depth: cold and warm streams
    equal the oracle, the warm pass hits the cached prefix, and the JAX
    package's teacher-forced greedy tokens are the same streams."""
    srv = _Spec(f"t_torch_spec_id{depth}", NGramProposer(), depth)
    want = [oracle(tuple(p)) for p in PROMPTS]
    try:
        assert srv.run(PROMPTS) == want
        hit0 = srv.store.hit_tokens
        assert srv.run(PROMPTS) == want
        assert srv.store.hit_tokens > hit0, "warm pass hit no prefix"
        sp = srv.spec()
        assert sp["verify_calls"] > 0 and sp["spec_accepted"] > 0
    finally:
        srv.close()
    for p, w in zip(PROMPTS, want):
        assert_jax_greedy(p, w)


def test_draft_tree_streams_equal_oracle():
    """A width-2 draft model (the target's own weights) proposes two
    branches per slot: the side branch rides a fork, the streams still
    equal the oracle, and nearly every draft is accepted."""
    srv = _Spec("t_torch_spec_tree", DraftModelProposer(PARAMS, TCFG,
                                                        width=2), 4)
    try:
        assert srv.run(PROMPTS) == [oracle(tuple(p)) for p in PROMPTS]
        assert srv.store.stats()["forks"] > 0
        sp = srv.spec()
        assert sp["spec_accepted"] > 0 and sp["tokens_per_verify"] > 1
    finally:
        srv.close()


def test_side_branch_adoption():
    """Branch 0 is always wrong, branch 1 the oracle's continuation:
    every accepted draft comes from a fork the slot adopts, the streams
    equal the oracle and no draft page leaks."""
    prop = _Oracle(PROMPTS, side=True)
    srv = _Spec("t_torch_spec_side", prop, 4)
    try:
        assert srv.run(PROMPTS) == [oracle(tuple(p)) for p in PROMPTS]
        assert srv.store.stats()["forks"] > 0
        assert srv.spec()["spec_accepted"] > 0
    finally:
        srv.close()


def test_opted_out_slot_is_never_proposed_for():
    prop = _Oracle(PROMPTS)
    srv = _Spec("t_torch_spec_mixed", prop, 4)
    try:
        out = srv.submit(PROMPTS[0], speculative=False)
        spec = srv.submit(PROMPTS[1])
        assert [_ok(out), _ok(spec)] == [oracle(tuple(p)) for p in PROMPTS]
        assert prop.calls, "the speculative slot was never proposed for"
        assert not any(c[:len(PROMPTS[0])] == list(PROMPTS[0])
                       for c in prop.calls)
    finally:
        srv.close()


# ---- clamps, failures, construction -----------------------------------------

def test_eos_clamps_mid_burst_and_one_token_budget_proposes_nothing():
    want = oracle(tuple(PROMPTS[0]))
    k = next(i for i in range(1, NEW) if want[i] not in want[:i])
    prop = _Oracle(PROMPTS)
    srv = _Spec("t_torch_spec_eos", prop, 4, eos_token=want[k])
    try:
        # the first verify accepts 4 drafts + a bonus; eos cuts the burst
        assert srv.run([PROMPTS[0]]) == [want[:k + 1]]
        assert srv.spec()["verify_calls"] == 1
        prop.calls.clear()
        assert srv.run([PROMPTS[0]], n=1) == [want[:1]]
        assert prop.calls == []
    finally:
        srv.close()


class _CrashOnSecondVerify(T.TransformerRunner):
    verify_calls = 0

    def verify(self, *args):
        self.verify_calls += 1
        if self.verify_calls == 2:
            raise RuntimeError("injected verify crash")
        return super().verify(*args)


def test_crashing_verify_fails_in_flight_with_einternal_and_leaks_nothing():
    srv = _Spec("t_torch_spec_crash", _Oracle(PROMPTS), 2,
                runner_cls=_CrashOnSecondVerify)
    try:
        recs = [srv.submit(p) for p in PROMPTS]
        for rec in recs:
            assert [e.code for e in _done(rec)["errs"]] == [errors.EINTERNAL]
        assert srv.engine.join_idle(10)
        assert srv.store.stats()["live_seqs"] == 0
    finally:
        srv.close()


def test_constructor_checks():
    store = T.make_store_for(TCFG, page_tokens=4, device=CPU,
                             name="t_torch_spec_ctor")
    runner = T.TransformerRunner(PARAMS, TCFG, store=store, device=CPU)
    ngram = NGramProposer()
    with pytest.raises(ValueError):
        DecodeEngine(runner=runner, store=None, draft_runner=ngram,
                     device=CPU)
    with pytest.raises(ValueError):
        DecodeEngine(runner=runner, store=store, draft_runner=ngram,
                     draft_len=0, device=CPU)
    with pytest.raises(ValueError, match="local block"):
        DecodeEngine(runner=runner, store=store, draft_runner=ngram,
                     draft_len=MAX_LOCAL_WIDTH, device=CPU)
    DecodeEngine(runner=runner, store=store, draft_runner=ngram,
                 draft_len=MAX_LOCAL_WIDTH - 1, device=CPU).close()
    with pytest.raises(ValueError):
        as_proposer(object())
    assert as_proposer(None) is None and as_proposer(ngram) is ngram
    assert isinstance(as_proposer(runner), DraftModelProposer)


# ---- the proposers against the reference's ----------------------------------

@pytest.mark.parametrize("width", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram_proposer_matches_reference(n, width):
    """Seeded random contexts over a small alphabet (many matches, many
    too-short continuations), k from 1 to 8: identical branches."""
    rng = np.random.default_rng(10 * n + width)
    port = NGramProposer(n=n, width=width, window=32)
    ref = ref_spec.NGramProposer(n=n, width=width, window=32)
    for _ in range(25):
        ctx = rng.integers(0, 6, int(rng.integers(1, 60))).tolist()
        for k in (0, 1, 3, 4, 8):
            assert port.propose(ctx, k) == ref.propose(ctx, k), (ctx, k)


def test_draft_model_proposer_matches_reference():
    ctx = list(PROMPTS[0]) + oracle(tuple(PROMPTS[0]))[:10]
    port = DraftModelProposer(PARAMS, TCFG, width=2).propose(ctx, 4)
    ref = ref_spec.DraftModelProposer(JPARAMS, JCFG, width=2).propose(ctx, 4)
    assert port == ref
    assert len(port) == 2 and port[0][0] != port[1][0]


def test_width_order_breaks_ties_as_the_reference():
    """Descending value, the larger index first on a tie -- the order of
    the reference's ``argsort(logits)[::-1]`` -- in ``top_tokens`` and
    through both proposers' first tokens."""
    logits = np.array([0.5, 2.0, 1.0, 2.0, -1.0, 1.0, 2.0], np.float32)
    for width in range(1, len(logits) + 1):
        assert top_tokens(torch.from_numpy(logits), width) == [
            int(i) for i in jnp.argsort(jnp.asarray(logits))[::-1][:width]]
    assert top_tokens(torch.from_numpy(logits), 4) == [6, 3, 1, 5]
    port = DraftModelProposer(PARAMS, TCFG, width=3)
    ref = ref_spec.DraftModelProposer(JPARAMS, JCFG, width=3)
    port._next_logits = lambda toks: torch.from_numpy(logits)
    ref._next_logits = lambda toks: jnp.asarray(logits)
    assert port.propose([1, 2], 3) == ref.propose([1, 2], 3) \
        == [[6], [3], [1]]
