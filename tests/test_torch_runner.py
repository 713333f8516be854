"""The port's TransformerRunner and dense oracle held against the JAX
package's.

Parameters are built once by ``brpc_tpu.models.runner.init_runner_params``
and carried into the port by ``params_from_jax``; both packages then run
the same seeded prompts on the CPU.  Tolerances: 1e-4 for logits and for
the K/V rows a runner writes (two frameworks, two summation orders);
exact equality for greedy tokens.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import runner as R
from brpc_tpu_torch.models import runner as T

CPU = "cpu"
JCFG = R.TransformerConfig()
TCFG = T.TransformerConfig()
JPARAMS = R.init_runner_params(JCFG)
PROMPTS = ([5, 17, 42, 9, 77, 3], [88, 12, 54, 61, 7, 30])
NEW = 3
TOL = 1e-4


def _tparams():
    return T.params_from_jax({k: np.asarray(v) for k, v in JPARAMS.items()},
                             device=CPU)


# The JAX package's dense forward, jitted.  Called eagerly it compiles
# each of its ops again for every new sequence length, seconds a length;
# jitted, one program a length.  test_dense_forward_logits_match_jax
# holds the jitted forward to the eager one.
jax_dense_forward = jax.jit(R.dense_forward,
                            static_argnames=("cfg", "use_flash"))


@functools.cache
def jax_oracle(prompt: tuple, n: int) -> list:
    """``R.dense_generate`` (greedy decode with no cache, the full
    sequence recomputed every step) over the jitted forward."""
    out = list(prompt)
    for _ in range(n):
        logits = jax_dense_forward(JPARAMS, JCFG,
                                   jnp.asarray([out], jnp.int32),
                                   jnp.arange(len(out), dtype=jnp.int32)[None])
        out.append(int(jnp.argmax(logits[0, -1])))
    return out[len(prompt):]


def test_params_from_jax_keeps_names_layout_and_values():
    tp = _tparams()
    assert set(tp) == set(T.PARAM_NAMES)
    for name, v in JPARAMS.items():
        assert tuple(tp[name].shape) == v.shape
        assert tp[name].dtype == torch.float32
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(v))


def test_init_runner_params_is_seeded():
    a = T.init_runner_params(TCFG, 3, device=CPU)
    b = T.init_runner_params(TCFG, 3, device=CPU)
    c = T.init_runner_params(TCFG, 4, device=CPU)
    for name, v in a.items():
        assert tuple(v.shape) == JPARAMS[name].shape
        assert torch.equal(v, b[name])
        assert not torch.equal(v, c[name])


@pytest.mark.parametrize("prompt", PROMPTS)
def test_dense_forward_logits_match_jax(prompt):
    s = len(prompt)
    args = (JPARAMS, JCFG, jnp.asarray([prompt], jnp.int32),
            jnp.arange(s, dtype=jnp.int32)[None])
    ref = np.asarray(R.dense_forward(*args))
    out = T.dense_forward(_tparams(), TCFG, torch.tensor([prompt]),
                          torch.arange(s, dtype=torch.int32)[None])
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL)
    # the jitted forward the oracles use is the eager one
    np.testing.assert_allclose(np.asarray(jax_dense_forward(*args)), ref,
                               atol=1e-6)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_dense_generate_tokens_equal_jax(prompt):
    assert T.dense_generate(_tparams(), TCFG, prompt, NEW, device=CPU) \
        == jax_oracle(tuple(prompt), NEW)


class _Pair:
    """One JAX runner+store and one port runner+store over the same
    parameters, driven through the same calls."""

    def __init__(self, name):
        self.js = R.make_store_for(JCFG, page_tokens=4, max_blocks=8,
                                   name=f"{name}_jax")
        self.ts = T.make_store_for(TCFG, page_tokens=4, max_blocks=8,
                                   device=CPU, name=f"{name}_port")
        self.jr = R.TransformerRunner(JPARAMS, JCFG, store=self.js)
        self.tr = T.TransformerRunner(_tparams(), TCFG, store=self.ts,
                                      device=CPU)
        self.seqs = []

    def admit_and_prefill(self, prompt):
        js, ts = self.js.admit(prompt), self.ts.admit(prompt)
        R.run_prefill(self.jr, js, prompt, buckets=(8, 16), max_pages=8)
        T.run_prefill(self.tr, ts, prompt, buckets=(8, 16), max_pages=8)
        self.seqs.append((js, ts))
        return js, ts

    def kv_floats(self, store, seq, n):
        """The first n positions' packed K/V of seq, as f32 rows."""
        raw = np.concatenate([np.asarray(store.pagepool.read_raw(p))
                              for p in seq.pages])
        return raw.view(np.float32).reshape(-1, TCFG.kv_bytes_per_token
                                            // 4)[:n]

    def tables(self, store, which):
        t = np.full((len(self.seqs), 8), -1, np.int32)
        for i, pair in enumerate(self.seqs):
            ids = pair[which].page_ids()
            t[i, :len(ids)] = ids
        return t

    def close(self):
        for js, ts in self.seqs:
            self.js.retire(js, cache=False)
            self.ts.retire(ts, cache=False)
        self.js.clear()
        self.js.close()
        self.ts.clear()
        assert self.ts.pagepool.blocks_leased() == 0


def test_prefill_then_steps_match_jax_runner():
    """Prefill writes the same K/V into the pages (1e-4); every decode
    step across two slots picks the same tokens and returns the same
    K/V rows; writing them back and extending keeps both in step."""
    pair = _Pair("t_torch_steps")
    try:
        for p in PROMPTS:
            js, ts = pair.admit_and_prefill(p)
            assert js.kv_filled == ts.kv_filled == len(p)
            np.testing.assert_allclose(pair.kv_floats(pair.ts, ts, len(p)),
                                       pair.kv_floats(pair.js, js, len(p)),
                                       atol=TOL)
        last = [p[-1] for p in PROMPTS]
        for _ in range(NEW):
            pos = np.array([len(js.tokens) for js, _ in pair.seqs],
                           np.int32)
            tok = np.array(last, np.int32)
            jn, jrows = pair.jr.step(tok, pos, pair.tables(pair.js, 0))
            tn, trows = pair.tr.step(tok, pos, pair.tables(pair.ts, 1))
            np.testing.assert_array_equal(tn, jn)
            np.testing.assert_allclose(
                trows.numpy().view(np.float32),
                np.asarray(jrows).view(np.float32), atol=TOL)
            pair.js.write_kv_batch([(js, int(pos[i]) - 1, jrows[i:i + 1])
                                    for i, (js, _) in
                                    enumerate(pair.seqs)])
            pair.ts.write_kv_batch([(ts, int(pos[i]) - 1, trows[i:i + 1])
                                    for i, (_, ts) in
                                    enumerate(pair.seqs)])
            for i, (js, ts) in enumerate(pair.seqs):
                pair.js.extend(js, int(jn[i]))
                pair.ts.extend(ts, int(tn[i]))
            last = [int(x) for x in tn]
        got = [js.tokens[len(p):] for (js, _), p in zip(pair.seqs, PROMPTS)]
        assert got == [jax_oracle(tuple(p), NEW) for p in PROMPTS]
    finally:
        pair.close()


def test_verify_matches_jax_runner():
    """A draft tree verified in one call: per-row tokens equal, K/V rows
    within 1e-4 (slot 0: a linear chain, slot 1: two branches)."""
    pair = _Pair("t_torch_verify")
    try:
        for p in PROMPTS:
            pair.admit_and_prefill(p)
        k1 = 3
        tokens = np.array([[3, 11, 12], [30, 40, 41]], np.int32)
        base = np.array([len(p) for p in PROMPTS], np.int32)
        positions = base[:, None] + np.arange(k1, dtype=np.int32)[None]
        base_len = np.repeat(base - 1, k1).astype(np.int32)
        mask = np.zeros((2, k1, k1), bool)
        mask[0] = np.tril(np.ones((k1, k1), bool))
        mask[1, 0, 0] = mask[1, 1, [0, 1]] = mask[1, 2, [0, 2]] = True
        jt = np.repeat(pair.tables(pair.js, 0), k1, axis=0)
        tt = np.repeat(pair.tables(pair.ts, 1), k1, axis=0)
        jn, jrows = pair.jr.verify(tokens, positions, jt, base_len, mask)
        tn, trows = pair.tr.verify(tokens, positions, tt, base_len, mask)
        np.testing.assert_array_equal(tn, np.asarray(jn))
        np.testing.assert_allclose(trows.numpy().view(np.float32),
                                   np.asarray(jrows).view(np.float32),
                                   atol=TOL)
    finally:
        pair.close()


def test_score_matches_jax_runner():
    # one row of the prompts' length: the JAX flash kernel is already
    # traced at that shape by the dense tests
    padded = np.array([PROMPTS[1]], np.int32)
    ref = R.TransformerRunner(JPARAMS, JCFG).score(padded)
    tr = T.TransformerRunner(_tparams(), TCFG, device=CPU)
    np.testing.assert_array_equal(tr.score(padded), np.asarray(ref))
    offs = np.array([3], np.int32)
    np.testing.assert_array_equal(
        tr.score_with_offsets(padded, offs),
        np.asarray(R.TransformerRunner(JPARAMS, JCFG)
                   .score_with_offsets(padded, offs)))


def test_run_prefill_materializes_real_kv():
    store = T.make_store_for(TCFG, page_tokens=4, max_blocks=8, device=CPU,
                             name="t_torch_disagg")
    runner = T.TransformerRunner(_tparams(), TCFG, store=store, device=CPU)
    try:
        prompt = [61, 5, 33, 70, 8, 24, 19, 2]
        seq = store.admit(prompt)
        assert T.run_prefill(runner, seq, prompt) == len(prompt)
        assert seq.kv_filled == len(prompt)
        store.retire(seq, cache=True)
        assert store.probe(prompt + [1]) == 8
    finally:
        store.clear()


def test_runner_rejects_mismatched_store_and_device():
    tp = _tparams()
    wrong = T.make_store_for(T.TransformerConfig(n_layers=1), device=CPU,
                             name="t_torch_geom")
    with pytest.raises(ValueError):
        T.TransformerRunner(tp, TCFG, store=wrong, device=CPU)
    bad = dict(tp)
    bad["wq"] = bad["wq"][:1]
    with pytest.raises(ValueError):
        T.TransformerRunner(bad, TCFG, device=CPU)
    with pytest.raises(ValueError):
        T.params_from_jax({"emb": np.zeros((1, 1))}, device=CPU)


def test_entry_points_default_to_cuda():
    """No device -> cuda: without a card the runner, the oracle and the
    parameter constructors raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is honoured")
    tp = _tparams()
    with pytest.raises(RuntimeError):
        T.TransformerRunner(tp, TCFG)
    with pytest.raises(RuntimeError):
        T.dense_generate(tp, TCFG, [1, 2], 1)
    with pytest.raises(RuntimeError):
        T.init_runner_params(TCFG)
