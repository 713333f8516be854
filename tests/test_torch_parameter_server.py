"""The port's parameter-server model held against the JAX package's.

Parameters are drawn once by ``brpc_tpu.models.parameter_server
.init_params`` and carried into the port by ``params_from_jax``; tokens
and targets are seeded numpy, fed to both packages.  Tolerances: f32
forward logits atol 1e-5; bf16 forward logits atol 2e-2 (two frameworks'
bf16 matmuls round their f32 sums to bf16 at different points; the
logits are O(0.1)); loss 1e-5 at f32 and 1e-3 at bf16; f32 grads atol
1e-6; one bf16 train step's parameters atol 1e-5 (the step at lr 0.5
moves them by up to 1.1e-3, and bf16 grads differ in their last bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import parameter_server as R
from brpc_tpu_torch.models import parameter_server as T

CPU = "cpu"
JCFG = R.PSConfig(vocab=256, d_model=32, d_ff=64, n_layers=2, seq=16,
                  batch=4)
TCFG = T.PSConfig(vocab=256, d_model=32, d_ff=64, n_layers=2, seq=16,
                  batch=4)
JPARAMS = {k: np.asarray(v) for k, v in
           R.init_params(JCFG, key=jax.random.PRNGKey(0)).items()}
_rng = np.random.default_rng(11)
TOKENS = _rng.integers(0, JCFG.vocab, (JCFG.batch, JCFG.seq)).astype(np.int32)
TARGETS = _rng.integers(0, JCFG.vocab, (JCFG.batch, JCFG.seq)).astype(np.int32)


def _tparams():
    return T.params_from_jax(JPARAMS, device=CPU)


def _tt(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def test_params_from_jax_keeps_names_layout_and_values():
    tp = _tparams()
    assert set(tp) == set(T.PARAM_NAMES) == set(JPARAMS)
    for name, v in JPARAMS.items():
        assert tp[name].dtype == torch.float32
        np.testing.assert_array_equal(tp[name].numpy(), v)
    with pytest.raises(ValueError):
        T.params_from_jax({"embed": JPARAMS["embed"]}, device=CPU)


def test_init_params_and_batches_are_seeded_and_shaped():
    a = T.init_params(TCFG, 3, device=CPU)
    b = T.init_params(TCFG, 3, device=CPU)
    c = T.init_params(TCFG, 4, device=CPU)
    for name, v in a.items():
        assert tuple(v.shape) == JPARAMS[name].shape
        assert v.dtype == torch.float32
        assert torch.equal(v, b[name]) and not torch.equal(v, c[name])
    tok, tgt = T.make_example_batch(TCFG, seed=1, device=CPU)
    tok2, _ = T.make_example_batch(TCFG, seed=1, device=CPU)
    assert tok.shape == tgt.shape == (TCFG.batch, TCFG.seq)
    assert torch.equal(tok, tok2)
    assert int(tok.min()) >= 0 and int(tok.max()) < TCFG.vocab


@pytest.mark.parametrize("entry", ["init_params", "params_from_jax",
                                   "make_example_batch"])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = getattr(T, entry)
    arg = JPARAMS if entry == "params_from_jax" else TCFG
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(arg)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_forward_step_matches_jax(dtype, atol):
    want = np.asarray(R.forward_step(
        JPARAMS, jnp.asarray(TOKENS), compute_dtype=getattr(jnp, dtype)
    ).astype(jnp.float32))
    got = T.forward_step(_tparams(), _tt(TOKENS),
                         compute_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (JCFG.batch, JCFG.seq, JCFG.vocab)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=atol)


def test_loss_fn_matches_jax():
    want = float(R.loss_fn(JPARAMS, jnp.asarray(TOKENS),
                           jnp.asarray(TARGETS)))
    got = float(T.loss_fn(_tparams(), _tt(TOKENS), _tt(TARGETS)))
    assert abs(got - want) <= 1e-3, (got, want)
    got32 = float(T.loss_fn(_tparams(), _tt(TOKENS), _tt(TARGETS),
                            compute_dtype=torch.float32))
    assert abs(got32 - want) <= 1e-2
    # near log(vocab) for a 0.02-scale random model
    assert abs(got - np.log(JCFG.vocab)) < 0.5


def test_train_step_matches_jax():
    jnew, jloss = jax.jit(R.train_step, static_argnames="lr")(
        JPARAMS, jnp.asarray(TOKENS), jnp.asarray(TARGETS), lr=0.5)
    tp = _tparams()
    before = {k: v.clone() for k, v in tp.items()}
    tnew, tloss = T.train_step(tp, _tt(TOKENS), _tt(TARGETS), lr=0.5)
    assert abs(float(tloss) - float(jloss)) <= 1e-3
    for name in T.PARAM_NAMES:
        assert torch.equal(tp[name], before[name]), "params mutated"
        np.testing.assert_allclose(tnew[name].numpy(),
                                   np.asarray(jnew[name]), rtol=0,
                                   atol=1e-5, err_msg=name)
        # the step moved every parameter
        assert not torch.equal(tnew[name], before[name]), name


def test_f32_grads_match_jax():
    def jloss(p):
        logits = R.forward_step(p, jnp.asarray(TOKENS),
                                compute_dtype=jnp.float32)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(TARGETS)[..., None], axis=-1))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(JPARAMS)
    tl, tg = T.loss_and_grads(_tparams(), _tt(TOKENS), _tt(TARGETS),
                              compute_dtype=torch.float32)
    assert abs(float(tl) - float(jl)) <= 1e-5
    for name in T.PARAM_NAMES:
        np.testing.assert_allclose(tg[name].numpy(), np.asarray(jg[name]),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_loss_falls_over_train_steps():
    p = _tparams()
    tok, tgt = _tt(TOKENS), _tt(TARGETS)
    losses = []
    for _ in range(4):
        p, loss = T.train_step(p, tok, tgt, lr=0.5)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
