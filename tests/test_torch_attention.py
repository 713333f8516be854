"""The port's dense attention held against the JAX package's.

Seeded numpy inputs go through ``brpc_tpu.ops.attention``'s
``flash_attention`` (the Pallas kernel in interpret mode, small tiles,
as the JAX package's tests run it) and ``local_attention``, and through
``brpc_tpu_torch.ops.attention``'s ``flash_attention`` (on the CPU: its
plain version) and ``local_attention``.  Tolerance: f32 atol 1e-5;
bf16 inputs 2e-2 against the f32 reference (bf16 keeps ~3 digits).
The CUDA kernel runs only on a card: its tests are in
``test_torch_cuda_kernels.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.ops.attention import flash_attention as jax_flash
from brpc_tpu.ops import attention as jax_attention
from brpc_tpu_torch.ops.attention import (flash_attention,
                                          flash_attention_plain,
                                          local_attention, m_tiles_for)

ATOL = 1e-5
B, S, H, D = 2, 64, 4, 16
# the JAX package's local attention, jitted: called eagerly, each of its
# ops compiles again for every case's shapes (seconds a case)
jax_local = jax.jit(jax_attention.local_attention,
                    static_argnames=("causal", "q_offset", "kv_offset"))


def _qkv(seed, s=S, h=H, hkv=H, d=D, b=B):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, s, hkv, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, s, hkv, d)) * 0.5).astype(np.float32)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@functools.cache
def _jax_flash(seed, s, hkv, causal, blk_q, blk_k):
    q, k, v = _qkv(seed, s=s, hkv=hkv)
    return np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), blk_q=blk_q, blk_k=blk_k,
                                causal=causal, interpret=True))


# (seed, S, Hkv, causal, blk_q, blk_k): full, causal, uneven causal tiles,
# GQA, and an S that divides no tile (the JAX wrapper falls back to
# local_attention there; the port has no fallback to take)
FLASH_CASES = {
    "full": (4, 64, H, False, 16, 16),
    "causal": (6, 64, H, True, 16, 16),
    "causal_uneven": (7, 64, H, True, 16, 32),
    "gqa": (9, 64, 1, False, 32, 32),
    "gqa_causal": (10, 64, 2, True, 32, 32),
    "indivisible_causal": (8, 50, H, True, 16, 16),
}


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_plain"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_matches_jax_flash(case, fn):
    seed, s, hkv, causal, bq, bk = FLASH_CASES[case]
    q, k, v = _qkv(seed, s=s, hkv=hkv)
    f = {"flash_attention": flash_attention,
         "flash_attention_plain": flash_attention_plain}[fn]
    out = f(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(out, _jax_flash(seed, s, hkv, causal, bq, bk),
                               atol=ATOL)


@pytest.mark.parametrize("h_q,h_kv,causal", [(8, 2, True), (8, 1, False),
                                              (4, 4, True)])
def test_local_matches_jax_local(h_q, h_kv, causal):
    q, k, v = _qkv(3, s=32, h=h_q, hkv=h_kv)
    out = local_attention(*_t(q, k, v), causal=causal).numpy()
    ref = np.asarray(jax_local(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_local_offsets_mask_like_jax():
    """Causal offsets place the blocks globally; a q block entirely
    before its k block sees nothing and gives zeros, never NaN."""
    q, k, v = _qkv(12, s=16)
    for qo, ko in ((16, 0), (0, 8), (0, 16)):
        out = local_attention(*_t(q, k, v), causal=True, q_offset=qo,
                              kv_offset=ko).numpy()
        ref = np.asarray(jax_local(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   q_offset=qo, kv_offset=ko))
        assert not np.isnan(out).any()
        np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("fn", [local_attention, flash_attention])
def test_bad_head_ratio_rejected(fn):
    q, k, v = _t(*_qkv(3, s=8, h=6, hkv=4))
    with pytest.raises(ValueError):
        fn(q, k, v)


def test_flash_bf16_close_to_f32_reference():
    q, k, v = _qkv(5, s=64)
    ref = np.asarray(jax_local(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True))
    out = flash_attention(*[x.to(torch.bfloat16) for x in _t(q, k, v)],
                          causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2,
                               rtol=2e-2)


def test_cpu_tensors_never_count_as_kernel_launches():
    before = flash_attention.launches
    flash_attention(*_t(*_qkv(1, s=8)), causal=True)
    assert flash_attention.launches == before



@pytest.mark.parametrize("b,h,s,d,tiles", [
    (4, 8, 4096, 128, 2),      # the bench shape: plenty of 128-row blocks
    (1, 8, 231, 128, 1),       # the wide model's oracle: too few blocks
    (1, 4, 95, 8, 1),          # the default model's oracle
    (4, 8, 4096, 256, 1),      # two m-tiles of D=256 overflow the registers
])
def test_flash_m_tiles_follow_the_shape(b, h, s, d, tiles):
    """The kernel's rows per warp are chosen from the shape and the SM
    count alone (H100: 132 SMs)."""
    assert m_tiles_for(b, h, s, d, 132) == tiles
