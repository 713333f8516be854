"""Dense attention: plain local attention and the flash kernel.

Port of the single-device half of ``brpc_tpu/ops/attention.py``
(``ring_attention`` and ``ulysses_attention`` are collectives and come
with the mesh).  Shapes are the reference's ``[B, S, H, D]``; K/V may
carry fewer heads than Q (GQA/MQA), query head h reading K/V head
h // (H/Hkv).

:func:`flash_attention` runs the CUDA kernel ``csrc/flash_attention.cu``
when ``q`` lies on a CUDA device (f32 or bf16, any S, causal or not,
head dims that are multiples of 8 up to 256) and
:func:`flash_attention_plain` when it lies on the CPU.  There is no
other branch: the TPU wrapper's fallback to ``local_attention`` for an
S that does not divide its tiles has no counterpart, because the kernel
masks its ragged last tile itself.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..device import sm_count
from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "local_attention"]

_NEG_INF = float("-inf")


def _expand_kv(q, k, v):
    """Repeat each K/V head across its query-head group (GQA/MQA)."""
    h_q, h_kv = q.shape[2], k.shape[2]
    if h_kv == h_q:
        return k, v
    if h_q % h_kv:
        raise ValueError(
            f"n_heads ({h_q}) must be a multiple of n_kv_heads ({h_kv})")
    g = h_q // h_kv
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def _softmax_rows(s):
    """-inf-safe softmax over the last axis: all-masked rows give 0."""
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.where(l == 0.0, torch.ones_like(l), l)


def local_attention(q, k, v, causal: bool = False, q_offset: int = 0,
                    kv_offset: int = 0):
    """Plain softmax(QK^T/sqrt(d))V.  The offsets give the global
    positions of the q and k/v blocks for causal masking; rows whose
    mask hides every key give zeros (not NaN)."""
    k, v = _expand_kv(q, k, v)
    sq, sk, d = q.shape[1], k.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(d))
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = kv_offset + torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, _NEG_INF)
    p = _softmax_rows(s)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def flash_attention_plain(q, k, v, causal: bool = False):
    """The kernel's plain version: :func:`local_attention` computed in
    f32, returned in the input's dtype."""
    return local_attention(q.float(), k.float(), v.float(),
                           causal=causal).to(q.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [
            i32, p, p, p, p, p, i32, i32, i32, i32, i32, i32,
            ctypes.c_float, i32, p]
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def m_tiles_for(b: int, h: int, s: int, d: int, sms: int) -> int:
    """16-row m-tiles per warp: two (128-row blocks) halve the K/V reads
    per flop, and are taken where they still give about two blocks per
    SM and their accumulators fit the registers (head dim <= 128)."""
    return 2 if d <= 128 and b * h * -(-s // 128) >= 2 * sms else 1


def _flash_kernel(q, k, v, causal: bool, m_tiles=None):
    """Launch ``csrc/flash_attention.cu`` on the current stream.
    ``m_tiles``: 16-row m-tiles per warp, :func:`m_tiles_for` unless
    given (the tests run both).  Raises on any input the kernel does not take and on
    a launch error."""
    dev = q.device
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the flash kernel takes float32 or bfloat16 q/k/v "
                        "of one dtype")
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must share one CUDA device")
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if h % hkv:
        raise ValueError(
            f"n_heads ({h}) must be a multiple of n_kv_heads ({hkv})")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the flash kernel needs the head dim contiguous")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"the flash kernel takes head dims that are "
                         f"multiples of 8 up to {MAX_HEAD_DIM}, not {d}")
    # every row start feeds 16-byte cp.async copies
    if any(x.data_ptr() % 16 or any(st * x.element_size() % 16
                                    for st in x.stride()[:3])
           for x in (q, k, v)):
        raise ValueError("the flash kernel needs 16-byte aligned q/k/v "
                         "rows")
    lib = _kernel_lib()
    if m_tiles is None:
        m_tiles = m_tiles_for(b, h, s, d, sm_count(dev.index))
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), strides, b, s, h, hkv, d, int(causal),
            1.0 / math.sqrt(d), m_tiles, stream)
    if rc:
        raise RuntimeError("flash-attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    flash_attention.launches += 1
    return o


def flash_attention(q, k, v, causal: bool = False):
    """Exact attention ``[B, S, H, D] -> [B, S, H, D]`` in the input's
    dtype.  ``q`` on a CUDA device runs the kernel; on the CPU, its
    plain version.  ``flash_attention.launches`` counts kernel
    launches."""
    if q.is_cuda:
        return _flash_kernel(q, k, v, causal)
    return flash_attention_plain(q, k, v, causal)


flash_attention.launches = 0
