"""Paged attention over the KV cache's page arena.

Port of ``brpc_tpu/ops/paged_attention.py``.  Queries attend over K/V
read through a page table straight from the arena, so prefix-shared
pages, copy-on-write forks and radix-cached chunks feed the model
without ever being gathered into per-sequence buffers.

Shapes (one query per row; decode batches rows across slots, prefill
across suffix positions):

  q        [N, H, D]        f32 queries
  k_pages  [P, T, Hkv, D]   the arena's K of one layer (a strided view:
  v_pages  [P, T, Hkv, D]   ``arena_kv_view(...)[:, :, l, 0 / 1]``)
  tables   [N, MP] int32    per-row FLAT arena page indices, -1 padded
  lengths  [N] int32        key j of row i is visible iff j < lengths[i]
                            and its page entry is >= 0
  extra_k/extra_v [N, Hkv, D]  optional self key per row (the decode
                            step's in-flight K/V, always visible)
  local_k/local_v [G, W, Hkv, D], local_mask [G, W, W]  optional local
                            key block: rows form G groups of W queries
                            (N == G*W) and row i of group g also sees
                            local key j iff local_mask[g, i, j].
                            Mutually exclusive with extra_k.

GQA: query head h reads K/V head h // (H/Hkv).  Rows with no visible
key give zeros, never NaN.

One contract, three versions:

  * :func:`paged_attention` -- the entry point.  When ``q`` lies on a
    CUDA device it runs ``csrc/paged_attention.cu``: a split kernel
    folds contiguous ranges of page entries into partial (o, m, l)
    (how many ranges: :func:`split_plan`, from static shapes only) and a
    combine kernel merges them, folds the self key and divides -- two
    launches and no other device work for a decode step.  With a local
    block the combine kernel returns the merged (o, m, l) and the block
    is folded here in plain torch.  On the CPU the paged part is
    :func:`_paged_oml_plain` and both folds run here.
  * :func:`paged_attention_split_plain` -- the CUDA path's arithmetic
    (ranges, merge, self-key fold) in plain torch, for the tests.
  * :func:`paged_attention_plain` -- an independent gather + masked
    softmax version of the whole function (the port of
    ``paged_attention_gather``), which the tests and ``chip_smoke.py``
    hold the kernels against.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..device import sm_count
from . import _build

__all__ = ["arena_kv_view", "paged_attention", "paged_attention_plain",
           "paged_attention_split_plain", "scratch_shapes", "split_plan"]

_NEG_INF = float("-inf")


def arena_kv_view(arena_u8: torch.Tensor, page_tokens: int, n_layers: int,
                  n_kv_heads: int, head_dim: int) -> torch.Tensor:
    """View a :meth:`PagePool.arena` byte tensor ``[P, page_bytes]`` as
    the packed f32 K/V layout ``[P, T, L, 2, Hkv, D]`` -- the
    token-major slot layout the runner writes.  A view, never a copy:
    the arena's page stride carries over."""
    p = arena_u8.shape[0]
    return arena_u8.view(torch.float32).view(p, page_tokens, n_layers, 2,
                                             n_kv_heads, head_dim)


def _expand_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[..., Hkv, D] -> [..., H, D], each K/V head repeated across its
    query-head group."""
    hkv = x.shape[-2]
    if hkv == n_heads:
        return x
    if n_heads % hkv:
        raise ValueError(f"n_heads ({n_heads}) must be a multiple of "
                         f"n_kv_heads ({hkv})")
    return x.repeat_interleave(n_heads // hkv, dim=-2)


def _check_local(extra_k, local_k, local_v, local_mask, n: int) -> None:
    if local_k is None:
        return
    if extra_k is not None:
        raise ValueError("extra_k and local_k are mutually exclusive")
    if local_v is None or local_mask is None:
        raise ValueError("local_k needs local_v and local_mask")
    g, w = local_mask.shape[0], local_mask.shape[1]
    if g * w != n:
        raise ValueError(f"local block groups {g}x{w} != {n} query rows")


def _key_mask(tables, lengths, t: int):
    """[N, 1, MP*T] visibility: position < length and page entry >= 0."""
    kpos = torch.arange(tables.shape[1] * t, device=tables.device)
    return ((kpos[None, :] < lengths[:, None])
            & (tables >= 0).repeat_interleave(t, dim=1))[:, None, :]


def _gather_pages(pages, tables):
    """[P, T, Hkv, D] pages through [N, MP] tables -> [N, MP*T, Hkv, D];
    -1 entries read page 0 and are masked by the caller."""
    n, mp = tables.shape
    _, t, hkv, d = pages.shape
    safe = tables.clamp(0, pages.shape[0] - 1).long()
    return pages[safe].reshape(n, mp * t, hkv, d)


# ---- the plain versions ----------------------------------------------------

def paged_attention_plain(q, k_pages, v_pages, tables, lengths,
                          extra_k=None, extra_v=None,
                          local_k=None, local_v=None, local_mask=None):
    """The whole function as one gather and one masked softmax (port of
    ``paged_attention_gather``).  Runs on any device; the reference the
    kernel path is held against."""
    n, h, d = q.shape
    _check_local(extra_k, local_k, local_v, local_mask, n)
    scale = 1.0 / math.sqrt(d)
    k = _expand_heads(_gather_pages(k_pages, tables), h).float()
    v = _expand_heads(_gather_pages(v_pages, tables), h).float()
    qf = q.float() * scale
    s = torch.einsum("nhd,nkhd->nhk", qf, k)              # [N, H, MP*T]
    s = s.masked_fill(~_key_mask(tables, lengths, k_pages.shape[1]),
                      _NEG_INF)
    if extra_k is not None:
        ek = _expand_heads(extra_k, h).float()             # [N, H, D]
        ev = _expand_heads(extra_v, h).float()
        s = torch.cat([s, torch.einsum("nhd,nhd->nh", qf, ek)[..., None]],
                      dim=-1)
        v = torch.cat([v, ev[:, None]], dim=1)             # [N, K+1, H, D]
    if local_k is not None:
        g, w = local_mask.shape[0], local_mask.shape[1]
        lk = _expand_heads(local_k, h).float()             # [G, W, H, D]
        lv = _expand_heads(local_v, h).float()
        ls = torch.einsum("gihd,gjhd->gihj", qf.reshape(g, w, h, d), lk)
        ls = ls.masked_fill(~local_mask.bool()[:, :, None, :], _NEG_INF)
        s = torch.cat([s, ls.reshape(n, h, w)], dim=-1)
        lvb = lv[:, None].expand(g, w, w, h, d).reshape(n, w, h, d)
        v = torch.cat([v, lvb], dim=1)
    # -inf-safe softmax: rows with no visible key give zeros, not NaN
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    pr = torch.exp(s - m)
    pr = torch.where(torch.isneginf(s), torch.zeros_like(pr), pr)
    l = pr.sum(dim=-1, keepdim=True)
    pr = pr / torch.where(l == 0.0, torch.ones_like(l), l)
    return torch.einsum("nhk,nkhd->nhd", pr, v).to(q.dtype)


def _paged_oml_plain(q, k_pages, v_pages, tables, lengths, scale):
    """The split kernel's plain version over one range of page entries:
    the paged part only, as the unnormalised (o [N,H,D], m [N,H],
    l [N,H]) online-softmax state."""
    h = q.shape[1]
    k = _expand_heads(_gather_pages(k_pages, tables), h).float()
    v = _expand_heads(_gather_pages(v_pages, tables), h).float()
    s = torch.einsum("nhd,nkhd->nhk", q.float() * scale, k)
    s = s.masked_fill(~_key_mask(tables, lengths, k_pages.shape[1]),
                      _NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
    return torch.einsum("nhk,nkhd->nhd", p, v), m, p.sum(dim=-1)


def _merge_oml(parts):
    """Merge partial (o, m, l) states over disjoint key sets into one
    (the combine kernel's merge); all--inf rows stay (0, -inf, 0)."""
    m_all = torch.stack([m for _, m, _ in parts])
    mx = m_all.amax(dim=0)
    m_safe = torch.where(torch.isneginf(mx), torch.zeros_like(mx), mx)
    o, l = 0.0, 0.0
    for po, pm, pl in parts:
        w = torch.where(torch.isneginf(pm), torch.zeros_like(pm),
                        torch.exp(pm - m_safe))
        o = o + w[..., None] * po
        l = l + w * pl
    return o, mx, l


def _fold_self_key(o, mx, l, qf, extra_k, extra_v):
    """One more online-softmax fold: the always-visible self key."""
    h = qf.shape[1]
    ek = _expand_heads(extra_k, h).float()                  # [N, H, D]
    ev = _expand_heads(extra_v, h).float()
    es = torch.einsum("nhd,nhd->nh", qf, ek)
    m_new = torch.maximum(mx, es)
    alpha = torch.where(torch.isneginf(mx), torch.zeros_like(mx),
                        torch.exp(mx - m_new))
    pe = torch.exp(es - m_new)
    return o * alpha[..., None] + pe[..., None] * ev, l * alpha + pe


def _fold_local(o, mx, l, qf, local_k, local_v, local_mask):
    """The whole local key block at once, masked by ancestry."""
    n, h, d = qf.shape
    g, w = local_mask.shape[0], local_mask.shape[1]
    lk = _expand_heads(local_k, h).float()
    lv = _expand_heads(local_v, h).float()
    ls = torch.einsum("gihd,gjhd->gihj", qf.reshape(g, w, h, d), lk)
    ls = ls.masked_fill(~local_mask.bool()[:, :, None, :],
                        _NEG_INF).reshape(n, h, w)
    m_new = torch.maximum(mx, ls.amax(dim=-1))
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                         m_new)
    alpha = torch.where(torch.isneginf(mx), torch.zeros_like(mx),
                        torch.exp(mx - m_safe))
    pe = torch.exp(ls - m_safe[..., None])
    pe = torch.where(torch.isneginf(ls), torch.zeros_like(pe), pe)
    lvb = lv[:, None].expand(g, w, w, h, d).reshape(n, w, h, d)
    return (o * alpha[..., None] + torch.einsum("nhw,nwhd->nhd", pe, lvb),
            l * alpha + pe.sum(dim=-1))


def _normalise(o, l):
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return o / l[..., None]


def paged_attention_split_plain(q, k_pages, v_pages, tables, lengths,
                                extra_k=None, extra_v=None, *,
                                s_split: int):
    """The CUDA path's arithmetic in plain torch: the page entries cut
    into ``s_split`` ranges of ceil(MP / s_split) entries (for a
    :func:`split_plan` pair, the kernel's ranges), one (o, m, l) per
    range, merged, the self key folded, divided.  The tests hold it
    against the unsplit versions and the JAX package's."""
    mp = tables.shape[1]
    pps = max(1, -(-mp // s_split))
    scale = 1.0 / math.sqrt(q.shape[2])
    cols = torch.arange(mp, device=tables.device)
    parts = []
    for s in range(s_split):
        outside = (cols < s * pps) | (cols >= (s + 1) * pps)
        sub = tables.masked_fill(outside[None, :], -1)
        parts.append(_paged_oml_plain(q, k_pages, v_pages, sub, lengths,
                                      scale))
    o, mx, l = _merge_oml(parts)
    if extra_k is not None:
        o, l = _fold_self_key(o, mx, l, q.float() * scale, extra_k, extra_v)
    return _normalise(o, l).to(q.dtype)


# ---- the CUDA kernels -------------------------------------------------------

_SMEM_LIMIT = 227 * 1024
_lib = None


def split_plan(n: int, n_kv_heads: int, max_pages: int, sm_count: int):
    """``(s_split, pages_per_split)`` for the split kernel: enough blocks
    (rows x kv heads x splits) for about four per SM -- a decode call
    is bound by the pages in flight -- each a contiguous range of page
    entries.  Static shapes only -- never the lengths, so choosing it
    needs no device read."""
    if max_pages <= 0:
        return 1, 1
    want = -(-4 * sm_count // max(1, n * n_kv_heads))
    pps = -(-max_pages // max(1, min(max_pages, want)))
    return -(-max_pages // pps), pps


def scratch_shapes(n: int, n_heads: int, head_dim: int, s_split: int):
    """Shapes of the partial (o, m, l) the split kernel writes."""
    return ((s_split, n, n_heads, head_dim), (s_split, n, n_heads),
            (s_split, n, n_heads))


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.paged_attention_f32.argtypes = [
            p, i64, i64, p, p, i64, i64, i64, p, i64, p, p, p, p,
            i32, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float,
            p, p, i64, i64, p, p, p, i32, p]
        lib.paged_attention_f32.restype = i32
        lib.paged_attention_smem_bytes.argtypes = [i32, i32, i32, i32, i32]
        lib.paged_attention_smem_bytes.restype = i64
        lib.paged_attention_max_group_width.argtypes = []
        lib.paged_attention_max_group_width.restype = i32
        lib.paged_attention_error_string.argtypes = [i32]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_kernel_inputs(q, k_pages, v_pages, tables, lengths, extra_k,
                         extra_v):
    dev = q.device
    n, h, d = q.shape
    _, _, hkv, dk = k_pages.shape
    if q.dtype != torch.float32 or k_pages.dtype != torch.float32 \
            or v_pages.dtype != torch.float32:
        raise TypeError("the paged-attention kernel takes float32 q/K/V")
    if k_pages.device != dev or v_pages.device != dev \
            or tables.device != dev or lengths.device != dev:
        raise ValueError("q, K/V pages, tables and lengths must share one "
                         "CUDA device")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    if dk != d or v_pages.shape != k_pages.shape \
            or v_pages.stride() != k_pages.stride():
        raise ValueError("K and V pages must share shape and strides with "
                         "the query head dim")
    if h % hkv:
        raise ValueError(f"n_heads ({h}) must be a multiple of n_kv_heads "
                         f"({hkv})")
    if q.stride(-1) != 1 or k_pages.stride(-1) != 1 \
            or tables.stride(-1) != 1 or not lengths.is_contiguous() \
            or tables.shape[0] != n or lengths.shape != (n,):
        raise ValueError("paged-attention kernel layout: q/K/V head dim "
                         "contiguous, tables [N, MP] row-major, lengths [N]")
    # pages stream in 16-byte copies: every (page, token, head) row start
    # must be 16-byte aligned
    if d % 4 or any(x.data_ptr() % 16 for x in (k_pages, v_pages)) \
            or any(st % 4 for st in k_pages.stride()[:3]):
        raise ValueError("the paged-attention kernel needs 16-byte aligned "
                         "K/V page rows (base, strides, head dim)")
    if extra_k is not None:
        for x in (extra_k, extra_v):
            if x is None or x.dtype != torch.float32 or x.device != dev \
                    or x.shape != (n, hkv, d) or x.stride(-1) != 1:
                raise ValueError("extra_k/extra_v: float32 [N, Hkv, D] on "
                                 "q's device, head dim contiguous")
        if extra_v.stride() != extra_k.stride() \
                or any(x.data_ptr() % 16 for x in (extra_k, extra_v)) \
                or any(st % 4 for st in extra_k.stride()[:2]):
            raise ValueError("extra_k and extra_v must share strides and "
                             "have 16-byte aligned rows")


def _paged_kernel(q, k_pages, v_pages, tables, lengths, scale,
                  extra_k=None, extra_v=None, raw=False):
    """Launch ``csrc/paged_attention.cu`` (split kernel, then combine
    kernel) on the current stream.  Returns the normalised output with
    the self key folded in, or with ``raw`` the merged unnormalised
    (o, m, l).  Raises on any input the kernels do not take and on a
    launch error; never falls back."""
    _check_kernel_inputs(q, k_pages, v_pages, tables, lengths, extra_k,
                         extra_v)
    dev = q.device
    n, h, d = q.shape
    t, hkv = k_pages.shape[1], k_pages.shape[2]
    mp = tables.shape[1]
    lib = _kernel_lib()
    s_split, pps = split_plan(n, hkv, mp, sm_count(dev.index))
    if lib.paged_attention_smem_bytes(h, hkv, d, t, pps) > _SMEM_LIMIT \
            or (h // hkv) * d > lib.paged_attention_max_group_width():
        raise ValueError(f"page of {t} tokens x head dim {d} (x {h // hkv} "
                         f"query heads per kv head) exceeds the kernel's "
                         f"shared memory or registers")
    o_shape, m_shape, _ = scratch_shapes(n, h, d, s_split)
    f32 = torch.float32
    o_part = torch.empty(o_shape, dtype=f32, device=dev)
    ml_part = torch.empty((2,) + m_shape, dtype=f32, device=dev)
    out = torch.empty((n, h, d), dtype=f32, device=dev)
    ml = torch.empty((2, n, h), dtype=f32, device=dev) if raw else None
    ek_ptr = extra_k.data_ptr() if extra_k is not None else None
    ev_ptr = extra_v.data_ptr() if extra_k is not None else None
    e_sn, e_sh = extra_k.stride()[:2] if extra_k is not None else (0, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_attention_f32(
            q.data_ptr(), q.stride(0), q.stride(1),
            k_pages.data_ptr(), v_pages.data_ptr(),
            k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
            tables.data_ptr(), tables.stride(0), lengths.data_ptr(),
            o_part.data_ptr(), ml_part[0].data_ptr(), ml_part[1].data_ptr(),
            n, h, hkv, d, t, mp, s_split, pps, scale,
            ek_ptr, ev_ptr, e_sn, e_sh, out.data_ptr(),
            ml[0].data_ptr() if raw else None,
            ml[1].data_ptr() if raw else None, int(raw), stream)
    if rc:
        raise RuntimeError("paged-attention kernel launch failed: "
                           + lib.paged_attention_error_string(rc).decode())
    paged_attention.launches += 1
    paged_attention.cuda_launches += 2
    return (out, ml[0], ml[1]) if raw else out


# ---- the entry point --------------------------------------------------------

def paged_attention(q, k_pages, v_pages, tables, lengths,
                    extra_k=None, extra_v=None,
                    local_k=None, local_v=None, local_mask=None):
    """Paged attention (see the module docstring).  ``q`` on a CUDA
    device runs the kernels; ``q`` on the CPU runs their plain version.
    ``paged_attention.launches`` counts calls that reached the kernels,
    ``paged_attention.cuda_launches`` the CUDA kernels they launched (2
    per call: split and combine)."""
    n, h, d = q.shape
    _check_local(extra_k, local_k, local_v, local_mask, n)
    scale = 1.0 / math.sqrt(d)
    if q.is_cuda:
        if local_k is None:
            return _paged_kernel(q, k_pages, v_pages, tables, lengths, scale,
                                 extra_k, extra_v).to(q.dtype)
        o, mx, l = _paged_kernel(q, k_pages, v_pages, tables, lengths, scale,
                                 raw=True)
    else:
        o, mx, l = _paged_oml_plain(q, k_pages, v_pages, tables, lengths,
                                    scale)
        if extra_k is not None:
            o, l = _fold_self_key(o, mx, l, q.float() * scale, extra_k,
                                  extra_v)
    if local_k is not None:
        o, l = _fold_local(o, mx, l, q.float() * scale, local_k, local_v,
                           local_mask)
    return _normalise(o, l).to(q.dtype)


paged_attention.launches = 0
paged_attention.cuda_launches = 0
