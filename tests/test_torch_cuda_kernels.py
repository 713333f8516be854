"""The port's CUDA kernels against their plain versions, on a card.

Every test here carries the ``cuda`` marker and skips where no CUDA
device is present.  The file imports neither jax nor the JAX package, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest configures JAX.)  The kernels
build from ``brpc_tpu_torch/csrc`` at their first launch.  Tolerances:
f32 atol 1e-4 (the kernels sum in another order than the plain
versions), bf16 2e-2.  TF32 is off for every matmul here.
"""
import threading

import numpy as np
import pytest
import torch

import brpc_tpu_torch.ops.attention as attention
import brpc_tpu_torch.ops.paged_attention as pa
from brpc_tpu_torch.kvcache import PagePool
from brpc_tpu_torch.models import runner as T
from brpc_tpu_torch.ops.attention import (flash_attention,
                                          flash_attention_plain)
from brpc_tpu_torch.ops.paged_attention import (arena_kv_view,
                                                paged_attention,
                                                paged_attention_plain)
from brpc_tpu_torch.serving import DecodeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged_inputs(dev, rng, *, n, h, hkv, d, t, layers, mp, prefill,
                  extra):
    """Random K/V in a real PagePool arena on ``dev`` (strided layer
    slices, as the runner passes them), tables and lengths shaped like
    the serving path's decode (own table per row) or prefill (one table,
    causal lengths)."""
    pool = PagePool(page_bytes=t * layers * 2 * hkv * d * 4, page_tokens=t,
                    max_blocks=64, device=dev, name="t_cuda_pages")
    pages = [pool.alloc_page() for _ in range(mp * (1 if prefill else n))]
    for p in pages:
        pool.write_raw(p, rng.standard_normal(pool.page_bytes // 4)
                       .astype(np.float32).view(np.uint8))
    flat = np.asarray(pool.flat_ids([p.pid for p in pages]), np.int32)
    kv = arena_kv_view(pool.arena(), t, layers, hkv, d)
    if prefill:
        tables = np.broadcast_to(flat[:mp], (n, mp)).copy()
        lengths = np.arange(1, n + 1, dtype=np.int32)
        tables[:, -1] = -1                       # a dead tail entry
    else:
        tables = flat.reshape(n, mp).copy()
        lengths = rng.integers(0, mp * t + 1, n).astype(np.int32)
        tables[0, 1] = -1                        # a dead mid-table entry
    q = torch.from_numpy(rng.standard_normal((n, h, d))
                         .astype(np.float32)).to(dev)
    kw = {}
    if extra == "self_key":
        for name in ("extra_k", "extra_v"):
            kw[name] = torch.from_numpy(rng.standard_normal((n, hkv, d))
                                        .astype(np.float32)).to(dev)
    elif extra == "local_block":
        g, w = n // 4, 4
        for name in ("local_k", "local_v"):
            kw[name] = torch.from_numpy(rng.standard_normal((g, w, hkv, d))
                                        .astype(np.float32)).to(dev)
        kw["local_mask"] = torch.from_numpy(
            np.tril(np.ones((w, w), bool))[None].repeat(g, 0)).to(dev)
    args = (q, kv[:, :, layers - 1, 0], kv[:, :, layers - 1, 1],
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths).to(dev))
    return pool, pages, args, kw


@pytest.mark.parametrize("extra", ["none", "self_key", "local_block"])
@pytest.mark.parametrize("geom", [
    # (n, h, hkv, d, t, layers, mp, prefill)
    (4, 4, 2, 8, 4, 2, 8, False),       # TransformerConfig() decode
    (64, 4, 2, 8, 4, 2, 16, True),      # ... and its prefill bucket
    (8, 8, 4, 128, 16, 8, 4, False),    # the wide configuration's decode
    (64, 8, 4, 128, 16, 8, 4, True),    # ... and a prefill bucket
    (8, 8, 1, 64, 8, 1, 3, False),      # MQA
])
def test_paged_kernel_matches_plain(cuda, geom, extra):
    n, h, hkv, d, t, layers, mp, prefill = geom
    rng = np.random.default_rng(sum(geom))
    pool, pages, args, kw = _paged_inputs(
        cuda, rng, n=n, h=h, hkv=hkv, d=d, t=t, layers=layers, mp=mp,
        prefill=prefill, extra=extra)
    try:
        before = paged_attention.launches
        out = paged_attention(*args, **kw)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + 1
        ref = paged_attention_plain(*args, **kw)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    finally:
        for p in pages:
            pool.unref(p)


def test_paged_kernel_rows_with_nothing_visible_are_zero(cuda):
    q = torch.ones((3, 4, 8), device=cuda)
    kp = torch.full((2, 4, 2, 8), float("nan"), device=cuda)
    tables = torch.full((3, 2), -1, dtype=torch.int32, device=cuda)
    tables[1, 0] = 0
    lengths = torch.tensor([0, 0, 5], dtype=torch.int32, device=cuda)
    out = paged_attention(q, kp, kp, tables, lengths)
    assert torch.equal(out, torch.zeros_like(out)), \
        "an empty row read a page (NaN K/V) or gave NaN"


@pytest.mark.parametrize("s_split", [1, 3, 64])
@pytest.mark.parametrize("extra", ["none", "self_key", "local_block"])
def test_paged_split_counts_match_plain(cuda, monkeypatch, s_split, extra):
    """The split kernel at a forced number of splits -- one, several, and
    more splits than page entries (blocks past the table) -- with a -1
    entry mid-table and zero-length rows."""
    rng = np.random.default_rng(31 + s_split)
    pool, pages, args, kw = _paged_inputs(
        cuda, rng, n=8, h=8, hkv=4, d=128, t=16, layers=2, mp=6,
        prefill=False, extra=extra)
    args[4][2] = 0
    args[4][5] = 0
    monkeypatch.setattr(pa, "split_plan",
                        lambda n, hkv, mp, sms: (s_split,
                                                 max(1, -(-mp // s_split))))
    try:
        before = paged_attention.cuda_launches
        out = paged_attention(*args, **kw)
        torch.cuda.synchronize()
        assert paged_attention.cuda_launches == before + 2
        ref = paged_attention_plain(*args, **kw)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    finally:
        for p in pages:
            pool.unref(p)


def test_paged_kernel_refuses_unaligned_pages(cuda):
    """Pages stream in 16-byte copies: a page base off 16 bytes raises
    rather than reading misaligned."""
    kp = torch.zeros((2 * 4 * 2 * 8 + 1,), device=cuda)[1:].view(2, 4, 2, 8)
    q = torch.zeros((1, 4, 8), device=cuda)
    tables = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    lengths = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        paged_attention(q, kp, kp, tables, lengths)


def test_kernels_refuse_what_they_do_not_take(cuda):
    """A CUDA tensor never falls back to the plain version: a dtype or
    device the kernel does not take raises."""
    q = torch.zeros((1, 4, 8), dtype=torch.float64, device=cuda)
    kp = torch.zeros((1, 4, 2, 8), dtype=torch.float64, device=cuda)
    ok = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        paged_attention(q, kp, kp, ok, ok[0])
    with pytest.raises(ValueError):
        paged_attention(q.float(), kp.float().cpu(), kp.float().cpu(), ok,
                        ok[0])
    x = torch.zeros((1, 8, 2, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(x, x, x)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,hkv,d,causal", [
    (1, 1, 4, 2, 8, True),
    (1, 95, 4, 2, 8, True),             # the default model's oracle
    (1, 231, 8, 4, 128, True),          # the wide model's oracle
    (2, 100, 8, 1, 64, False),
    (2, 300, 8, 8, 128, True),
    (1, 64, 2, 2, 256, False),          # the largest head dim taken
])
def test_flash_kernel_matches_plain(cuda, b, s, h, hkv, d, causal, dtype,
                                    atol):
    rng = np.random.default_rng(s + d)
    q, k, v = [torch.from_numpy(rng.standard_normal((b, s, n, d))
                                .astype(np.float32)).to(cuda, dtype)
               for n in (h, hkv, hkv)]
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("m_tiles", [1, 2])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("d", [8, 64, 128])
@pytest.mark.parametrize("s", [63, 64, 65, 127, 129, 231])
def test_flash_kernel_tiles_and_edges(cuda, s, d, group, causal, dtype,
                                      atol, m_tiles):
    """Sequence lengths around the 64/128-row query tiles (one or two
    16-row m-tiles per warp) and the 16/32/64-key K/V tiles, the head
    dims the serving configurations use, GQA."""
    hkv = 2
    rng = np.random.default_rng(7 * s + d + group)
    q, k, v = [torch.from_numpy(rng.standard_normal((2, s, n, d))
                                .astype(np.float32)).to(cuda, dtype)
               for n in (hkv * group, hkv, hkv)]
    out = attention._flash_kernel(q, k, v, causal, m_tiles)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


def test_engine_on_card_streams_the_dense_oracle(cuda):
    """The default model served on the card (paged kernel) streams the
    tokens of its dense oracle (flash kernel), cold and warm."""
    cfg = T.TransformerConfig()
    params = T.init_runner_params(cfg, 1, device=cuda)
    store = T.make_store_for(cfg, page_tokens=4, max_blocks=16, device=cuda,
                             name="t_cuda_engine")
    runner = T.TransformerRunner(params, cfg, store=store, device=cuda)
    eng = DecodeEngine(runner=runner, store=store, num_slots=2,
                       max_pages_per_slot=16, prefill_buckets=(16,),
                       device=cuda, name="t_cuda_engine")
    prompts = ([5, 17, 42, 9, 77, 3], [88, 12, 54, 61, 7, 30, 2, 1, 9])
    try:
        for _ in range(2):
            recs = []
            for p in prompts:
                toks, ev = [], threading.Event()
                eng.submit(p, 6, toks.append, lambda e, ev=ev: ev.set())
                recs.append((toks, ev))
            for p, (toks, ev) in zip(prompts, recs):
                assert ev.wait(60)
                assert toks == T.dense_generate(params, cfg, p, 6,
                                                device=cuda)
        assert store.hit_tokens > 0
    finally:
        eng.close()
        store.clear()
