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
import json
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
from brpc_tpu_torch.ops.paged_attention import (MAX_LOCAL_WIDTH,
                                                arena_kv_view,
                                                paged_attention,
                                                paged_attention_plain,
                                                paged_attention_split_plain,
                                                split_plan)
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import fault
from brpc_tpu_torch.serving import (DecodeEngine, DynamicBatcher,
                                    EngineSupervisor, register_serving)
from brpc_tpu_torch.serving.speculative import (DraftModelProposer,
                                                NGramProposer)

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


def _tree_masks(rng, g, w):
    """Random draft trees, one per group: row 0 is the root, each later
    row either padded (sees nothing) or the child of an earlier real row
    (sees its ancestors and itself); every fourth group is all padding."""
    mask = np.zeros((g, w, w), bool)
    for gi in range(g):
        if gi % 4 == 3:
            continue
        mask[gi, 0, 0] = True
        for r in range(1, w):
            real = [p for p in range(r) if mask[gi, p, p]]
            if rng.random() < 0.25:
                continue
            mask[gi, r] = mask[gi, rng.choice(real)]
            mask[gi, r, r] = True
    return mask


def _local_inputs(dev, rng, *, g, w, h, hkv, d, t, mp):
    """Verify-shaped inputs: G groups of W rows, each group's rows on one
    page table of a real PagePool arena at one length, the local K/V as
    strided views of one [G, W, 2, Hkv, D] projection tensor, random tree
    masks; padded rows have no page entry and length 0."""
    n = g * w
    pool = PagePool(page_bytes=t * 2 * hkv * d * 4, page_tokens=t,
                    max_blocks=64, device=dev, name="t_cuda_local")
    pages = [pool.alloc_page() for _ in range(g * mp)]
    for p in pages:
        pool.write_raw(p, rng.standard_normal(pool.page_bytes // 4)
                       .astype(np.float32).view(np.uint8))
    flat = np.asarray(pool.flat_ids([p.pid for p in pages]), np.int32)
    kv = arena_kv_view(pool.arena(), t, 1, hkv, d)
    mask = _tree_masks(rng, g, w)
    real = mask.any(axis=2).reshape(n)
    tables = np.repeat(flat.reshape(g, mp), w, axis=0)
    lengths = np.repeat(rng.integers(1, mp * t + 1, g), w).astype(np.int32)
    tables[~real] = -1
    lengths[~real] = 0
    rows = torch.from_numpy(rng.standard_normal((g, w, 2, hkv, d))
                            .astype(np.float32)).to(dev)
    args = (torch.from_numpy(rng.standard_normal((n, h, d))
                             .astype(np.float32)).to(dev),
            kv[:, :, 0, 0], kv[:, :, 0, 1],
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths).to(dev))
    kw = {"local_k": rows[:, :, 0], "local_v": rows[:, :, 1],
          "local_mask": torch.from_numpy(mask).to(dev)}
    return pool, pages, args, kw, real


@pytest.mark.parametrize("t", [4, 16])
@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("w", [1, 3, 5, 9, 16])
def test_local_block_kernel_matches_split_plain(cuda, w, group, d, t):
    """The verify's local block folded in the combine kernel: random
    draft trees and fully padded rows, against the split-K plain version
    at the kernel's own split plan, in 2 CUDA launches."""
    rng = np.random.default_rng(1000 * w + 100 * group + d + t)
    hkv = 2
    pool, pages, args, kw, real = _local_inputs(
        cuda, rng, g=8, w=w, h=hkv * group, hkv=hkv, d=d, t=t, mp=4)
    try:
        before = (paged_attention.launches, paged_attention.cuda_launches)
        out = paged_attention(*args, **kw)
        torch.cuda.synchronize()
        assert (paged_attention.launches, paged_attention.cuda_launches) \
            == (before[0] + 1, before[1] + 2)
        s_split, _ = split_plan(8 * w, hkv, 4, torch.cuda
                                .get_device_properties(cuda)
                                .multi_processor_count)
        ref = paged_attention_split_plain(*args, **kw, s_split=s_split)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
        torch.testing.assert_close(out, paged_attention_plain(*args, **kw),
                                   atol=1e-4, rtol=0)
        assert torch.equal(out[torch.from_numpy(~real).to(cuda)],
                           torch.zeros_like(out[torch.from_numpy(~real)
                                                .to(cuda)]))
    finally:
        for p in pages:
            pool.unref(p)


def test_local_block_kernel_refuses_what_it_does_not_take(cuda):
    """Local K/V rows off 16 bytes, and a block wider than the kernel's
    MAX_LOCAL_WIDTH, raise before any launch."""
    rng = np.random.default_rng(5)
    pool, pages, args, kw, _ = _local_inputs(cuda, rng, g=2, w=4, h=4,
                                             hkv=2, d=8, t=4, mp=2)
    try:
        base = torch.zeros((2 * 4 * 2 * 8 + 1,), device=cuda)
        bad = dict(kw, local_k=base[1:].view(2, 4, 2, 8),
                   local_v=base[1:].view(2, 4, 2, 8))
        with pytest.raises(ValueError, match="aligned"):
            paged_attention(*args, **bad)
        w = MAX_LOCAL_WIDTH + 1
        wide = {"local_k": torch.zeros((1, w, 2, 8), device=cuda),
                "local_v": torch.zeros((1, w, 2, 8), device=cuda),
                "local_mask": torch.ones((1, w, w), dtype=torch.bool,
                                         device=cuda)}
        q = torch.zeros((w, 4, 8), device=cuda)
        tables = torch.full((w, 2), -1, dtype=torch.int32, device=cuda)
        lengths = torch.zeros((w,), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="exceeds"):
            paged_attention(q, args[1], args[2], tables, lengths, **wide)
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


@pytest.mark.parametrize("proposer", ["ngram", "draft-model"])
def test_speculative_engine_on_card_streams_the_dense_oracle(cuda,
                                                             proposer):
    """The speculative engine on the card: every verify call reaches the
    paged kernels at 2 CUDA launches, and the streams equal the dense
    oracle's, cold and warm, with no sequence left live."""
    cfg = T.TransformerConfig()
    params = T.init_runner_params(cfg, 2, device=cuda)
    store = T.make_store_for(cfg, page_tokens=4, max_blocks=16, device=cuda,
                             name="t_cuda_spec")
    runner = T.TransformerRunner(params, cfg, store=store, device=cuda)
    draft = NGramProposer() if proposer == "ngram" \
        else DraftModelProposer(params, cfg, width=2)
    eng = DecodeEngine(runner=runner, store=store, num_slots=2,
                       max_pages_per_slot=16, prefill_buckets=(16,),
                       draft_runner=draft, draft_len=4, device=cuda,
                       name="t_cuda_spec")
    prompts = ([5, 17, 42, 9, 77, 3], [88, 12, 54, 61, 7, 30, 2, 1, 9])
    want = [T.dense_generate(params, cfg, p, 10, device=cuda)
            for p in prompts]
    try:
        paged_attention.launches = paged_attention.cuda_launches = 0
        for _ in range(2):
            recs = []
            for p in prompts:
                toks, ev = [], threading.Event()
                eng.submit(p, 10, toks.append, lambda e, ev=ev: ev.set())
                recs.append((toks, ev))
            assert [ev.wait(60) and toks for toks, ev in recs] == want
        sp = eng.stats()["speculative"]
        assert sp["verify_calls"] > 0 and sp["spec_accepted"] > 0
        assert paged_attention.launches >= sp["verify_calls"] * cfg.n_layers
        assert paged_attention.cuda_launches == 2 * paged_attention.launches
        assert eng.join_idle(10) and store.stats()["live_seqs"] == 0
    finally:
        eng.close()
        store.clear()


def test_serving_generate_over_loopback_on_card(cuda):
    """Two concurrent ``Serving.Generate`` streams through the port's own
    server and channel on loopback, the engine on the card: each stream
    equals the dense oracle, cold and warm (prefix hit on the warm
    pass), the paged kernel ran on the way, and after server, engine
    and store shut down in that order the pool is at its baseline."""
    cfg = T.TransformerConfig()
    params = T.init_runner_params(cfg, 3, device=cuda)
    store = T.make_store_for(cfg, page_tokens=4, max_blocks=16, device=cuda,
                             name="t_cuda_rpc")
    free0 = store.pagepool.pool.stats()["classes"]
    runner = T.TransformerRunner(params, cfg, store=store, device=cuda)
    eng = DecodeEngine(runner=runner, store=store, num_slots=2,
                       max_pages_per_slot=16, prefill_buckets=(16,),
                       device=cuda, name="t_cuda_rpc")
    server = rpc.Server()
    register_serving(server, engine=eng)
    server.start("127.0.0.1", 0)
    prompts = ([5, 17, 42, 9, 77, 3], [88, 12, 54, 61, 7, 30, 2, 1, 9])
    want = [T.dense_generate(params, cfg, p, 8, device=cuda)
            for p in prompts]

    class Collect(rpc.StreamHandler):
        def __init__(self):
            self.msgs, self.done = [], threading.Event()

        def on_received_messages(self, stream, messages):
            self.msgs.extend(json.loads(m) for m in messages)

        def on_closed(self, stream):
            self.done.set()

    try:
        ch = rpc.Channel(f"127.0.0.1:{server.port}", timeout_ms=60_000)
        paged_attention.launches = 0
        for warm in (False, True):
            cols, hits = [], []
            for p in prompts:
                col, cntl = Collect(), rpc.Controller()
                rpc.stream_create(cntl, col)
                resp = ch.call_sync("Serving", "Generate",
                                    {"prompt": p, "max_new_tokens": 8},
                                    serializer="json", cntl=cntl)
                cols.append(col)
                hits.append(resp["prefix_hit"])
            for col, w in zip(cols, want):
                assert col.done.wait(60)
                assert col.msgs[-1] == {"done": True}
                assert [m["token"] for m in col.msgs[:-1]] == w
            assert all(h > 0 for h in hits) if warm \
                else hits == [0, 0]
        assert paged_attention.launches > 0
        assert eng.join_idle(10) and store.stats()["live_seqs"] == 0
    finally:
        server.stop()
        server.join()
        eng.close()
        store.clear()
    assert store.pagepool.blocks_leased() == 0 and \
        store.pagepool.pool.stats()["classes"] == free0


@pytest.mark.parametrize("s", [64, 256])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_score_batcher_on_card_equals_unbatched_forward(cuda, b, s):
    """``b`` rows of about ``s`` tokens through a DynamicBatcher over a
    runner on the card (``TransformerRunner.score`` -> the flash kernel
    once per layer per batch): every row's ids equal the argmax of that
    row's own unbatched dense forward, exactly."""
    cfg = T.TransformerConfig(vocab=512, d_model=256, n_layers=2,
                              n_heads=8, n_kv_heads=4, head_dim=32,
                              d_ff=512)
    params = T.init_runner_params(cfg, 5, device=cuda)
    runner = T.TransformerRunner(params, cfg, device=cuda)
    rng = np.random.default_rng(b * s)
    rows = [rng.integers(0, cfg.vocab, s - int(rng.integers(0, 8))).tolist()
            for _ in range(b)]
    batcher = DynamicBatcher(runner, max_batch_size=8, max_delay_us=50_000,
                             length_buckets=(64, 256), dtype=np.int32,
                             name=f"t_cuda_score_{b}_{s}")
    out = [None] * b
    try:
        attention.flash_attention.launches = 0

        def one(i):
            out[i] = batcher.submit_wait(np.asarray(rows[i], np.int32),
                                         timeout_s=120)

        ts = [threading.Thread(target=one, args=(i,)) for i in range(b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(180)
        batches = batcher.stats()["batches"]
        assert attention.flash_attention.launches == \
            cfg.n_layers * batches > 0
    finally:
        batcher.close()
    for row, got in zip(rows, out):
        logits = T.dense_forward(
            params, cfg, torch.tensor([row], device=cuda),
            torch.arange(len(row), dtype=torch.int32, device=cuda)[None])
        want = torch.argmax(logits[0], dim=-1).cpu().numpy()
        np.testing.assert_array_equal(np.asarray(got).astype(np.int64), want)


def test_supervisor_on_card_recovers_a_step_crash(cuda):
    """An EngineSupervisor over an engine on the card, one injected
    ``serving.step`` crash mid-decode: the engine is rebuilt on the same
    store, every stream equals ``dense_generate`` exactly once, the
    re-admissions hit the detached prefix, and the pool ends at its
    baseline."""
    cfg = T.TransformerConfig()
    params = T.init_runner_params(cfg, 9, device=cuda)
    store = T.make_store_for(cfg, page_tokens=4, max_blocks=16, device=cuda,
                             name="t_cuda_sup")
    free0 = store.pagepool.pool.stats()["classes"]

    def factory():
        runner = T.TransformerRunner(params, cfg, store=store, device=cuda)
        return DecodeEngine(runner=runner, store=store, num_slots=3,
                            max_pages_per_slot=16, prefill_buckets=(16,),
                            device=cuda, name="t_cuda_sup")

    sup = EngineSupervisor(factory, store=store, check_interval_s=0.02,
                           name="t_cuda_sup")
    prompts = [[5, 17, 42, 9, 77, 3, 8, 8, 1 + i] for i in range(5)]
    want = [T.dense_generate(params, cfg, p, 10, device=cuda)
            for p in prompts]
    plan = fault.FaultPlan(3).on(fault.STEP, fault.ERROR, times=1,
                                 after=3)
    recs = []
    try:
        with fault.injected(plan):
            for p in prompts:
                rec = {"toks": [], "errs": [], "ev": threading.Event()}
                sup.submit(p, 10, rec["toks"].append,
                           lambda e, r=rec: (r["errs"].append(e),
                                             r["ev"].set()))
                recs.append(rec)
            for rec in recs:
                assert rec["ev"].wait(120), "a generation hung"
        assert plan.injected == {fault.STEP: 1}
        for rec, w in zip(recs, want):
            assert rec["errs"] == [None] and rec["toks"] == w
        st = sup.stats()
        assert st["restarts"] == 1 and st["readmitted"] >= 1
        assert st["last_recovery"]["pinned_seqs"] >= 1
        assert sup.join_idle(10)
    finally:
        sup.close()
        store.clear()
    assert store.pagepool.blocks_leased() == 0 and \
        store.pagepool.pool.stats()["classes"] == free0
