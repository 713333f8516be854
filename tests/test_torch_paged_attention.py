"""The port's paged attention held against the JAX package's.

The same seeded numpy inputs go through ``brpc_tpu``'s
``paged_attention_gather`` and ``paged_attention_pallas`` (the Pallas
kernel in interpret mode, as the JAX package's own tests run it) and
through ``brpc_tpu_torch``'s ``paged_attention`` (on the CPU: the
kernel's plain version plus the wrapper's fold) and
``paged_attention_plain``.  Tolerance: f32 atol 1e-5, the JAX package's
own bound for these cases.  The CUDA kernel itself runs only on a card:
its tests are in ``test_torch_cuda_kernels.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.ops.paged_attention import arena_kv_view as jax_arena_kv_view
from brpc_tpu.ops.paged_attention import (paged_attention_gather,
                                          paged_attention_pallas)
from brpc_tpu_torch.ops.paged_attention import (arena_kv_view,
                                                paged_attention,
                                                paged_attention_plain,
                                                paged_attention_split_plain,
                                                scratch_shapes, split_plan)

ATOL = 1e-5
JAX_BACKENDS = ("gather", "pallas")
PORT_FNS = {"wrapper": paged_attention, "plain": paged_attention_plain}


# Both JAX paths jitted (the Pallas kernel still in interpret mode):
# called eagerly, each of their ops compiles again for every case's
# shapes, seconds a case; jitted, one program a case.  The jitted
# results differ from the eager ones by float rounding only, far inside
# ATOL.
_JAX = {"gather": jax.jit(paged_attention_gather),
        "pallas": jax.jit(functools.partial(paged_attention_pallas,
                                            interpret=True))}


def _jax(backend, args, kw):
    args = [jnp.asarray(a) for a in args]
    kw = {k: jnp.asarray(v) for k, v in kw.items()}
    return np.asarray(_JAX[backend](*args, **kw))


def _port(fn, args, kw):
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    kw = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in kw.items()}
    return PORT_FNS[fn](*args, **kw).numpy()


# ---- seeded cases (the ones of tests/test_paged_attention.py) ---------------

def _lengths_gqa():
    rng = np.random.default_rng(7)
    P, T, Hkv, D, H, MP = 12, 4, 2, 8, 4, 6
    kp = rng.standard_normal((P, T, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, T, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((4, H, D)).astype(np.float32)
    tables = np.full((4, MP), -1, np.int32)
    tables[0, :2] = [3, 7]                 # exactly 2 full pages
    tables[1, :3] = [1, 0, 9]              # mid-page
    tables[2, :6] = [11, 2, 4, 5, 6, 8]    # long row
    tables[3, :1] = [10]                   # single partial page
    lengths = np.array([8, 10, 23, 1], np.int32)
    return (q, kp, vp, tables, lengths), {}


def _self_key():
    rng = np.random.default_rng(11)
    P, T, Hkv, D, H, MP = 6, 4, 2, 8, 4, 3
    kp = rng.standard_normal((P, T, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, T, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((3, H, D)).astype(np.float32)
    ek = rng.standard_normal((3, Hkv, D)).astype(np.float32)
    ev = rng.standard_normal((3, Hkv, D)).astype(np.float32)
    tables = np.full((3, MP), -1, np.int32)
    tables[0, :2] = [0, 1]
    tables[1, :1] = [5]
    lengths = np.array([7, 2, 0], np.int32)     # row 2: self key only
    return (q, kp, vp, tables, lengths), {"extra_k": ek, "extra_v": ev}


def _dead_entry():
    rng = np.random.default_rng(13)
    P, T, Hkv, D, H = 5, 4, 2, 8, 4
    kp = rng.standard_normal((P, T, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, T, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((1, H, D)).astype(np.float32)
    tables = np.array([[2, -1, 4]], np.int32)   # dead entry mid-table
    lengths = np.array([12], np.int32)
    return (q, kp, vp, tables, lengths), {}


def _zero_rows():
    q = np.ones((2, 4, 8), np.float32)
    kp = np.zeros((2, 4, 2, 8), np.float32)
    tables = np.full((2, 3), -1, np.int32)
    return (q, kp, kp.copy(), tables, np.zeros((2,), np.int32)), {}


def _local_block():
    """Slots at different accept depths in one call: zero drafts, a full
    chain, a short chain, a tree, and fully padded rows."""
    rng = np.random.default_rng(23)
    P, T, Hkv, D, H, MP = 10, 4, 2, 8, 4, 4
    S, K1 = 4, 4
    N = S * K1
    kp = rng.standard_normal((P, T, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, T, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((N, H, D)).astype(np.float32)
    lk = rng.standard_normal((S, K1, Hkv, D)).astype(np.float32)
    lv = rng.standard_normal((S, K1, Hkv, D)).astype(np.float32)
    tables = np.full((N, MP), -1, np.int32)
    lengths = np.zeros((N,), np.int32)
    mask = np.zeros((S, K1, K1), bool)

    def slot(s, pages, base, rows_mask):
        for r, vis in enumerate(rows_mask):
            if vis is None:
                continue
            i = s * K1 + r
            tables[i, :len(pages)] = pages
            lengths[i] = base
            for j in vis:
                mask[s, r, j] = True

    slot(0, [2, 5], 6, [[0], None, None, None])
    slot(1, [1, 3, 7], 9, [[0], [0, 1], [0, 1, 2], [0, 1, 2, 3]])
    slot(2, [8], 2, [[0], [0, 1], None, None])
    slot(3, [0, 9], 5, [[0], [0, 1], [0, 2], None])
    return (q, kp, vp, tables, lengths), {"local_k": lk, "local_v": lv,
                                          "local_mask": mask}


def _mixed_rows():
    """Rows the split kernel cuts differently: long and short, a -1 entry
    mid-table, a zero-length row, the self key on every row."""
    rng = np.random.default_rng(29)
    P, T, Hkv, D, H, MP = 16, 4, 2, 8, 4, 8
    kp = rng.standard_normal((P, T, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, T, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((4, H, D)).astype(np.float32)
    ek = rng.standard_normal((4, Hkv, D)).astype(np.float32)
    ev = rng.standard_normal((4, Hkv, D)).astype(np.float32)
    tables = np.full((4, MP), -1, np.int32)
    tables[0, :8] = [3, 1, 4, -1, 5, 9, 2, 6]   # dead entry mid-table
    tables[1, :2] = [7, 8]
    tables[2, :8] = [10, 11, 12, 13, 14, 15, 0, 1]
    lengths = np.array([31, 5, 32, 0], np.int32)
    return (q, kp, vp, tables, lengths), {"extra_k": ek, "extra_v": ev}


CASES = {"lengths_gqa": _lengths_gqa, "self_key": _self_key,
         "dead_entry": _dead_entry, "zero_rows": _zero_rows,
         "local_block": _local_block, "mixed_rows": _mixed_rows}


@functools.cache
def _reference(case, backend):
    args, kw = CASES[case]()
    return _jax(backend, args, kw)


@pytest.mark.parametrize("fn", sorted(PORT_FNS))
@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_jax(case, backend, fn):
    args, kw = CASES[case]()
    out = _port(fn, args, kw)
    assert not np.isnan(out).any()
    np.testing.assert_allclose(out, _reference(case, backend), atol=ATOL,
                               err_msg=f"{case}: port {fn} vs jax {backend}")


@pytest.mark.parametrize("fn", sorted(PORT_FNS))
def test_rows_with_nothing_visible_are_zero(fn):
    args, kw = _zero_rows()
    np.testing.assert_array_equal(_port(fn, args, kw), 0)


@pytest.mark.parametrize("fn", sorted(PORT_FNS))
def test_local_block_rejects_bad_shapes(fn):
    """extra_k and local_k are mutually exclusive; the local block's
    groups must tile the query rows exactly; local_k needs its mask."""
    rng = np.random.default_rng(3)
    kp = torch.from_numpy(rng.standard_normal((2, 4, 2, 8))
                          .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((4, 4, 8)).astype(np.float32))
    tables = torch.zeros((4, 1), dtype=torch.int32)
    lengths = torch.ones((4,), dtype=torch.int32)
    lk = torch.from_numpy(rng.standard_normal((2, 2, 2, 8))
                          .astype(np.float32))
    ek = torch.from_numpy(rng.standard_normal((4, 2, 8)).astype(np.float32))
    f = PORT_FNS[fn]
    with pytest.raises(ValueError):
        f(q, kp, kp, tables, lengths, extra_k=ek, extra_v=ek, local_k=lk,
          local_v=lk, local_mask=torch.ones((2, 2, 2), dtype=torch.bool))
    with pytest.raises(ValueError):
        f(q, kp, kp, tables, lengths, local_k=lk, local_v=lk,
          local_mask=torch.ones((3, 2, 2), dtype=torch.bool))
    with pytest.raises(ValueError):
        f(q, kp, kp, tables, lengths, local_k=lk)


def test_bad_head_ratio_rejected():
    q = torch.zeros((1, 6, 8))
    kp = torch.zeros((2, 4, 4, 8))
    with pytest.raises(ValueError):
        paged_attention(q, kp, kp, torch.zeros((1, 1), dtype=torch.int32),
                        torch.ones((1,), dtype=torch.int32),
                        extra_k=torch.zeros((1, 4, 8)),
                        extra_v=torch.zeros((1, 4, 8)))


def test_arena_view_is_zero_copy_and_matches_jax_bitcast():
    """The uint8 arena viewed as [P, T, L, 2, Hkv, D] f32 shares the
    arena's memory (also through a strided page stride) and reads the
    same floats as the JAX package's bitcast of the same bytes."""
    rng = np.random.default_rng(5)
    P, T, L, Hkv, D = 6, 4, 2, 2, 8
    page_bytes = T * L * 2 * Hkv * D * 4
    backing = torch.from_numpy(
        rng.integers(0, 255, (P, 2 * page_bytes), dtype=np.uint8))
    arena = backing[:, :page_bytes]            # page stride 2 * page_bytes
    view = arena_kv_view(arena, T, L, Hkv, D)
    assert view.untyped_storage().data_ptr() == \
        backing.untyped_storage().data_ptr()
    ref = np.asarray(jax_arena_kv_view(
        jnp.asarray(arena.contiguous().numpy()), T, L, Hkv, D))
    np.testing.assert_array_equal(view.numpy(), ref)
    view[1, 2, 1, 0, 1, 3] = 42.0             # writes land in the arena
    assert backing[1, :page_bytes].view(torch.float32).view(
        T, L, 2, Hkv, D)[2, 1, 0, 1, 3] == 42.0


def test_strided_layer_slices_match_jax():
    """K/V read through the layer slices of a strided arena view (the
    runner's exact call) match the JAX gather over the same bytes."""
    rng = np.random.default_rng(17)
    P, T, L, Hkv, D, H = 8, 4, 3, 2, 8, 4
    kv = rng.standard_normal((P, T, L, 2, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((3, H, D)).astype(np.float32)
    tables = np.array([[5, 1, -1], [0, -1, -1], [7, 3, 2]], np.int32)
    lengths = np.array([7, 3, 12], np.int32)
    u8 = torch.from_numpy(kv.reshape(P, -1).view(np.uint8).copy())
    view = arena_kv_view(u8, T, L, Hkv, D)
    for layer in range(L):
        out = paged_attention(torch.from_numpy(q), view[:, :, layer, 0],
                              view[:, :, layer, 1],
                              torch.from_numpy(tables),
                              torch.from_numpy(lengths)).numpy()
        ref = np.asarray(paged_attention_gather(
            jnp.asarray(q), jnp.asarray(kv[:, :, layer, 0]),
            jnp.asarray(kv[:, :, layer, 1]), jnp.asarray(tables),
            jnp.asarray(lengths)))
        np.testing.assert_allclose(out, ref, atol=ATOL)


def test_cpu_tensors_never_count_as_kernel_launches():
    args, kw = _self_key()
    before = paged_attention.launches
    _port("wrapper", args, kw)
    assert paged_attention.launches == before



# ---- the split-K merge of the CUDA path -------------------------------------

SPLIT_CASES = sorted(CASES)


def _torch_case(case):
    args, kw = CASES[case]()
    return ([torch.from_numpy(np.ascontiguousarray(a)) for a in args],
            {k: torch.from_numpy(v) for k, v in kw.items()})


@pytest.mark.parametrize("s_split", [1, 2, 3, 9])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_merge_matches_unsplit_plain(case, s_split):
    """Page entries cut into s_split ranges (9: more ranges than
    entries), one (o, m, l) per range, merged with the self key or the
    local block in the combine kernel's order: the same output as the
    one-softmax plain version."""
    args, kw = _torch_case(case)
    out = paged_attention_split_plain(*args, **kw, s_split=s_split)
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out, paged_attention_plain(*args, **kw),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("s_split", [1, 2, 3, 9])
@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_merge_matches_jax(case, backend, s_split):
    args, kw = _torch_case(case)
    out = paged_attention_split_plain(*args, **kw, s_split=s_split).numpy()
    np.testing.assert_allclose(out, _reference(case, backend), atol=ATOL,
                               err_msg=f"{case}: split {s_split} vs jax "
                                       f"{backend}")


@pytest.mark.parametrize("n,hkv,mp,sms", [
    (8, 4, 16, 132),        # the wide configuration's decode step
    (256, 4, 16, 132),      # ... a prefill bucket: enough blocks already
    (32, 4, 16, 132),       # ... a verify group
    (8, 4, 128, 132),       # ... a ~2048-key context
    (4, 2, 32, 132),        # TransformerConfig() decode
    (1, 1, 1, 132),
    (3, 1, 0, 132),         # no page entries at all
])
def test_split_plan_covers_every_entry(n, hkv, mp, sms):
    """The splits tile the page entries in contiguous ranges, none empty
    by construction, with about four blocks per SM where the table is
    long enough, and the split model cuts the same ranges."""
    s_split, pps = split_plan(n, hkv, mp, sms)
    assert s_split >= 1 and pps >= 1
    if mp:
        assert s_split <= mp and (s_split - 1) * pps < mp <= s_split * pps
        assert -(-mp // s_split) == pps
        assert n * hkv * s_split >= min(4 * sms, n * hkv * mp) / 2
    o, m, l = scratch_shapes(n, 8, 128, s_split)
    assert o == (s_split, n, 8, 128) and m == l == (s_split, n, 8)


def test_split_plan_never_sees_lengths():
    """Choosing the split needs no device read: the plan takes only the
    static shapes and the SM count, so one plan serves every length."""
    import inspect
    assert list(inspect.signature(split_plan).parameters) == [
        "n", "n_kv_heads", "max_pages", "sm_count"]
    args, kw = _torch_case("mixed_rows")
    s_split, _ = split_plan(4, 2, 8, 132)
    for lengths in ([31, 5, 32, 0], [1, 1, 1, 1], [32, 8, 0, 0]):
        args[4] = torch.tensor(lengths, dtype=torch.int32)
        torch.testing.assert_close(
            paged_attention_split_plain(*args, **kw, s_split=s_split),
            paged_attention_plain(*args, **kw), atol=ATOL, rtol=0)
