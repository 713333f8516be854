"""TransformerRunner: a real transformer served over the paged KV cache.

Port of ``brpc_tpu/models/runner.py`` (the runner interface, the model,
its dense oracle and the standalone prefill helper).  The model is the reference's:
GQA attention and a tanh-gelu MLP, RMS norm with eps 1e-6 inside the
sqrt and no gain, a sin-then-cos position encoding, tied embeddings,
greedy decode taking the first index on an argmax tie.  Parameters are
a dict of tensors named and laid out as the JAX package's (``emb``,
``wq``, ``wk``, ``wv``, ``wo``, ``w1``, ``w2``, each ``[L, in, out]``
with ``x @ W``), so :func:`params_from_jax` carries them over as they
are.

Position/materialisation contract (as in the reference):

  * a sequence at ``position p`` has tokens 0..p-1 appended and real K/V
    for positions 0..p-2 at least (``seq.kv_filled``);
  * ``step(tok=t_{p-1}, pos=p)`` recomputes position p-1, attends over
    arena keys 0..p-2 plus its own in-flight K/V (the self key), and
    returns the next token and position p-1's packed K/V row, which the
    engine writes before the next step;
  * prefill covers suffix positions f..n-1 write-then-attend per layer:
    layer l's K/V are written into the pages first, then the layer
    attends over the page table with per-row causal lengths, so cold and
    warm prefill run the same kernel over the same arena.

Everything stays on the runner's device: K/V rows are written into the
arena as device tensors, and only the chosen token ids come back to the
host.  Matmuls are plain ``torch.matmul`` in f32; callers that compare
with the reference on a card turn TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``).
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kvcache.store import KVCacheStore
from ..ops.attention import flash_attention
from ..ops.paged_attention import arena_kv_view, paged_attention

DEFAULT_PREFILL_BUCKETS = (16, 64, 256, 1024, 4096)
PARAM_NAMES = ("emb", "wq", "wk", "wv", "wo", "w1", "w2")


class ModelRunner:
    """The model interface the decode engine drives.  ``wants_pages``
    asks the engine for per-slot page tables; ``kv_bytes_per_token`` is
    the size of the packed K/V row a step returns per slot;
    ``has_prefill`` enables the engine's prefill stage."""

    wants_pages: bool = False
    kv_bytes_per_token: int = 0
    has_prefill: bool = False
    name: str = "runner"

    def bind(self, store) -> None:
        """Called by the engine with its KV store.  Idempotent."""

    def prefill(self, tokens, positions, pages, seq=None):
        """Prefill one sequence's uncached suffix: ``tokens`` the
        bucket-padded suffix, ``positions`` their global positions,
        ``pages`` the slot's page-id row (-1 padded), ``seq`` the owning
        KVSeq.  K/V land in the pages."""
        raise NotImplementedError

    def step(self, tokens, positions, pages):
        """One decode step across every slot: ``tokens``/``positions``
        ``[num_slots]`` and the page-id tables ``[num_slots, MP]``.
        Returns ``(next_tokens, kv_rows)``: int32 next tokens (host) and
        the query positions' packed K/V rows ``[num_slots,
        kv_bytes_per_token]`` uint8 (device)."""
        raise NotImplementedError

    def verify(self, tokens, positions, tables, base_len, mask):
        """Score a draft tree in one call (see the reference): returns
        per-row greedy tokens ``[num_slots, K1]`` and K/V rows
        ``[num_slots, K1, kv_bytes_per_token]``."""
        raise NotImplementedError

    def close(self) -> None:
        pass


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 128
    d_model: int = 32
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 8
    d_ff: int = 64

    @property
    def kv_bytes_per_token(self) -> int:
        """One token slot: all layers' K then V, f32, laid out
        ``[n_layers, 2, n_kv_heads, head_dim]``."""
        return self.n_layers * 2 * self.n_kv_heads * self.head_dim * 4


def _param_shapes(cfg: TransformerConfig) -> dict:
    """name -> (shape, fan_in), stacked per layer."""
    dm, h, hkv, d, ff, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, cfg.d_ff, cfg.n_layers)
    return {
        "emb": ((cfg.vocab, dm), dm),
        "wq": ((L, dm, h * d), dm),
        "wk": ((L, dm, hkv * d), dm),
        "wv": ((L, dm, hkv * d), dm),
        "wo": ((L, h * d, dm), h * d),
        "w1": ((L, dm, ff), dm),
        "w2": ((L, ff, dm), ff),
    }


def init_runner_params(cfg: TransformerConfig, seed: int = 0, *,
                       device=None) -> dict:
    """Seeded random parameters (normal / sqrt(fan_in)) drawn from a
    ``torch.Generator`` on ``device`` (default ``cuda``).  The numbers
    differ from the JAX package's for the same seed; to compare the two
    packages, build the reference's and use :func:`params_from_jax`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return {name: torch.randn(shape, generator=gen, device=dev)
            / math.sqrt(fan_in)
            for name, (shape, fan_in) in _param_shapes(cfg).items()}


def params_from_jax(params: dict, device=None) -> dict:
    """The JAX package's parameters (numpy arrays, or anything
    ``np.asarray`` takes) as this package's: same names, same layout,
    f32 on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    missing = set(PARAM_NAMES) - set(params)
    if missing:
        raise ValueError(f"missing parameters {sorted(missing)}")
    return {name: torch.from_numpy(np.array(params[name], np.float32))
            .to(dev) for name in PARAM_NAMES}


def _check_params(params: dict, cfg: TransformerConfig,
                  device: torch.device) -> None:
    for name, (shape, _) in _param_shapes(cfg).items():
        t = params.get(name)
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"parameter {name}: expected {shape}, got "
                             f"{None if t is None else tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"parameter {name} lives on {t.device}, "
                             f"not {device}")


def _posenc(pos: torch.Tensor, dm: int) -> torch.Tensor:
    """Parameter-free sinusoidal position encoding: sin then cos."""
    half = dm // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=pos.device) / half)
    ang = pos.to(torch.float32)[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)


def _mlp(x, w1, w2):
    return F.gelu(x @ w1, approximate="tanh") @ w2


def dense_forward(params: dict, cfg: TransformerConfig, tokens: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """The dense reference forward: full causal self-attention over the
    whole sequence through :func:`flash_attention`, no cache.
    ``tokens``/``positions`` ``[B, S]`` on the parameters' device;
    returns logits ``[B, S, vocab]``."""
    b, s = tokens.shape
    h_, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = params["emb"][tokens] + _posenc(positions, cfg.d_model)
    for l in range(cfg.n_layers):
        x = _rms(h)
        q = (x @ params["wq"][l]).reshape(b, s, h_, d)
        k = (x @ params["wk"][l]).reshape(b, s, hkv, d)
        v = (x @ params["wv"][l]).reshape(b, s, hkv, d)
        o = flash_attention(q, k, v, causal=True)
        h = h + o.reshape(b, s, h_ * d) @ params["wo"][l]
        h = h + _mlp(_rms(h), params["w1"][l], params["w2"][l])
    return _rms(h) @ params["emb"].T


def dense_generate(params: dict, cfg: TransformerConfig,
                   prompt: Sequence[int], max_new_tokens: int, *,
                   device=None) -> list:
    """Greedy decode with NO cache (every step recomputes the whole
    sequence through :func:`dense_forward`): the oracle the paged path
    is held against.  Runs on ``device`` (default ``cuda``), where the
    parameters must live."""
    dev = resolve_device(device)
    _check_params(params, cfg, dev)
    out = [int(t) for t in prompt]
    for _ in range(max_new_tokens):
        toks = torch.tensor([out], dtype=torch.int64, device=dev)
        pos = torch.arange(len(out), dtype=torch.int32, device=dev)[None]
        logits = dense_forward(params, cfg, toks, pos)
        out.append(int(torch.argmax(logits[0, -1])))
    return out[len(prompt):]


def make_store_for(cfg: TransformerConfig, *, page_tokens: int = 8,
                   max_blocks: int = 8, pool=None, device=None,
                   commit_live_pages: bool = False,
                   name: str = "kv") -> KVCacheStore:
    """A KVCacheStore whose page slots hold ``cfg``'s packed K/V, on
    ``device`` (default ``cuda``)."""
    return KVCacheStore(pool, device,
                        page_bytes=page_tokens * cfg.kv_bytes_per_token,
                        page_tokens=page_tokens, max_blocks=max_blocks,
                        commit_live_pages=commit_live_pages, name=name)


class TransformerRunner(ModelRunner):
    """The real model (see the module docstring), on ``device`` (default
    ``cuda``), where its parameters and its store must live."""

    wants_pages = True
    has_prefill = True

    def __init__(self, params: dict, cfg: TransformerConfig, *, store=None,
                 device=None, name: str = "model"):
        self.device = resolve_device(device)
        _check_params(params, cfg, self.device)
        self.cfg = cfg
        self.params = params
        self.kv_bytes_per_token = cfg.kv_bytes_per_token
        self.name = name
        self.store = None
        self._mu = threading.Lock()
        if store is not None:
            self.bind(store)

    def bind(self, store) -> None:
        if store is None:
            raise ValueError("TransformerRunner needs a paged KVCacheStore "
                             "(store=)")
        with self._mu:
            if self.store is store:
                return
            if self.store is not None:
                raise ValueError("runner already bound to a store")
            if store.device != self.device:
                raise ValueError(f"store lives on {store.device}, runner "
                                 f"on {self.device}")
            kbpt = store.pagepool.kv_bytes_per_token
            if kbpt != self.cfg.kv_bytes_per_token:
                raise ValueError(
                    f"store kv_bytes_per_token={kbpt} != model slot "
                    f"{self.cfg.kv_bytes_per_token} (page_bytes/page_tokens"
                    f" must match the packed [L, 2, Hkv, D] f32 layout)")
            self.store = store

    # ---- helpers ----

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def _flat_tables(self, pages) -> torch.Tensor:
        """pid page tables -> flat arena indices (int32, on device)."""
        pages = np.asarray(pages, np.int32)
        flat = self.store.pagepool.flat_ids(pages.ravel().tolist())
        return self._tensor(np.asarray(flat, np.int32).reshape(pages.shape))

    def _kv(self) -> torch.Tensor:
        cfg = self.cfg
        return arena_kv_view(self.store.pagepool.arena(),
                             self.store.page_tokens, cfg.n_layers,
                             cfg.n_kv_heads, cfg.head_dim)

    def _proj(self, h, l):
        cfg, p = self.cfg, self.params
        n = h.shape[0]
        x = _rms(h)
        q = (x @ p["wq"][l]).reshape(n, cfg.n_heads, cfg.head_dim)
        k = (x @ p["wk"][l]).reshape(n, cfg.n_kv_heads, cfg.head_dim)
        v = (x @ p["wv"][l]).reshape(n, cfg.n_kv_heads, cfg.head_dim)
        return q, k, v

    def _out(self, h, o, l):
        p = self.params
        h = h + o.reshape(h.shape[0], -1) @ p["wo"][l]
        return h + _mlp(_rms(h), p["w1"][l], p["w2"][l])

    def _logits(self, h):
        return _rms(h) @ self.params["emb"].T

    # ---- the ModelRunner surface ----

    def step(self, tokens, positions, pages):
        tables = self._flat_tables(pages)
        qpos = self._tensor(positions) - 1      # the query position
        kv = self._kv()
        h = self.params["emb"][self._tensor(tokens, torch.int64)] \
            + _posenc(qpos, self.cfg.d_model)
        rows = []
        for l in range(self.cfg.n_layers):
            q, k, v = self._proj(h, l)
            rows.append(torch.stack([k, v], dim=1))     # [S, 2, Hkv, D]
            # arena keys 0..qpos-1 plus the in-flight self key: the query
            # position's slot is written only after this step returns
            o = paged_attention(q, kv[:, :, l, 0], kv[:, :, l, 1], tables,
                                qpos, extra_k=k, extra_v=v)
            h = self._out(h, o, l)
        nxt = torch.argmax(self._logits(h), dim=-1).to(torch.int32)
        kv_rows = torch.stack(rows, dim=1)               # [S, L, 2, Hkv, D]
        return (nxt.cpu().numpy(),
                kv_rows.reshape(len(kv_rows), -1).view(torch.uint8))

    def verify(self, tokens, positions, tables, base_len, mask):
        """Draft-tree verify: every row of every slot in ONE paged
        attention per layer, the drafts' in-call K/V folded in as the
        local key block under the ancestry ``mask``."""
        cfg = self.cfg
        toks = self._tensor(tokens, torch.int64)
        s, k1 = toks.shape
        r = s * k1
        flat = self._flat_tables(tables)
        qpos = self._tensor(positions).reshape(r) - 1
        lens = self._tensor(base_len)
        lmask = self._tensor(mask, torch.bool)
        kv = self._kv()
        h = self.params["emb"][toks.reshape(r)] + _posenc(qpos, cfg.d_model)
        rows = []
        for l in range(cfg.n_layers):
            q, k, v = self._proj(h, l)
            rows.append(torch.stack([k, v], dim=1))
            o = paged_attention(
                q, kv[:, :, l, 0], kv[:, :, l, 1], flat, lens,
                local_k=k.reshape(s, k1, cfg.n_kv_heads, cfg.head_dim),
                local_v=v.reshape(s, k1, cfg.n_kv_heads, cfg.head_dim),
                local_mask=lmask)
            h = self._out(h, o, l)
        nxt = torch.argmax(self._logits(h), dim=-1).to(torch.int32)
        kv_rows = torch.stack(rows, dim=1).reshape(s, k1, -1)
        return (nxt.reshape(s, k1).cpu().numpy(),
                kv_rows.contiguous().view(torch.uint8))

    def prefill(self, tokens, positions, pages, seq=None):
        """Write-then-attend per layer (see the module docstring)."""
        if seq is None:
            raise ValueError("TransformerRunner.prefill needs the owning "
                             "KVSeq (seq=)")
        cfg = self.cfg
        start = int(positions[0])
        n = len(seq.tokens) - start          # valid (un-padded) rows
        if n <= 0:
            return
        b = len(tokens)
        pos = self._tensor(positions)
        lengths = pos + 1                    # causal: keys 0..i
        h = self.params["emb"][self._tensor(tokens, torch.int64)] \
            + _posenc(pos, cfg.d_model)
        kv = self._kv()
        # the running slot payloads, on device: after layer l each valid
        # row holds layers 0..l, and layers above stay zero (unread)
        kvbuf = torch.zeros((b, cfg.n_layers, 2, cfg.n_kv_heads,
                             cfg.head_dim), dtype=torch.float32,
                            device=self.device)
        mp = len(pages)
        for l in range(cfg.n_layers):
            q, k, v = self._proj(h, l)
            kvbuf[:, l, 0] = k
            kvbuf[:, l, 1] = v
            # only the last layer's pass completes the slots
            self.store.write_kv(seq, start, kvbuf[:n],
                                final=(l == cfg.n_layers - 1))
            # re-read the table after the write: a copy-on-write inside
            # write_kv swaps page identities
            row = np.full((mp,), -1, np.int32)
            ids = seq.page_ids()[:mp]
            row[:len(ids)] = ids
            tables = self._flat_tables(np.broadcast_to(row, (b, mp)))
            o = paged_attention(q, kv[:, :, l, 0], kv[:, :, l, 1], tables,
                                lengths)
            h = self._out(h, o, l)

    # ---- scoring over the dense forward ----

    def score(self, padded):
        """Per-position greedy next-token ids ``[B, L]`` (float32, as the
        reference's batcher expects) over the dense forward."""
        return self._score(padded, None)

    def score_with_offsets(self, padded, offsets):
        """:meth:`score` for rows that are suffixes starting at
        ``offsets``."""
        return self._score(padded, offsets)

    def _score(self, padded, offsets):
        toks = self._tensor(padded, torch.int64)
        b, s = toks.shape
        pos = torch.arange(s, dtype=torch.int32,
                           device=self.device)[None].repeat(b, 1)
        if offsets is not None:
            pos = pos + self._tensor(offsets)[:b, None]
        logits = dense_forward(self.params, self.cfg, toks, pos)
        return torch.argmax(logits, dim=-1).cpu().numpy() \
            .astype(np.float32)


def run_prefill(runner: ModelRunner, seq, prompt: Sequence[int], *,
                buckets: Sequence[int] = DEFAULT_PREFILL_BUCKETS,
                max_pages: int = 64) -> int:
    """Prefill an admitted ``seq`` outside the engine: bucket-pad the
    uncached suffix and run ``runner.prefill``.  Returns the suffix
    length prefilled."""
    suffix = [int(t) for t in prompt[seq.prefill_from:]]
    if not suffix or not runner.has_prefill:
        return 0
    n = len(suffix)
    bucket = next((x for x in sorted(buckets) if n <= x), n)
    padded = np.zeros((bucket,), np.int32)
    padded[:n] = suffix
    positions = seq.prefill_from + np.arange(bucket, dtype=np.int32)
    ids = seq.page_ids()
    pages = np.full((max(max_pages, len(ids)),), -1, np.int32)
    pages[:len(ids)] = ids
    runner.prefill(padded, positions, pages, seq=seq)
    return n
