"""OptimizerSpec and the fused scatter-and-slot-update math (the port of
``brpc_tpu/train/optimizer.py``).

Optimizer slot rows (momentum; Adam m/v/step) live WITH the embedding
shard that owns the parameter rows, and ``PS.Update`` carrying an
optimizer spec runs

    gradient scatter  +  slot step  +  row step

as one call of :func:`fused_apply` on the shard's device, updating the
rows and slots IN PLACE.  The slots never cross the wire: the client
sends RAW gradients, not deltas.

The math lives here once (``sgdm_step`` / ``adam_step``, elementwise
torch ops) and serves both executors: the shard's fused apply
(:meth:`EmbeddingShardServer.update_opt`) and the dense oracle
(:func:`oracle_apply`) the bit-identity checks compare it against.

Semantics per touched row r (rows with no key in the update keep ALL
state bit for bit, Adam step counts included):

    sgdm:  m_r    <- momentum * m_r + g_r
           row_r  <- row_r - lr * m_r
    adam:  t_r    <- t_r + 1
           m_r    <- beta1 * m_r + (1 - beta1) * g_r
           v_r    <- beta2 * v_r + (1 - beta2) * g_r^2
           row_r  <- row_r - lr * (m_r / (1 - beta1^t_r))
                              / (sqrt(v_r / (1 - beta2^t_r)) + eps)

where g_r is the SUM of that row's gradient contributions in the update
(duplicate keys accumulate first, then the slot steps once).  On a CUDA
device ``index_add_`` accumulates duplicates in atomic order, so two
runs agree bit for bit only where float addition is exact (integer-
valued grads, as the tests use).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

VALID_KINDS = ("sgdm", "adam")


class OptimizerSpec:
    """One wire-parseable optimizer description.

    ``kind`` is ``"sgdm"`` (momentum SGD; uses ``lr``/``momentum``) or
    ``"adam"`` (uses ``lr``/``beta1``/``beta2``/``eps``).  Hyper-
    parameters ride the wire as plain floats.
    """

    __slots__ = ("kind", "lr", "momentum", "beta1", "beta2", "eps")

    def __init__(self, kind: str, *, lr: float = 0.1,
                 momentum: float = 0.9, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8):
        if kind not in VALID_KINDS:
            raise ValueError(f"optimizer kind must be one of "
                             f"{VALID_KINDS}, got {kind!r}")
        for fname, val in (("lr", lr), ("momentum", momentum),
                           ("beta1", beta1), ("beta2", beta2),
                           ("eps", eps)):
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                raise ValueError(f"optimizer {fname} must be a number")
            if not np.isfinite(float(val)):
                raise ValueError(f"optimizer {fname} must be finite")
        self.kind = kind
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.eps = float(eps)

    # ---- wire forms ----

    def to_wire(self) -> dict:
        """The JSON form (``PS.Update``'s ``"optimizer"`` field)."""
        if self.kind == "sgdm":
            return {"kind": "sgdm", "lr": self.lr,
                    "momentum": self.momentum}
        return {"kind": "adam", "lr": self.lr, "beta1": self.beta1,
                "beta2": self.beta2, "eps": self.eps}

    @classmethod
    def from_wire(cls, obj) -> "OptimizerSpec":
        """Parse the JSON form (or pass through a spec).  Raises
        ValueError on anything malformed: the service maps that to
        EREQUEST, never EINTERNAL."""
        if isinstance(obj, cls):
            return obj
        if not isinstance(obj, dict):
            raise ValueError('"optimizer" must be an object')
        kind = obj.get("kind")
        if kind not in VALID_KINDS:
            raise ValueError(f'optimizer "kind" must be one of '
                             f"{VALID_KINDS}")
        kw = {}
        for fname in ("lr", "momentum", "beta1", "beta2", "eps"):
            if fname in obj:
                kw[fname] = obj[fname]
        return cls(kind, **kw)

    def to_frame_fields(self) -> dict:
        """The flattened tensorframe form: inline scalar fields
        (``opt_kind`` + floats) next to keys/grads."""
        return {"opt_kind": self.kind, "opt_lr": self.lr,
                "opt_momentum": self.momentum, "opt_beta1": self.beta1,
                "opt_beta2": self.beta2, "opt_eps": self.eps}

    @classmethod
    def from_frame_fields(cls, req: dict) -> Optional["OptimizerSpec"]:
        """Reassemble from a decoded frame; None when the request
        carries no optimizer (no ``opt_kind`` field)."""
        kind = (req or {}).get("opt_kind")
        if kind is None:
            return None
        if not isinstance(kind, str):
            raise ValueError('"opt_kind" must be a string')
        kw = {}
        for fname in ("lr", "momentum", "beta1", "beta2", "eps"):
            v = req.get(f"opt_{fname}")
            if v is not None:
                kw[fname] = v
        return cls(kind, **kw)

    def slot_names(self) -> tuple:
        return ("m",) if self.kind == "sgdm" else ("m", "v", "t")

    def __repr__(self) -> str:
        return f"OptimizerSpec({self.to_wire()})"

    def __eq__(self, other) -> bool:
        return isinstance(other, OptimizerSpec) and \
            self.to_wire() == other.to_wire()


# ---------------------------------------------------------------------------
# the one slot-step math (elementwise, on gathered rows)
# ---------------------------------------------------------------------------

def sgdm_step(rows, m, g_acc, touched, lr, mu):
    """Momentum-SGD step over pre-accumulated per-row gradients.
    Untouched rows keep rows AND m bit for bit."""
    tmask = touched[:, None]
    m_new = torch.where(tmask, mu * m + g_acc, m)
    rows_new = torch.where(tmask, rows - lr * m_new, rows)
    return rows_new, m_new


def adam_step(rows, m, v, t, g_acc, touched, lr, b1, b2, eps):
    """Adam step with PER-ROW step counts (a row's bias correction
    follows how many updates touched THAT row)."""
    tmask = touched[:, None]
    t_new = t + touched.to(t.dtype)
    m_new = torch.where(tmask, b1 * m + (1.0 - b1) * g_acc, m)
    v_new = torch.where(tmask, b2 * v + (1.0 - b2) * g_acc * g_acc, v)
    # untouched rows may still have t == 0; clamp so their (discarded)
    # branch never divides by zero
    ts = torch.clamp(t_new, min=1.0)
    bc1 = 1.0 - torch.pow(b1, ts)
    bc2 = 1.0 - torch.pow(b2, ts)
    step = lr * (m_new / bc1[:, None]) \
        / (torch.sqrt(v_new / bc2[:, None]) + eps)
    rows_new = torch.where(tmask, rows - step, rows)
    return rows_new, m_new, v_new, t_new


# ---------------------------------------------------------------------------
# the fused scatter+step programs, in place
# ---------------------------------------------------------------------------

def _accumulate(rows, keys, grads, valid):
    """Per-key summed gradients and touched flags, gathered back to the
    key positions: duplicates of a key all see the same accumulated
    value (padding entries carry valid=0 and add nothing)."""
    g_acc = torch.zeros_like(rows).index_add_(0, keys,
                                              grads * valid[:, None])
    cnt = torch.zeros((rows.shape[0],), dtype=torch.float32,
                      device=rows.device).index_add_(0, keys, valid)
    return g_acc[keys], cnt[keys] > 0.0


def _f32(*xs):
    """Hyper-parameters rounded to float32, as the reference's traced
    f32 scalars are: every scalar expression of the step then rounds
    once, exactly as float32 arithmetic would."""
    return [float(np.float32(x)) for x in xs]


def _sgdm(rows, m, keys, grads, valid, lr, mu):
    g, touched = _accumulate(rows, keys, grads, valid)
    rk, mk = sgdm_step(rows[keys], m[keys], g, touched, *_f32(lr, mu))
    # duplicate key positions hold identical values, so the order of
    # their writes does not matter
    rows.index_put_((keys,), rk)
    m.index_put_((keys,), mk)
    return rows, m


def _adam(rows, m, v, t, keys, grads, valid, lr, b1, b2, eps):
    g, touched = _accumulate(rows, keys, grads, valid)
    rk, mk, vk, tk = adam_step(rows[keys], m[keys], v[keys], t[keys], g,
                               touched, *_f32(lr, b1, b2, eps))
    rows.index_put_((keys,), rk)
    m.index_put_((keys,), mk)
    v.index_put_((keys,), vk)
    t.index_put_((keys,), tk)
    return rows, m, v, t


_FUSED = {"sgdm": _sgdm, "adam": _adam}


def fused_apply(kind: str):
    """The fused program for ``kind``.

    Signature (sgdm):  (rows, m, keys, grads, valid, lr, mu)
                       -> (rows, m)
    Signature (adam):  (rows, m, v, t, keys, grads, valid,
                        lr, b1, b2, eps) -> (rows, m, v, t)

    Every argument but the floats is a tensor on one device.  ``keys``
    are LOCAL row indices (int64), possibly padded to a bucket;
    ``valid`` is a float32 mask (0.0 on padding) so pad entries neither
    contribute gradient NOR mark row 0 touched.  Duplicate keys
    accumulate first, then each touched row steps once.

    The state tensors (rows + slots) are updated IN PLACE and returned:
    callers keep every other reader of them behind the owner's lock
    (the shard does; :func:`oracle_apply` passes copies).  The step
    math runs on the GATHERED key rows only, so a wave costs the
    gradient scatter plus O(keys) slot math, never a table-sized copy.
    """
    fn = _FUSED.get(kind)
    if fn is None:
        raise ValueError(f"optimizer kind must be one of {VALID_KINDS}")
    return fn


# ---------------------------------------------------------------------------
# the dense single-host oracle (tests; the card check)
# ---------------------------------------------------------------------------

def zero_slots(spec: OptimizerSpec, vocab: int, dim: int) -> dict:
    """Fresh host-side slot state matching what a shard allocates at
    its first optimizer update (all zeros)."""
    slots = {"m": np.zeros((vocab, dim), np.float32)}
    if spec.kind == "adam":
        slots["v"] = np.zeros((vocab, dim), np.float32)
        slots["t"] = np.zeros((vocab,), np.float32)
    return slots


def oracle_apply(table, slots: dict, keys, grads, spec: OptimizerSpec,
                 *, device=None) -> tuple:
    """ONE fused update applied to the DENSE table: the bit-identity
    oracle.  Runs the same fused program the shards run (same scatter,
    same elementwise step, GLOBAL keys, no padding) on copies of the
    inputs on ``device`` (default ``cuda``), so any divergence on a
    sharded path is the sharding's fault, not a reimplementation's.
    Returns (table', slots') as numpy; the inputs are not mutated."""
    dev = resolve_device(device)
    keys = np.asarray(keys, np.int64)
    grads = np.asarray(grads, np.float32)
    if grads.shape != (keys.shape[0], table.shape[1]):
        raise ValueError(f"grads shape {grads.shape} != "
                         f"({keys.shape[0]}, {table.shape[1]})")

    def copy(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    tbl = copy(table)
    sl = {k: copy(v) for k, v in slots.items()}
    k = torch.from_numpy(keys).to(dev)
    g = torch.from_numpy(grads).to(dev)
    valid = torch.ones((keys.shape[0],), dtype=torch.float32, device=dev)
    fn = fused_apply(spec.kind)
    if spec.kind == "sgdm":
        fn(tbl, sl["m"], k, g, valid, spec.lr, spec.momentum)
    else:
        fn(tbl, sl["m"], sl["v"], sl["t"], k, g, valid, spec.lr,
           spec.beta1, spec.beta2, spec.eps)
    return tbl.cpu().numpy(), {n: v.cpu().numpy() for n, v in sl.items()}
