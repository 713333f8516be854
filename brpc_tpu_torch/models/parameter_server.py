"""The flagship parameter-server model (the port of
``brpc_tpu/models/parameter_server.py``): an embedding table, stacked
blocks of attention-flavoured mixing (one head, full softmax over the
sequence) and a gelu MLP, and an output projection over the vocabulary.

Master weights are float32; the forward casts every parameter to
``compute_dtype`` (bfloat16 by default) and computes the scores' softmax
and the loss's log-softmax in float32, with every cast where the
reference puts it.  The backward is autograd.  The large products are
``torch.matmul``: the reference computes them outside any Pallas kernel.

The reference's mesh functions (``make_mesh``, ``param_shardings``,
``data_shardings``, ``make_sharded_train_step``) are the mesh slice,
ROADMAP Queue 1 item 9; ``register_ps_services`` (device services over
the ICI channel) is item 8.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

PARAM_NAMES = ("embed", "w_qk", "w_up", "w_down", "w_out")


@dataclass(frozen=True)
class PSConfig:
    vocab: int = 1024
    d_model: int = 128
    d_ff: int = 256
    n_layers: int = 2       # stacked blocks
    seq: int = 32
    batch: int = 8
    dtype: str = "bfloat16"


def _param_shapes(cfg: PSConfig) -> dict:
    return {
        "embed": (cfg.vocab, cfg.d_model),
        # stacked per-layer weights: the leading axis is the layer
        "w_qk": (cfg.n_layers, cfg.d_model, cfg.d_model),
        "w_up": (cfg.n_layers, cfg.d_model, cfg.d_ff),
        "w_down": (cfg.n_layers, cfg.d_ff, cfg.d_model),
        "w_out": (cfg.d_model, cfg.vocab),
    }


def init_params(cfg: PSConfig, seed: int = 0, device=None) -> dict:
    """float32 master weights, normal * 0.02, drawn in name order from a
    CPU ``torch.Generator`` seeded with ``seed`` and moved to ``device``
    (default ``cuda``).  The draws differ from the reference's
    ``jax.random`` ones; :func:`params_from_jax` carries the reference's
    parameters over instead."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return {name: (torch.randn(shape, generator=gen) * 0.02).to(dev)
            for name, shape in _param_shapes(cfg).items()}


def params_from_jax(params: dict, device=None) -> dict:
    """The JAX package's PS parameters (numpy arrays, or anything
    ``np.asarray`` takes) as this package's: the same names, the stacked
    ``[L, in, out]`` layout, float32 on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    missing = set(PARAM_NAMES) - set(params)
    if missing:
        raise ValueError(f"missing parameters {sorted(missing)}")
    return {name: torch.from_numpy(np.array(params[name], np.float32))
            .to(dev) for name in PARAM_NAMES}


def _block(x, wqk, wup, wdown):
    # attention-flavoured mixing (scores over the sequence) + MLP in the
    # compute dtype; the softmax in float32.  jax.nn.gelu's default is
    # the tanh approximation
    q = x @ wqk
    scores = torch.softmax(
        (q @ x.transpose(-1, -2)).float() / math.sqrt(x.shape[-1]),
        dim=-1).to(x.dtype)
    x = x + scores @ x
    h = F.gelu(x @ wup, approximate="tanh")
    return x + h @ wdown


def _blocks(x, p):
    """The stacked blocks over x [B, S, D], then the output projection:
    logits [B, S, V] in x's dtype."""
    for layer in range(p["w_qk"].shape[0]):
        x = _block(x, p["w_qk"][layer], p["w_up"][layer],
                   p["w_down"][layer])
    return x @ p["w_out"]


def forward_step(params: dict, tokens: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """embed -> the stacked blocks -> logits [B, S, V] in
    ``compute_dtype``; the master params stay float32."""
    p = {k: v.to(compute_dtype) for k, v in params.items()}
    return _blocks(p["embed"][tokens], p)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()


def loss_fn(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Mean next-token negative log-likelihood, log-softmax in float32."""
    return _nll(forward_step(params, tokens, compute_dtype), targets)


def loss_and_grads(params: dict, tokens: torch.Tensor,
                   targets: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> tuple:
    """``(loss, {name: grad})`` of :func:`loss_fn` by autograd, the
    grads float32 like the master weights."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, tokens, targets, compute_dtype)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def train_step(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
               lr: float = 1e-2, compute_dtype=torch.bfloat16) -> tuple:
    """One SGD step: ``(new_params, loss)``; ``params`` are not
    mutated."""
    loss, grads = loss_and_grads(params, tokens, targets, compute_dtype)
    with torch.no_grad():
        new = {k: params[k] - lr * grads[k].to(params[k].dtype)
               for k in params}
    return new, loss


def make_example_batch(cfg: PSConfig, seed: int = 1,
                       device=None) -> tuple:
    """(tokens, targets), each int64 [batch, seq] uniform over the
    vocabulary, drawn from a CPU ``torch.Generator`` seeded with ``seed``
    and moved to ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    shape = (cfg.batch, cfg.seq)
    tokens = torch.randint(0, cfg.vocab, shape, generator=gen)
    targets = torch.randint(0, cfg.vocab, shape, generator=gen)
    return tokens.to(dev), targets.to(dev)
