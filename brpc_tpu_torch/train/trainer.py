"""DataParallelTrainer: N workers training THROUGH the PS wire (the port
of ``brpc_tpu/train/trainer.py``).

Every gather rides ``PS.Lookup`` (batched, tensorframe wire), every
sparse gradient rides ``PS.Update`` carrying an
:class:`~brpc_tpu_torch.train.OptimizerSpec` so the scatter AND the
momentum/Adam slot step run fused ON the shard (mode="wire"), dense
parameters live in the service (``Pull``/``Push`` per step), and a
periodic Pull-based eval shows the loss decreasing through the service:
the model the trainer ever sees is the one the shards hold.  The loss
and its gradients run by autograd on the trainer's device (``cuda``
unless the caller passes ``device="cpu"``).

Worker coordination is BOUNDED STALENESS: worker w may start step s
only while ``s - min(steps completed by any worker) <= max_lag``;
``max_lag=0`` is synchronous lockstep.  The gate is a condition
variable over the progress vector, so a dead worker is excused (marked
complete) rather than wedging the fleet.

Update waves heal like any PS client: a failed wave re-issues with its
``update_token``, so partitions that already applied DEDUP.  Fault site
``fault.UPDATE_WAVE`` injects wave failures.

``mode="pull_compute_push"`` is the baseline the fused path is measured
against: optimizer slots live AT THE TRAINER (host numpy), each wave
computes the slot step on the host and ships the resulting row DELTAS
as a plain scatter-add.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import errors, fault
from ..butil.lockprof import InstrumentedLock
from ..bvar import Adder
from ..device import resolve_device
from ..models.parameter_server import (PSConfig, _blocks, _nll,
                                       init_params, make_example_batch)
from ..psserve import PSClient
from .optimizer import OptimizerSpec

WAVES = Adder("train_waves")
WAVE_RETRIES = Adder("train_wave_retries")
EVALS = Adder("train_evals")

MODES = ("wire", "pull_compute_push")


def loss_from_rows(rows: torch.Tensor, dense: dict,
                   targets: torch.Tensor) -> torch.Tensor:
    """The PS model's loss over GATHERED embedding rows [B, S, D] and the
    dense params, in bfloat16 with a float32 log-softmax."""
    d = {k: v.to(torch.bfloat16) for k, v in dense.items()}
    return _nll(_blocks(rows.to(torch.bfloat16), d), targets)


def loss_and_grads_from_rows(rows: torch.Tensor, dense: dict,
                             targets: torch.Tensor) -> tuple:
    """``(loss, (g_rows, g_dense))`` of :func:`loss_from_rows` by
    autograd, every gradient float32."""
    r = rows.detach().requires_grad_(True)
    dl = {k: v.detach().requires_grad_(True) for k, v in dense.items()}
    loss = loss_from_rows(r, dl, targets)
    grads = torch.autograd.grad(loss, [r, *dl.values()])
    return loss.detach(), (grads[0], dict(zip(dl, grads[1:])))


class DataParallelTrainer:
    """N worker threads pulling minibatches, computing grads locally,
    and streaming PS.Update waves under bounded-staleness gating."""

    def __init__(self, client, cfg=None, *, n_workers: int = 2,
                 steps: int = 8,
                 optimizer: Optional[OptimizerSpec] = None,
                 mode: str = "wire", max_lag: int = 1,
                 sync: bool = False, lr_dense: float = 0.5,
                 eval_every: int = 0, wave_max_retry: int = 4,
                 retry_backoff_s: float = 0.05, arbiter=None,
                 seed: int = 0, name: str = "trainer", device=None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if arbiter is not None:
            raise ValueError("arbiter= (TrafficArbiter) is not ported yet:"
                             " ROADMAP Queue 1 item 7, second half")
        self.device = resolve_device(device)
        self.client = client
        self.cfg = cfg or PSConfig(
            vocab=client.vocab, d_model=client.dim,
            d_ff=2 * client.dim, n_layers=2, seq=8, batch=4)
        if self.cfg.vocab != client.vocab or \
                self.cfg.d_model != client.dim:
            raise ValueError(
                f"cfg ({self.cfg.vocab}x{self.cfg.d_model}) does not "
                f"match the client's table "
                f"({client.vocab}x{client.dim})")
        self.n_workers = int(n_workers)
        self.steps = int(steps)
        self.optimizer = optimizer or OptimizerSpec(
            "sgdm", lr=0.5, momentum=0.5)
        self.mode = mode
        self.max_lag = 0 if sync else int(max_lag)
        self.sync = bool(sync) or self.max_lag == 0
        self.lr_dense = float(lr_dense)
        self.eval_every = int(eval_every)
        self.wave_max_retry = int(wave_max_retry)
        self.retry_backoff_s = float(retry_backoff_s)
        self.seed = int(seed)
        self.name = str(name)

        # bounded-staleness gate state
        self._cv = threading.Condition()
        self._progress = [0] * self.n_workers
        self._stop = False
        self._errors: list = []
        self._mu = InstrumentedLock("train.trainer")
        self.n_waves = 0
        self.n_wave_retries = 0
        self.n_io_retries = 0
        self.loss_history: list = []
        self.step_losses: list = []
        self._worker_clients: list = []

        # pull-compute-push mode's HOST-side slots (the baseline the
        # fused co-located path is compared with)
        self._host_slots: dict = {}
        self._dense_names: list = []
        # fixed held-out eval batch (its own seed, never trained on)
        self._eval_tokens, self._eval_targets = make_example_batch(
            self.cfg, seed=self.seed + 104729, device=self.device)

    # ---- model seeding (the fleet holds the model; seed it first) ----

    @staticmethod
    def model_init(cfg, seed: int = 0) -> tuple:
        """(embed0, dense0) as numpy for seeding the shard fleet: build
        shards with ``table=embed0`` and let :meth:`seed_dense` push
        dense."""
        params = init_params(cfg, seed=seed, device="cpu")
        embed = params["embed"].numpy()
        dense = {k: v.numpy() for k, v in params.items() if k != "embed"}
        return embed, dense

    def seed_dense(self, dense: dict) -> None:
        """Push the dense (non-embedding) params into the service: after
        this the trainer has NO local copy of the model."""
        for k, v in dense.items():
            self.client.push(k, np.asarray(v, np.float32))
        self._dense_names = sorted(dense)

    def _clone_client(self, w: int):
        """One PSClient per worker: read-your-writes is a PER-CLIENT
        contract, so workers sharing one client would count each other's
        in-flight writes as stale reads.  update_ids come from a
        module-global sequence, so clones never collide."""
        c = self.client
        return PSClient(c._pc, vocab=c.vocab, dim=c.dim,
                        n_shards=c.n_shards, timeout_ms=c.timeout_ms,
                        max_retry=c.max_retry, serializer=c.serializer,
                        ici=c._ici_mode, table_name=c.table_name,
                        name=f"{c.name}_w{w}")

    # ---- bounded-staleness gate ----

    def _gate(self, w: int, s: int) -> None:
        with self._cv:
            while not self._stop and \
                    s - min(self._progress) > self.max_lag:
                self._cv.wait(0.2)

    def _advance(self, w: int) -> None:
        with self._cv:
            self._progress[w] += 1
            self._cv.notify_all()

    def _excuse(self, w: int) -> None:
        """A dead worker must not wedge the gate: mark it complete."""
        with self._cv:
            self._progress[w] = self.steps
            self._cv.notify_all()

    # ---- the update wave ----

    def _io_retry(self, fn):
        """Bounded retry with backoff for the worker's NON-wave I/O
        (pull/lookup/push): reads are idempotent and pushes carry their
        own update_id through the partition channel's retry, so a replay
        here never double-applies."""
        for attempt in range(self.wave_max_retry + 1):
            try:
                return fn()
            except errors.RpcError:
                with self._mu:
                    self.n_io_retries += 1
                if attempt >= self.wave_max_retry:
                    raise
                time.sleep(self.retry_backoff_s * (attempt + 1))

    def _send_wave(self, cli, w: int, s: int, keys: np.ndarray,
                   grads: np.ndarray) -> None:
        """One PS.Update wave with partition-retry healing: a failed
        fan-out replays the SAME logical update via its update_token, so
        partitions that already applied dedup instead of double-stepping
        momentum."""
        tok = None
        for attempt in range(self.wave_max_retry + 1):
            try:
                if fault.ENABLED and fault.hit(
                        fault.UPDATE_WAVE, worker=w, step=s,
                        attempt=attempt) is not None:
                    raise errors.RpcError(
                        errors.EINTERNAL,
                        "injected train.update_wave fault")
                if self.mode == "wire":
                    cli.update(keys, grads, update_token=tok,
                               optimizer=self.optimizer)
                else:
                    self._pull_compute_push(cli, keys, grads, tok)
                with self._mu:
                    self.n_waves += 1
                WAVES.add(1)
                return
            except errors.RpcError as e:
                # keep (or adopt) the token: partitions that acked the
                # failed attempt will dedup the replay
                tok = getattr(e, "update_token", tok)
                with self._mu:
                    self.n_wave_retries += 1
                WAVE_RETRIES.add(1)
                if attempt >= self.wave_max_retry:
                    raise
                time.sleep(self.retry_backoff_s * (attempt + 1))

    def _pull_compute_push(self, cli, keys, grads, tok) -> None:
        """The baseline wave: slot math at the HOST, deltas on the
        wire.  Duplicate keys accumulate first (what the fused path's
        scatter does), then one plain scatter-add update ships the
        stepped rows' deltas."""
        spec = self.optimizer
        uniq, inv = np.unique(keys, return_inverse=True)
        g_acc = np.zeros((uniq.shape[0], self.client.dim), np.float32)
        np.add.at(g_acc, inv, grads)
        with self._mu:
            hs = self._host_slots
            if "m" not in hs:
                hs["m"] = np.zeros((self.client.vocab, self.client.dim),
                                   np.float32)
                if spec.kind == "adam":
                    hs["v"] = np.zeros_like(hs["m"])
                    hs["t"] = np.zeros((self.client.vocab,), np.float32)
            if spec.kind == "sgdm":
                m = spec.momentum * hs["m"][uniq] + g_acc
                hs["m"][uniq] = m
                delta = -spec.lr * m
            else:
                t = hs["t"][uniq] + 1.0
                m = spec.beta1 * hs["m"][uniq] + \
                    (1.0 - spec.beta1) * g_acc
                v = spec.beta2 * hs["v"][uniq] + \
                    (1.0 - spec.beta2) * g_acc * g_acc
                hs["t"][uniq], hs["m"][uniq], hs["v"][uniq] = t, m, v
                delta = -spec.lr * (m / (1.0 - spec.beta1 ** t[:, None])) \
                    / (np.sqrt(v / (1.0 - spec.beta2 ** t[:, None]))
                       + spec.eps)
        cli.update(uniq, delta.astype(np.float32), update_token=tok)

    # ---- eval (Pull-based: the model scored is the SERVICE's) ----

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

    def eval_loss(self) -> float:
        dense = {k: self._on_device(self.client.pull(k))
                 for k in self._dense_names}
        keys = self._eval_tokens.reshape(-1).cpu().numpy()
        rows = self.client.lookup(keys).reshape(
            self.cfg.batch, self.cfg.seq, self.cfg.d_model)
        with torch.no_grad():
            loss = float(loss_from_rows(self._on_device(rows), dense,
                                        self._eval_targets))
        with self._mu:
            self.loss_history.append(loss)
        EVALS.add(1)
        return loss

    # ---- the worker loop ----

    def _worker(self, w: int) -> None:
        cli = self._worker_clients[w]
        try:
            for s in range(self.steps):
                self._gate(w, s)
                if self._stop:
                    return
                tokens, targets = make_example_batch(
                    self.cfg, seed=self.seed * 7919 + w * 104729 + s,
                    device=self.device)
                keys = tokens.reshape(-1).cpu().numpy()
                dense = {k: self._on_device(self._io_retry(
                    lambda k=k: cli.pull(k)))
                    for k in self._dense_names}
                rows = self._io_retry(lambda: cli.lookup(keys)).reshape(
                    self.cfg.batch, self.cfg.seq, self.cfg.d_model)
                loss, (g_rows, g_dense) = loss_and_grads_from_rows(
                    self._on_device(rows), dense, targets)
                self._send_wave(
                    cli, w, s, keys,
                    g_rows.reshape(-1, self.cfg.d_model).cpu().numpy())
                for k in self._dense_names:
                    delta = (-self.lr_dense * g_dense[k]).cpu().numpy()
                    self._io_retry(lambda k=k, d=delta: cli.push(k, d))
                with self._mu:
                    self.step_losses.append((w, s, float(loss)))
                self._advance(w)
                if self.eval_every and w == 0 and \
                        (s + 1) % self.eval_every == 0:
                    self.eval_loss()
        except BaseException as e:
            # recorded and re-raised by run() once every worker stopped
            with self._mu:
                self._errors.append((w, e))
            self._excuse(w)

    def run(self) -> dict:
        """Train to completion; returns the report.  Raises the first
        worker error AFTER every worker has stopped (the gate excuses
        dead workers, so the rest drain normally)."""
        if not self._dense_names:
            raise RuntimeError("call seed_dense() before run(): the "
                               "service must hold the dense params")
        t0 = time.monotonic()
        self.eval_loss()        # the "before" point of the loss proof
        self._worker_clients = [self._clone_client(w)
                                for w in range(self.n_workers)]
        threads = [threading.Thread(
            target=self._worker, args=(w,),
            name=f"{self.name}_w{w}", daemon=True)
            for w in range(self.n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.eval_loss()
        elapsed = time.monotonic() - t0
        with self._mu:
            if self._errors:
                raise self._errors[0][1]
            return {
                "mode": self.mode,
                "optimizer": self.optimizer.to_wire(),
                "workers": self.n_workers,
                "steps": self.steps,
                "steps_done": int(sum(self._progress)),
                "waves": self.n_waves,
                "wave_retries": self.n_wave_retries,
                "io_retries": self.n_io_retries,
                "max_lag": self.max_lag,
                "sync": self.sync,
                "elapsed_s": elapsed,
                "updates_per_s": self.n_waves / max(elapsed, 1e-9),
                "loss_first": self.loss_history[0],
                "loss_final": self.loss_history[-1],
                "loss_history": list(self.loss_history),
                "stale_reads": self.stale_reads(),
            }

    def stale_reads(self) -> int:
        """Read-your-writes violations summed across the shared client
        and every per-worker clone."""
        clis = {id(self.client): self.client}
        for c in self._worker_clients:
            clis[id(c)] = c
        return sum(c.n_stale_reads for c in clis.values())

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()

    def stats(self) -> dict:
        with self._mu:
            return {
                "name": self.name,
                "mode": self.mode,
                "device": str(self.device),
                "waves": self.n_waves,
                "wave_retries": self.n_wave_retries,
                "io_retries": self.n_io_retries,
                "progress": list(self._progress),
                "evals": len(self.loss_history),
            }
