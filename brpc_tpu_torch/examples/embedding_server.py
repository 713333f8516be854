"""Train the seed parameter-server model THROUGH the sharded embedding
service.

    python3 -m brpc_tpu_torch.examples.embedding_server            # cuda
    python3 -m brpc_tpu_torch.examples.embedding_server --device cpu

The embedding table lives in N ``EmbeddingShardServer`` partitions
behind the port's own RPC servers; every gather and every sparse
gradient goes through ``PSClient``'s ``PartitionChannel`` fan-out, and
the dense parameters round-trip ``Pull``/``Push``.  The loss goes down,
and the table the shards hold is the one being trained.  It exits
non-zero if the loss did not fall or a lookup saw a stale version.

The counterpart of the JAX package's ``examples/embedding_server.py``.
It runs on the card unless ``--device cpu`` is passed; without a card
and without that flag it raises.
"""
from __future__ import annotations

import argparse

import torch

from .. import rpc
from ..models.parameter_server import (PSConfig, init_params,
                                       make_example_batch)
from ..psserve import (EmbeddingShardServer, PSClient, register_psserve,
                       unregister_psserve)
from ..train.trainer import loss_and_grads_from_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PSConfig(vocab=128, d_model=32, d_ff=64, n_layers=2, seq=16,
                   batch=8)
    params = init_params(cfg, seed=0, device="cpu")
    embed0 = params["embed"].numpy()

    # ---- the service: N shards over loopback RPC servers ----
    servers, svcs, shards = [], [], []
    pc = rpc.PartitionChannel(args.shards)
    for i in range(args.shards):
        sh = EmbeddingShardServer(i, args.shards, cfg.vocab, cfg.d_model,
                                  table=embed0, name="example",
                                  device=args.device)
        shards.append(sh)
        s = rpc.Server()
        svcs.append(register_psserve(s, sh, max_delay_us=500,
                                     name=f"example_{i}"))
        s.start("127.0.0.1", 0)
        servers.append(s)
        pc.add_partition(i, rpc.Channel(f"127.0.0.1:{s.port}",
                                        timeout_ms=10_000))
    cli = PSClient(pc, vocab=cfg.vocab, dim=cfg.d_model)
    dev = shards[0].device
    print(f"serving {cfg.vocab}x{cfg.d_model} embedding over "
          f"{args.shards} shards on {dev} "
          f"({', '.join(str(sh.n_rows) + ' rows' for sh in shards)})")
    try:
        # dense (non-embedding) params live in the service too: push the
        # initial values, pull the working copy (owner = name hash)
        for k, v in params.items():
            if k != "embed":
                cli.push(k, v.numpy())
        dense = {k: torch.from_numpy(cli.pull(k)).to(dev)
                 for k in params if k != "embed"}
        print(f"dense params pushed + pulled through PS.Pull/PS.Push: "
              f"{sorted(dense)}")

        tokens, targets = make_example_batch(cfg, seed=1, device=dev)
        keys = tokens.reshape(-1).cpu().numpy()
        lr = 0.5
        losses = []
        for step in range(args.steps):
            rows = cli.lookup(keys).reshape(cfg.batch, cfg.seq,
                                            cfg.d_model)
            loss, (g_rows, g_dense) = loss_and_grads_from_rows(
                torch.from_numpy(rows).to(dev), dense, targets)
            # sparse scatter-add through PS.Update: duplicate tokens in
            # the batch accumulate, as a dense index_add_ would
            cli.update(keys, (-lr * g_rows).reshape(-1, cfg.d_model)
                       .cpu().numpy())
            dense = {k: v - lr * g_dense[k] for k, v in dense.items()}
            losses.append(float(loss))
            print(f"  step {step}: loss {losses[-1]:.4f}  "
                  f"(shard versions {[sh.version for sh in shards]})")

        # push the trained dense params back so the service owns the
        # whole model again
        for k, v in dense.items():
            cli.push(k, v.cpu().numpy() - cli.pull(k))
        print(f"client stats: {cli.stats()}")
        print(f"shard 0 hot keys: {shards[0].hot_keys(5)}")
    finally:
        for svc in svcs:
            unregister_psserve(svc)
        for s in servers:
            s.stop()
            s.join()
        cli.close()
    ok = losses[-1] < losses[0] and cli.n_stale_reads == 0
    print("OK: the loss fell through the service" if ok else
          f"FAILED: losses {losses}, stale reads {cli.n_stale_reads}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
