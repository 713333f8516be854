"""brpc_tpu_torch: the serving path in PyTorch, for NVIDIA Hopper.

The port of ``brpc_tpu``'s device half, sub-package for sub-package:

  ops/paged_attention.py   paged attention over the KV arena (CUDA kernel
                           ``csrc/paged_attention.cu`` + plain version)
  ops/attention.py         flash attention (CUDA kernel
                           ``csrc/flash_attention.cu``) + local attention
  ici/block_pool.py        device block pool (8 KB / 64 KB / 2 MB classes)
  kvcache/                 refcounted pages, radix prefix tree, KV store
  models/runner.py         the transformer runner and its dense oracle
  serving/engine.py        the continuous-batching decode engine
  serving/batcher.py       the dynamic batcher (``Serving.Score``)
  serving/supervisor.py    the engine supervisor: crash hand-off,
                           heartbeat watchdog, overload ladder
  serving/service.py       ``Serving.Generate``/``Score``/``ScoreT``
                           over the RPC front
  rpc/                     the TRPC server, channel and streams, on the
                           same wire as ``brpc_tpu.rpc`` (json, raw and
                           tensorframe bodies)
  bvar/, fault.py, policy/ metrics, fault sites, concurrency limiters
  _core/                   the native host core (``src/cc``), built with
                           ``g++`` into ``build/torch_core/``

It imports ``torch`` and never ``jax`` or ``brpc_tpu``.  Every entry
point runs on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`brpc_tpu_torch.device.resolve_device`); a CUDA tensor always
goes to the hand-written kernel, a CPU tensor to its plain version.
Importing this package builds nothing: the kernels compile with
``nvcc`` at their first launch (``ops/_build.py``), the native core
with ``g++`` at the first server or channel (``_core/build.py``).
"""
from .device import resolve_device  # noqa: F401
