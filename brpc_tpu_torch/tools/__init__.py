"""Console clients and load tools (a copy of part of ``brpc_tpu/tools``):

  python -m brpc_tpu_torch.tools.rpc_view      -- fetch a server's
                                                  console pages
  python -m brpc_tpu_torch.tools.parallel_http -- mass concurrent HTTP
                                                  fetcher
  python -m brpc_tpu_torch.tools.rpc_press     -- press generations
                                                  through a router in
                                                  front of N in-process
                                                  replicas (--cluster N)
"""
