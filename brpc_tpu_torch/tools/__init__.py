"""Console clients (a copy of part of ``brpc_tpu/tools``):

  python -m brpc_tpu_torch.tools.rpc_view      -- fetch a server's
                                                  console pages
  python -m brpc_tpu_torch.tools.parallel_http -- mass concurrent HTTP
                                                  fetcher
"""
