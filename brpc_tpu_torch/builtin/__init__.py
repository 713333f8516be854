"""The builtin HTTP console (a copy of ``brpc_tpu/builtin``): the router
every Server with builtin services installs on its port, the console
pages, the always-on stage-tagged sampler and the pprof encoder."""
