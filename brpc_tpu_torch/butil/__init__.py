"""Host utilities of the port (copies of ``brpc_tpu/butil`` modules)."""
