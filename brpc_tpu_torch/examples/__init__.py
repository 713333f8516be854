"""Runnable examples of the port (``python3 -m
brpc_tpu_torch.examples.<name>``)."""
