"""The model runner interface, the step-function adapter, the
transformer served over the paged KV cache, and its cache-less dense
oracle."""
from .runner import (  # noqa: F401
    DEFAULT_PREFILL_BUCKETS, LegacyFnRunner, ModelRunner, TransformerConfig,
    TransformerRunner, dense_forward, dense_generate, init_runner_params,
    as_runner, make_store_for, params_from_jax, run_prefill,
)
