"""The model runner interface, the step-function adapter, the
transformer served over the paged KV cache, its cache-less dense oracle,
and the deployment registry (the model plane's manifest).

The runner imports torch and loads at first use, so the registry (host
code, read by the router tier) imports without it.
"""
from .registry import (  # noqa: F401
    DeploymentRegistry, ModelDeployment, global_registry,
)

_RUNNER = {
    "DEFAULT_PREFILL_BUCKETS", "LegacyFnRunner", "ModelRunner",
    "TransformerConfig", "TransformerRunner", "dense_forward",
    "dense_generate", "init_runner_params", "as_runner", "make_store_for",
    "params_from_jax", "run_prefill",
}


def __getattr__(name):
    if name not in _RUNNER:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    from . import runner
    return getattr(runner, name)
