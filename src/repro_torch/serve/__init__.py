"""Serving on PyTorch: the paged engine, the continuous-batching executor
and the join operators' client (the default path of ``repro.serve``)."""

from repro_torch.serve.client import EngineClient, EngineHandle
from repro_torch.serve.engine import Engine, GenResult, StopMatcher
from repro_torch.serve.executor import (ContinuousBatchingExecutor,
                                        ExecutorStats, ServeHandle)
from repro_torch.serve.prefix_cache import PagedKVPool, RadixPrefixCache

__all__ = [
    "ContinuousBatchingExecutor", "Engine", "EngineClient", "EngineHandle",
    "ExecutorStats", "GenResult", "PagedKVPool", "RadixPrefixCache",
    "ServeHandle", "StopMatcher",
]
