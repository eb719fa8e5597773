"""Serving on PyTorch: the paged engine, the continuous-batching executor,
the join operators' client, and the data-parallel cluster of engine
replicas behind a router, with fault injection (the exports of
``repro.serve`` that are ported)."""

from repro_torch.serve.engine import (
    DecodeState,
    Engine,
    GenResult,
    PagedDecodeState,
    ScoreRow,
    StopMatcher,
)
from repro_torch.serve.executor import (
    ContinuousBatchingExecutor,
    ExecutorStats,
    ServeHandle,
)
from repro_torch.serve.client import (
    EngineClient,
    EngineEmbedder,
    EngineHandle,
    EngineScoreHandle,
)
from repro_torch.serve.cluster import (
    Cluster,
    ClusterClient,
    ClusterClientHandle,
    ClusterHandle,
    ClusterScoreHandle,
)
from repro_torch.serve.faults import (
    ChaosOracle,
    FaultInjector,
    FaultPlan,
    FaultyEngine,
    ReplicaKilled,
    TransientFault,
    corrupt_response,
    maybe_chaos_engine,
)
from repro_torch.serve.prefix_cache import (
    PagedKVPool,
    PrefixCacheStats,
    RadixPrefixCache,
)
from repro_torch.serve.router import (
    PrefixAffinityRouter,
    RoundRobinRouter,
    Router,
    RouterView,
    affinity_key,
    make_router,
)

__all__ = [
    "ChaosOracle",
    "Cluster",
    "ClusterClient",
    "ClusterClientHandle",
    "ClusterHandle",
    "ClusterScoreHandle",
    "ContinuousBatchingExecutor",
    "DecodeState",
    "Engine",
    "FaultInjector",
    "FaultPlan",
    "FaultyEngine",
    "ReplicaKilled",
    "TransientFault",
    "EngineClient",
    "EngineEmbedder",
    "EngineHandle",
    "EngineScoreHandle",
    "ExecutorStats",
    "GenResult",
    "PagedDecodeState",
    "ScoreRow",
    "PagedKVPool",
    "PrefixAffinityRouter",
    "PrefixCacheStats",
    "RadixPrefixCache",
    "RoundRobinRouter",
    "Router",
    "RouterView",
    "ServeHandle",
    "StopMatcher",
    "affinity_key",
    "corrupt_response",
    "make_router",
    "maybe_chaos_engine",
]
