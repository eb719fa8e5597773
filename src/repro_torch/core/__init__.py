"""Paper core: the tuple (Alg. 1), block (Alg. 2) and adaptive (Alg. 3)
joins with their cost model, batch-size optimizer, prompts, accounting
and the rule oracle; the scored tuple join and confidence cascade; the
embedding-join and LOTUS baselines, the embedding-prefiltered join and
the §7.2 simulator.  Copies of the JAX-free modules of ``repro.core``,
except ``prefilter_join``, whose candidates come from the port's top-k
kernel."""

from repro_torch.core.accounting import (
    GPT4_PRICING,
    Ledger,
    Pricing,
    Usage,
    count_tokens,
    simple_tokenize,
)
from repro_torch.core.adaptive_join import adaptive_join, generate_statistics
from repro_torch.core.batch_opt import BatchPlan, optimal_batch_sizes, plan
from repro_torch.core.block_join import block_join
from repro_torch.core.cascade import (
    cascade_tuple_join,
    margin_confidence,
    score_pairs,
    scored_decision,
)
from repro_torch.core.cost_model import JoinStats, ModelParams
from repro_torch.core.embedding_join import HashEmbedder, embedding_join
from repro_torch.core.join_types import JoinResult, Overflow
from repro_torch.core.llm_client import (
    Embedder,
    LLMClient,
    LLMResponse,
    ScoreHandle,
    ScoreResponse,
)
from repro_torch.core.lotus_join import lotus_join
from repro_torch.core.oracle import OracleLLM
from repro_torch.core.prefilter_join import prefilter_join, topk_candidates
from repro_torch.core.prompts import (
    NO_ANSWER,
    SCORE_CHOICES,
    YES_ANSWER,
    classify_yes_no,
    parse_yes_no,
)
from repro_torch.core.simulator import SimParams, SimulatedLLM, synthetic_table
from repro_torch.core.tuple_join import tuple_join

__all__ = [
    "GPT4_PRICING", "Ledger", "Pricing", "Usage", "count_tokens",
    "simple_tokenize", "adaptive_join", "generate_statistics", "BatchPlan",
    "optimal_batch_sizes", "plan", "block_join", "JoinStats", "ModelParams",
    "JoinResult", "Overflow", "LLMClient", "LLMResponse", "OracleLLM",
    "cascade_tuple_join", "margin_confidence", "score_pairs",
    "scored_decision", "HashEmbedder", "embedding_join", "Embedder",
    "ScoreHandle", "ScoreResponse", "prefilter_join", "topk_candidates",
    "NO_ANSWER", "SCORE_CHOICES", "YES_ANSWER", "classify_yes_no",
    "parse_yes_no", "tuple_join", "lotus_join", "SimParams", "SimulatedLLM",
    "synthetic_table",
]
