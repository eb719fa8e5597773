"""Paper core: the block join (Alg. 2) and adaptive join (Alg. 3) with
their cost model, batch-size optimizer, prompts, accounting and the
rule oracle — copies of the JAX-free modules of ``repro.core``."""

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
from repro_torch.core.cost_model import JoinStats, ModelParams
from repro_torch.core.join_types import JoinResult, Overflow
from repro_torch.core.llm_client import LLMClient, LLMResponse
from repro_torch.core.oracle import OracleLLM

__all__ = [
    "GPT4_PRICING", "Ledger", "Pricing", "Usage", "count_tokens",
    "simple_tokenize", "adaptive_join", "generate_statistics", "BatchPlan",
    "optimal_batch_sizes", "plan", "block_join", "JoinStats", "ModelParams",
    "JoinResult", "Overflow", "LLMClient", "LLMResponse", "OracleLLM",
]
