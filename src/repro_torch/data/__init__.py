"""Tokenizers and the §7.1 benchmark scenarios (copies of ``repro.data``)."""

from repro_torch.data.scenarios import (
    Scenario,
    ads_scenario,
    all_scenarios,
    emails_scenario,
    reviews_scenario,
)
from repro_torch.data.tokenizer import ByteTokenizer, HashWordTokenizer

__all__ = [
    "Scenario", "ads_scenario", "emails_scenario", "reviews_scenario",
    "all_scenarios", "ByteTokenizer", "HashWordTokenizer",
]
