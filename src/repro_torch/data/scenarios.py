"""The paper's three benchmark scenarios (§7.1, Table 2), with ground truth.

Data is *generated* (the paper's repo likewise ships data generation
scripts).  Each scenario provides both the textual tables and a
deterministic text-level predicate — the latter drives the rule-based
oracle LLM so quality metrics (Fig. 7) are measurable without GPT-4.

Target statistics (paper Table 2):

    |                    | Emails | Reviews | Ads  |
    | Tbl 1 rows         | 100    | 50      | 16   |
    | Tbl 2 rows         | 10     | 50      | 16   |
    | Tbl 1 avg tokens   | 14     | 98      | 11   |
    | Tbl 2 avg tokens   | 15     | 101     | 10   |
    | selectivity        | 0.01   | 0.5     | 0.06 |
"""

from __future__ import annotations

import dataclasses
import random
import re
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.accounting import count_tokens


@dataclasses.dataclass
class Scenario:
    name: str
    r1: List[str]
    r2: List[str]
    condition: str  # the natural-language join predicate j
    predicate: Callable[[str, str], bool]  # ground truth over (t1 ∈ R1, t2 ∈ R2)
    truth: Set[Tuple[int, int]]

    @property
    def selectivity(self) -> float:
        return len(self.truth) / (len(self.r1) * len(self.r2))

    def stats_row(self) -> Dict[str, float]:
        import statistics as st

        return {
            "tbl1_rows": len(self.r1),
            "tbl2_rows": len(self.r2),
            "tbl1_avg_tokens": round(st.fmean(count_tokens(t) for t in self.r1), 1),
            "tbl2_avg_tokens": round(st.fmean(count_tokens(t) for t in self.r2), 1),
            "selectivity": round(self.selectivity, 4),
        }


def _truth_set(scenario_pred, r1, r2) -> Set[Tuple[int, int]]:
    return {
        (i, k)
        for i, a in enumerate(r1)
        for k, b in enumerate(r2)
        if scenario_pred(a, b)
    }


# ---------------------------------------------------------------------------
# Emails — "the two texts contradict each other" (Enron-style, Example 1.1)
# ---------------------------------------------------------------------------

_NAMES = ["Alice", "Bob", "Carol", "David", "Emma",
          "Frank", "Grace", "Henry", "Irene", "Jack"]

_MONTHS = ["January", "February", "March", "April", "May", "June", "July",
           "August", "September", "October", "November", "December"]
_MONTH_NUM = {m: i + 1 for i, m in enumerate(_MONTHS)}

#: All statements claim first knowledge in February 2022.
_CLAIM = ("February", 2022)

_EMAIL_RE = re.compile(
    r"I first told (?P<name>\w+) about the losses in (?P<month>\w+) (?P<year>\d{4})"
)
_STMT_RE = re.compile(
    r"^(?P<name>\w+): .*first heard about the losses in (?P<month>\w+) (?P<year>\d{4})"
)


def _emails_contradict(email: str, statement: str) -> bool:
    """Contradiction: the email shows [Name] was told about the losses
    *before* the date [Name] claims to have first heard of them."""
    me = _EMAIL_RE.search(email)
    ms = _STMT_RE.search(statement)
    if not (me and ms):
        return False
    if me.group("name") != ms.group("name"):
        return False
    e_key = (int(me.group("year")), _MONTH_NUM.get(me.group("month"), 0))
    s_key = (int(ms.group("year")), _MONTH_NUM.get(ms.group("month"), 0))
    return e_key < s_key


def emails_scenario(
    n_emails: int = 100, n_statements: int = 10, n_contradictions: int = 10,
    seed: int = 7,
) -> Scenario:
    rng = random.Random(seed)
    statements = [
        f"{name}: I swear that I first heard about the losses in "
        f"{_CLAIM[0]} {_CLAIM[1]}." for name in _NAMES[:n_statements]
    ]
    early = [("October", 2021), ("November", 2021), ("December", 2021),
             ("January", 2022)]
    late = [("March", 2022), ("April", 2022), ("May", 2022), ("June", 2022),
            ("July", 2022), ("August", 2022)]
    contradict_idx = set(rng.sample(range(n_emails), n_contradictions))
    emails = []
    for i in range(n_emails):
        name = _NAMES[rng.randrange(n_statements)]
        month, year = rng.choice(early if i in contradict_idx else late)
        emails.append(
            f"I remember that I first told {name} about the losses in "
            f"{month} {year}."
        )
    sc = Scenario(
        name="emails",
        r1=emails,
        r2=statements,
        condition="the two texts contradict each other",
        predicate=_emails_contradict,
        truth=set(),
    )
    sc.truth = _truth_set(_emails_contradict, sc.r1, sc.r2)
    return sc


# ---------------------------------------------------------------------------
# Reviews — "both reviews are positive or both are negative"
# ---------------------------------------------------------------------------

_POS_WORDS = ["brilliant", "moving", "masterful", "delightful", "gripping",
              "superb", "heartfelt", "stunning", "flawless", "memorable"]
_NEG_WORDS = ["dull", "tedious", "clumsy", "forgettable", "incoherent",
              "lifeless", "grating", "shallow", "bloated", "painful"]
_GENRES = ["drama", "thriller", "comedy", "western", "documentary", "musical"]
_SUBJECTS = ["the lead actor", "the screenplay", "the pacing", "the score",
             "the cinematography", "the ending", "the dialogue", "the villain"]


def _review_sentiment(text: str) -> Optional[bool]:
    pos = sum(text.count(w) for w in _POS_WORDS)
    neg = sum(text.count(w) for w in _NEG_WORDS)
    if pos == neg:
        return None
    return pos > neg


def _reviews_match(t1: str, t2: str) -> bool:
    a, b = _review_sentiment(t1), _review_sentiment(t2)
    return a is not None and b is not None and a == b


def _make_review(rng: random.Random, positive: bool, target_tokens: int) -> str:
    lex = _POS_WORDS if positive else _NEG_WORDS
    genre = rng.choice(_GENRES)
    parts = [
        f"I watched this {genre} last weekend and I have rarely felt this "
        f"strongly about a film of its kind."
    ]
    while count_tokens(" ".join(parts)) < target_tokens - 12:
        subj = rng.choice(_SUBJECTS)
        word = rng.choice(lex)
        verdict = "works wonderfully" if positive else "falls completely flat"
        parts.append(f"In particular, {subj} is {word} and {verdict}.")
    closing = (
        "Overall I would happily recommend it to anyone."
        if positive
        else "Overall I cannot recommend it to anyone."
    )
    parts.append(closing)
    return " ".join(parts)


def reviews_scenario(n1: int = 50, n2: int = 50, seed: int = 11) -> Scenario:
    rng = random.Random(seed)
    # "The join matches the first 50 reviews with the second 50 reviews"
    # 25/25 positive/negative per side → selectivity 0.5.
    def make_side(n: int) -> List[str]:
        labels = [True] * (n // 2) + [False] * (n - n // 2)
        rng.shuffle(labels)
        return [_make_review(rng, lab, target_tokens=rng.randint(92, 106))
                for lab in labels]

    r1, r2 = make_side(n1), make_side(n2)
    sc = Scenario(
        name="reviews",
        r1=r1,
        r2=r2,
        condition="both reviews are positive or both are negative",
        predicate=_reviews_match,
        truth=set(),
    )
    sc.truth = _truth_set(_reviews_match, r1, r2)
    return sc


# ---------------------------------------------------------------------------
# Ads — "pairs of ads matching requests" (Example 1.2)
# ---------------------------------------------------------------------------

_MATERIALS = ["made of solid oak wood", "made of brushed steel",
              "made of tempered glass", "made of reclaimed pine"]
_COLORS = ["painted blue", "painted white", "left natural", "stained dark"]

_AD_RE = re.compile(r"(?:Offering|Searching) table that is (?P<mat>made of [\w ]+?|left [\w ]+?) and (?P<col>painted \w+|left natural|stained \w+)\.")


def _ads_match(ad: str, search: str) -> bool:
    ma, ms = _AD_RE.match(ad), _AD_RE.match(search)
    if not (ma and ms):
        return False
    return ma.group("mat") == ms.group("mat") and ma.group("col") == ms.group("col")


def ads_scenario(seed: int = 13) -> Scenario:
    rng = random.Random(seed)
    combos = [(m, c) for m in _MATERIALS for c in _COLORS]  # 16 combos
    ads = [f"Offering table that is {m} and {c}." for m, c in combos]
    searches_combos = combos[:]
    rng.shuffle(searches_combos)
    searches = [f"Searching table that is {m} and {c}." for m, c in searches_combos]
    sc = Scenario(
        name="ads",
        r1=ads,
        r2=searches,
        condition="the offered table matches the table being searched for",
        predicate=_ads_match,
        truth=set(),
    )
    sc.truth = _truth_set(_ads_match, ads, searches)
    return sc


# ---------------------------------------------------------------------------
# Marketplace — scaled planted-match scenario for the prefilter join
# ---------------------------------------------------------------------------
#
# The paper's three scenarios top out at 100×10 rows, where the full cross
# product is trivially affordable.  The embedding-prefiltered join
# (DESIGN.md §14) targets the regime where it is not: 10⁴×10³ rows is a
# 10⁷-pair cross product.  Every row belongs to a planted category
# (product × city); a pair matches iff the categories agree.  Ground truth
# comes from the planted assignment — O(|truth|), never the brute-force
# O(n1·n2) sweep of ``_truth_set``.

_MARKET_PRODUCTS = [
    "oak dining table", "leather office chair", "cast iron skillet",
    "mechanical keyboard", "road bike frame", "acoustic guitar",
    "espresso machine", "standing desk", "wool area rug",
    "vintage turntable", "ceramic flower pot", "canvas wall tent",
    "carbon fiber tripod", "velvet reading sofa", "copper stock pot",
    "walnut bookshelf", "granite mortar set", "linen bed frame",
    "bamboo cutting board", "steel tool cabinet", "marble chess set",
    "rattan patio chair", "cedar storage chest", "brass desk lamp",
    "slate serving board",
]
_MARKET_CITIES = [
    "Berlin", "Lisbon", "Oslo", "Madrid", "Vienna",
    "Prague", "Dublin", "Athens", "Warsaw", "Zurich",
]


def _market_fields(text: str) -> Optional[Tuple[str, str]]:
    """Parse (product, city) out of an offer or a request; None otherwise."""
    if text.startswith("Offering: "):
        head, sep, tail = text.partition(" available in ")
        if not sep:
            return None
        return head[len("Offering: "):], tail.partition(".")[0]
    if text.startswith("Request: looking for "):
        head, sep, tail = text.partition(" in ")
        if not sep:
            return None
        return head[len("Request: looking for "):], tail.partition(".")[0]
    return None


def _market_match(offer: str, request: str) -> bool:
    fo, fr = _market_fields(offer), _market_fields(request)
    return fo is not None and fr is not None and fo == fr


def marketplace_scenario(
    n1: int = 10_000, n2: int = 1_000,
    n_products: int = 25, n_cities: int = 10, seed: int = 17,
) -> Scenario:
    """Offers × requests with ``n_products · n_cities`` planted categories.

    Defaults give 250 categories, ~40 offers and ~4 requests per category,
    selectivity ≈ 1/250 — dense enough per category that a small top-k
    candidate set can reach full recall, sparse enough globally that
    verifying the cross product is 10⁷ model passes.
    """
    if not 1 <= n_products <= len(_MARKET_PRODUCTS):
        raise ValueError(f"n_products must be in [1, {len(_MARKET_PRODUCTS)}]")
    if not 1 <= n_cities <= len(_MARKET_CITIES):
        raise ValueError(f"n_cities must be in [1, {len(_MARKET_CITIES)}]")
    rng = random.Random(seed)
    combos = [(p, c) for p in _MARKET_PRODUCTS[:n_products]
              for c in _MARKET_CITIES[:n_cities]]
    cat1 = [rng.randrange(len(combos)) for _ in range(n1)]
    cat2 = [rng.randrange(len(combos)) for _ in range(n2)]
    r1 = [
        f"Offering: {combos[c][0]} available in {combos[c][1]}. "
        f"Contact seller {i}." for i, c in enumerate(cat1)
    ]
    r2 = [
        f"Request: looking for {combos[c][0]} in {combos[c][1]}. "
        f"Buyer {k}." for k, c in enumerate(cat2)
    ]
    by_cat2: Dict[int, List[int]] = {}
    for k, c in enumerate(cat2):
        by_cat2.setdefault(c, []).append(k)
    truth = {(i, k) for i, c in enumerate(cat1) for k in by_cat2.get(c, ())}
    return Scenario(
        name="marketplace",
        r1=r1,
        r2=r2,
        condition="the offered item and city match the request",
        predicate=_market_match,
        truth=truth,
    )


def all_scenarios() -> List[Scenario]:
    return [emails_scenario(), reviews_scenario(), ads_scenario()]
