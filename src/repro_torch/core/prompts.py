"""Prompt templates for the join operators (paper Figures 1 and 2).

Both render (join side) and parse (oracle side, answer-extraction side)
functions live here so the two directions are tested against each other.
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.core.accounting import count_tokens

FINISHED = "Finished"

# ---------------------------------------------------------------------------
# Figure 1 — tuple nested loops join prompt
# ---------------------------------------------------------------------------

TUPLE_TEMPLATE = (
    'Is the following true ("Yes"/"No"): {j}?\n'
    "Text 1: {t1}\n"
    "Text 2: {t2}\n"
    "Answer:"
)


def tuple_prompt(t1: str, t2: str, j: str) -> str:
    """Function TuplePrompt in Algorithm 1."""
    return TUPLE_TEMPLATE.format(j=j, t1=t1, t2=t2)


_TUPLE_RE = re.compile(
    r'Is the following true \("Yes"/"No"\): (?P<j>.*?)\?\n'
    r"Text 1: (?P<t1>.*?)\n"
    r"Text 2: (?P<t2>.*?)\n"
    r"Answer:\Z",
    re.DOTALL,
)


def parse_tuple_prompt(prompt: str) -> Optional[Tuple[str, str, str]]:
    """Inverse of :func:`tuple_prompt` → ``(t1, t2, j)`` or ``None``."""
    m = _TUPLE_RE.match(prompt)
    if not m:
        return None
    return m.group("t1"), m.group("t2"), m.group("j")


#: The golden-pinned answer convention shared by the tuple-join template
#: ("Yes"/"No" in :data:`TUPLE_TEMPLATE`), the ``OracleLLM`` answer path,
#: and the prefill-only scoring path: :data:`SCORE_CHOICES` is the ordered
#: pair of candidate continuations a scorer ranks, index 0 = positive.
YES_ANSWER = "Yes"
NO_ANSWER = "No"
SCORE_CHOICES = (YES_ANSWER, NO_ANSWER)

_FIRST_WORD_RE = re.compile(r"[a-z]+")


def classify_yes_no(answer: str) -> Optional[bool]:
    """Classify an answer as yes (True), no (False), or unrecognized (None).

    Only an *exact* first word ``yes``/``no`` (case-insensitive, ignoring
    leading whitespace/punctuation) counts — ``"Yes."`` and ``"no, because"``
    parse, but ``"yesterday"``, truncated ``"Y"``, and empty answers do not.
    """
    m = _FIRST_WORD_RE.search(answer.lower())
    word = m.group(0) if m else ""
    if word == "yes":
        return True
    if word == "no":
        return False
    return None


def parse_yes_no(answer: str, default: bool = False) -> bool:
    """Interpret the answer of a tuple-join invocation.

    Malformed answers fall back to ``default`` (deterministically No: a
    verification that cannot be read must not emit a join pair) instead of
    the old lenient ``"yes"``-prefix match, which mapped e.g.
    ``"yesterday"`` to a join hit.
    """
    got = classify_yes_no(answer)
    return default if got is None else got


# ---------------------------------------------------------------------------
# Figure 2 — block nested loops join prompt
# ---------------------------------------------------------------------------

BLOCK_HEADER = (
    "Find indexes x,y where x is the number of an entry in collection 1 "
    "and y the number of an entry in collection 2 such that {j} "
    "(make sure to catch all pairs!)!\n"
    "Separate index pairs by semicolons.\n"
    'Write "' + FINISHED + '" after the last pair!\n'
)


def block_prompt_shared_prefix(batch1: Sequence[str], j: str) -> str:
    """The **canonical prefix** of a block prompt: instruction header +
    left-table block, byte-identical across every right block paired with
    the same ``batch1``.

    This is the unit of KV prefix reuse (DESIGN.md §9): ``block_prompt``
    is *defined* as ``shared_prefix + variable_suffix``, and the golden
    tests pin the byte split — any layout drift that moves right-block
    content before left-block content silently zeroes the serving stack's
    prefix-cache hit rate.
    """
    lines = [BLOCK_HEADER.format(j=j), "Text Collection 1:"]
    for i, t in enumerate(batch1, start=1):
        lines.append(f"{i}. {t}")
    return "\n".join(lines) + "\n"


#: First bytes of :func:`block_prompt_variable_suffix` — the marker at
#: which every block prompt splits into shared prefix and per-call
#: suffix.  :func:`split_shared_prefix` (and the serving cluster's
#: prefix-affinity router) keys on everything before it.
VARIABLE_SUFFIX_MARKER = "Text Collection 2:"


def block_prompt_variable_suffix(batch2: Sequence[str]) -> str:
    """The per-call remainder of a block prompt: right-table block +
    answer cue.  Always rendered *after* the shared prefix."""
    lines = [VARIABLE_SUFFIX_MARKER]
    for i, t in enumerate(batch2, start=1):
        lines.append(f"{i}. {t}")
    lines.append("Index pairs:")
    return "\n".join(lines)


def split_shared_prefix(prompt: str) -> Tuple[str, str]:
    """Split any prompt at the canonical prefix/suffix boundary.

    For a block prompt this recovers exactly the
    ``(block_prompt_shared_prefix, block_prompt_variable_suffix)`` byte
    split (golden-pinned); prompts without the marker are all prefix —
    each distinct prompt is its own reuse unit.  This is the keying
    function of the serving cluster's prefix-affinity router: prompts
    with equal first components share their KV prefix, so routing them
    to the same engine replica preserves the radix cache's hit rate.
    """
    idx = prompt.find(VARIABLE_SUFFIX_MARKER)
    if idx <= 0:
        return prompt, ""
    return prompt[:idx], prompt[idx:]


def block_prompt(batch1: Sequence[str], batch2: Sequence[str], j: str) -> str:
    """Function BlockPrompt in Algorithm 2 (paper Figure 2).

    Entries are 1-indexed, matching the paper's template.  The layout is
    prefix-canonical: tuple-independent header first, then the left block
    (constant across an outer-loop iteration), then the right block —
    consecutive prompts over the same left block share
    ``block_prompt_shared_prefix`` byte-for-byte.
    """
    return (block_prompt_shared_prefix(batch1, j)
            + block_prompt_variable_suffix(batch2))


_COLLECTION_RE = re.compile(
    r"Text Collection 1:\n(?P<c1>.*?)\nText Collection 2:\n(?P<c2>.*?)\nIndex pairs:\Z",
    re.DOTALL,
)
_ENTRY_RE = re.compile(r"^(\d+)\. (.*)$")
_HEADER_J_RE = re.compile(
    r"entry in collection 2 such that (?P<j>.*?) \(make sure to catch all pairs!\)!",
    re.DOTALL,
)


def _parse_collection(block: str) -> List[str]:
    """Parse numbered entries; multi-line tuples are folded into the entry."""
    entries: List[str] = []
    for line in block.split("\n"):
        m = _ENTRY_RE.match(line)
        if m and int(m.group(1)) == len(entries) + 1:
            entries.append(m.group(2))
        elif entries:
            entries[-1] += "\n" + line
        # else: stray prefix text — ignore
    return entries


def parse_block_prompt(prompt: str) -> Optional[Tuple[List[str], List[str], str]]:
    """Inverse of :func:`block_prompt` → ``(batch1, batch2, j)`` or ``None``."""
    mj = _HEADER_J_RE.search(prompt)
    mc = _COLLECTION_RE.search(prompt)
    if not (mj and mc):
        return None
    return _parse_collection(mc.group("c1")), _parse_collection(mc.group("c2")), mj.group("j")


def render_index_pairs(pairs: Sequence[Tuple[int, int]], finished: bool = True) -> str:
    """Render the model answer: ``x,y; x,y; ... Finished`` (1-indexed)."""
    body = "; ".join(f"{x},{y}" for x, y in pairs)
    if finished:
        return (body + "; " if body else "") + FINISHED
    return body


_PAIR_RE = re.compile(r"(\d+)\s*,\s*(\d+)")


class ParsedPairs(NamedTuple):
    """Result of :func:`parse_index_pairs`.

    ``dropped`` counts malformed ``;``-separated segments — non-empty
    answer segments that are neither an index pair nor the sentinel.
    A well-behaved model emits zero; a chaos-corrupted completion shows
    up here instead of silently vanishing (DESIGN.md §16)."""

    pairs: List[Tuple[int, int]]
    finished: bool
    dropped: int


def parse_index_pairs(answer: str) -> ParsedPairs:
    """Extract ``(pairs, finished, dropped)`` from a block-join answer.

    ``finished`` is True iff the answer's final word is the sentinel
    (Algorithm 2 line: ``if A[-1] != Finished then return <Overflow>``).
    Robust to truncated trailing pairs (a pair cut mid-digits is dropped —
    ExtractTuples in the paper) and to garbage segments, both counted in
    ``dropped``.
    """
    finished = answer.rstrip().endswith(FINISHED)
    pairs: List[Tuple[int, int]] = []
    dropped = 0
    for seg in answer.split(";"):
        seg = seg.strip()
        if not seg:
            continue
        found = _PAIR_RE.findall(seg)
        if found:
            pairs.extend((int(a), int(b)) for a, b in found)
        elif seg != FINISHED:
            dropped += 1
    return ParsedPairs(pairs, finished, dropped)


def static_prompt_tokens(j: str) -> int:
    """``p`` — tokens of the tuple-independent prompt parts (block template).

    Measured by rendering the template with empty collections, matching how
    GenerateStatistics (Algorithm 3) derives it.
    """
    return count_tokens(block_prompt([], [], j))


def tuple_static_prompt_tokens(j: str) -> int:
    """``p`` for the tuple-join template (Figure 1)."""
    return count_tokens(tuple_prompt("", "", j))
