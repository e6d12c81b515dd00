"""Synthetic serving workloads: requests with varied prompt/decode lengths
(the traffic shape continuous batching exists for), shared-system-prompt
traffic and multi-turn resumption (the shapes prefix caching exists for).
Port of `repro/serve/workload.py`: the same numpy RNG calls in the same
order, so a seed gives the reference's requests, and the same wire body."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .scheduler import Request


def synthetic_requests(
    vocab_size: int,
    n: int,
    *,
    prompt_range: Tuple[int, int],
    steps_range: Tuple[int, int],
    seed: int = 0,
    rid_prefix: str = "req",
) -> List[Request]:
    """`n` requests with prompt lengths drawn from [lo, hi) of
    `prompt_range` and decode budgets from [lo, hi) of `steps_range`."""
    rng = np.random.default_rng(seed)
    requests = []
    for i in range(n):
        plen = int(rng.integers(*prompt_range))
        steps = int(rng.integers(*steps_range))
        prompt = rng.integers(1, vocab_size, (plen,), dtype=np.int32).tolist()
        requests.append(Request(rid=f"{rid_prefix}-{i}", prompt=prompt, max_new_tokens=steps))
    return requests


def shared_prefix_requests(
    vocab_size: int,
    n: int,
    *,
    prefix_len: int,
    prefix_share: float = 0.5,
    n_prefixes: int = 1,
    tail_range: Tuple[int, int] = (2, 8),
    steps_range: Tuple[int, int] = (4, 16),
    seed: int = 0,
    rid_prefix: str = "sp",
) -> List[Request]:
    """Shared-system-prompt traffic: the shape prefix caching exists for.

    A `prefix_share` fraction of the `n` requests opens with one of
    `n_prefixes` fixed `prefix_len`-token system prompts followed by a
    unique tail drawn from `tail_range`; the rest are fully unique prompts
    of the same total length (so both populations cost the same without a
    cache). Shared requests get rids ``{rid_prefix}-s{i}``, unique ones
    ``{rid_prefix}-u{i}`` — benchmarks split hit/miss TTFT on that marker.
    The interleaving is shuffled deterministically so shared requests are
    spread through the arrival order rather than front-loaded."""
    if not 0.0 <= prefix_share <= 1.0:
        raise ValueError(f"prefix_share must be in [0, 1], got {prefix_share}")
    rng = np.random.default_rng(seed)
    prefixes = [
        rng.integers(1, vocab_size, (prefix_len,), dtype=np.int32).tolist()
        for _ in range(max(1, n_prefixes))
    ]
    n_shared = round(n * prefix_share)
    kinds = ["s"] * n_shared + ["u"] * (n - n_shared)
    rng.shuffle(kinds)
    requests = []
    for i, kind in enumerate(kinds):
        tail_len = int(rng.integers(*tail_range))
        steps = int(rng.integers(*steps_range))
        tail = rng.integers(1, vocab_size, (tail_len,), dtype=np.int32).tolist()
        if kind == "s":
            prompt = prefixes[i % len(prefixes)] + tail
        else:
            head = rng.integers(1, vocab_size, (prefix_len,), dtype=np.int32).tolist()
            prompt = head + tail
        requests.append(
            Request(rid=f"{rid_prefix}-{kind}{i}", prompt=prompt, max_new_tokens=steps)
        )
    return requests


def multi_turn_requests(
    vocab_size: int,
    n_conversations: int,
    turns: int,
    *,
    first_prompt_range: Tuple[int, int] = (8, 16),
    followup_range: Tuple[int, int] = (2, 6),
    steps_range: Tuple[int, int] = (4, 12),
    seed: int = 0,
    rid_prefix: str = "mt",
) -> List[List[Request]]:
    """Multi-turn resumption traffic: each conversation's turn t+1 prompt is
    a *placeholder* continuation — the caller must extend it with the whole
    turn-t exchange (its prompt plus the full generated reply, then the new
    followup text) before submitting; use `resume_prompt`, which assembles
    exactly that. Returned as per-conversation lists of requests whose
    prompts hold only the NEW text of each turn."""
    rng = np.random.default_rng(seed)
    conversations = []
    for c in range(n_conversations):
        turns_list = []
        for t in range(turns):
            lo, hi = first_prompt_range if t == 0 else followup_range
            plen = int(rng.integers(lo, hi))
            steps = int(rng.integers(*steps_range))
            prompt = rng.integers(1, vocab_size, (plen,), dtype=np.int32).tolist()
            turns_list.append(
                Request(rid=f"{rid_prefix}-{c}-{t}", prompt=prompt, max_new_tokens=steps)
            )
        conversations.append(turns_list)
    return conversations


def resume_prompt(prior_prompt: List[int], prior_tokens: List[int], followup: List[int]) -> List[int]:
    """The turn-t+1 prompt of a conversation: the whole turn-t exchange
    (prompt plus the full generated reply) plus the new user text. The KV
    cache holds everything up to the reply's final token, so a prefix cache
    turns nearly this entire history into a page-table fork."""
    return list(prior_prompt) + list(prior_tokens) + list(followup)


def to_wire(request: Request) -> dict:
    """The ChannelServer JSON request body for `request`."""
    body = {
        "id": request.rid,
        "prompt": list(request.prompt),
        "steps": request.max_new_tokens,
    }
    if request.eos_id is not None:
        body["eos"] = request.eos_id
    return body
