"""The one request generator that every serving mix's data file feeds.

Extends the port's `serve/workload.py::synthetic_requests` (prompt and
output lengths over ranges, token ids uniform over [1, vocab)) so that the
seed changes the tokens and not the work: a mix names a `clients`-long list
of (prompt, output) sizes, spread evenly over its two ranges, and every
round hands each client one of them by a permutation drawn from the mix's
own `pairing_seed`. In a closed loop the order of the sizes sets when
requests finish together and so how long admissions queue behind each
other: a permutation drawn from the run's seed moved the p90 of the time to
the first token by 20 % between seeds, against 2 % between two runs of one
seed. So every seed serves the same sizes in the same order, and the seed
draws the token ids of each request, from (seed, client, round), so any
request can be made on its own, in any order.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _spread(lo: int, hi: int, n: int) -> List[int]:
    """n whole numbers in [lo, hi], at the midpoints of n equal parts."""
    return [lo + int((i + 0.5) * (hi - lo + 1) / n) for i in range(n)]


def size_table(mix: dict) -> List[Tuple[int, int]]:
    """The (prompt tokens, new tokens) pairs of one round."""
    n = mix["clients"]
    prompts = _spread(*mix["prompt_tokens"], n)
    news = _spread(*mix["new_tokens"], n)
    order = np.random.default_rng(mix["pairing_seed"]).permutation(n)
    return [(prompts[i], news[int(order[i])]) for i in range(n)]


def _key(seed: int) -> int:
    return int(seed) % 2**64


class ClosedLoopRequests:
    """Request (client, round) of a mix: its sizes and its prompt."""

    def __init__(self, mix: dict, seed: int, vocab_size: int):
        self.mix, self.seed, self.vocab = mix, _key(seed), vocab_size
        self.table = size_table(mix)
        self._perms = {}

    def sizes(self, client: int, rnd: int) -> Tuple[int, int]:
        if rnd not in self._perms:
            rng = np.random.default_rng([self.mix["pairing_seed"], 1, rnd])
            self._perms[rnd] = rng.permutation(len(self.table))
        return self.table[int(self._perms[rnd][client])]

    def prompt(self, client: int, rnd: int) -> np.ndarray:
        plen, _ = self.sizes(client, rnd)
        rng = np.random.default_rng([self.seed, 2, client, rnd])
        return rng.integers(1, self.vocab, (plen,), dtype=np.int32)
