"""Prefix-sharing KV subsystem: a refcounted radix cache over the paged pool.
The port's own copy of `repro/serve/prefix_cache.py`, unchanged.

Real serving traffic is dominated by shared system prompts and multi-turn
resumption: most requests re-prefill a prefix another request already paid
for. This module makes that prefix a *shared allocation* instead of a
recomputation, layered purely on the paper's memory-management operations
(§3.1.3): pool pages are registered once, and the cache only ever moves
page indices and reference counts — fork/copy-on-write as the unified
memory primitive ("Fork is All You Need").

`RadixCache` is a trie keyed on `page_size`-token blocks. Each node owns
exactly one physical page of the `PagedKVPool` (one holder in the pool's
refcount). A request's admission path:

* `match(prompt)` walks the trie for the longest cached prefix — whole
  pages first, then a token-level partial match *into* one more node (the
  boundary). The match is clamped to ``len(prompt) - 1``: at least one
  tail token must run through the model to produce the first logits.
* `lock(match)` adds one holder per matched page (and the boundary page for
  the duration of admission) so eviction cannot free them mid-admission.
* Fully-matched pages are forked **by reference**: the scheduler writes
  them straight into the slot's page table, and decode reads them without
  any copy. The partially-matched boundary page is **copy-on-write**: its
  content is gathered into the tail prefill's dense cache, the tail
  overwrites it from the divergence point on, and the result is committed
  to a freshly drawn page — the cached original is never written.
* On request completion `commit(tokens, pages)` walks the written sequence
  back into the trie: pages whose token block is already cached are
  released (duplicates free immediately; shared pages drop the request's
  holder), and new full pages are *donated* — the request's holder becomes
  the cache's, with no refcount traffic at all.
* Under page pressure `evict(n)` LRU-frees leaf nodes only the cache still
  holds (refcount 1); pages shared with any active request are pinned by
  their extra holders.

Every page the cache owns therefore has refcount >= 1, and the pool-level
invariant "refcount == number of holders" is enforceable property-style
(tests/test_prefix_cache.py).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple


class RadixNode:
    """One cached page: `block` (the page_size tokens it holds) -> `page`
    (the physical pool page). The cache holds one pool reference per node."""

    __slots__ = ("block", "page", "children", "parent", "last_used")

    def __init__(self, block: Tuple[int, ...], page: int, parent: "RadixNode"):
        self.block = block
        self.page = page
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        self.parent = parent
        self.last_used = 0


@dataclasses.dataclass
class PrefixMatch:
    """Longest-cached-prefix result for one prompt.

    `nodes` are fully matched (shared by reference); `boundary` is the node
    a partial token-level match reaches into (its page is the copy-on-write
    source); `matched_len` is the token-level prefix length, always
    ``len(nodes) * page_size + (partial tokens into boundary)`` and always
    < the prompt length."""

    nodes: List[RadixNode]
    boundary: Optional[RadixNode]
    matched_len: int

    @property
    def shared_pages(self) -> List[int]:
        return [n.page for n in self.nodes]

    @property
    def hit(self) -> bool:
        return self.matched_len > 0


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class RadixCache:
    """Refcounted radix cache of KV pages. `pool` is anything exposing the
    `MemorySlotPool` refcount surface (`acquire`/`release`/`refcount`) —
    in the serve path, the `PagedKVPool` the decoder already owns."""

    def __init__(self, pool, page_size: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.pool = pool
        self.page_size = page_size
        self.root = RadixNode((), -1, parent=None)  # sentinel, owns no page
        self._clock = 0
        self._n_nodes = 0
        # admission-level counters (one `note()` per served request)
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.queried_tokens = 0
        self.evictions = 0
        self.donated_pages = 0

    # -- introspection -------------------------------------------------------
    @property
    def cached_pages(self) -> int:
        """Pages the cache currently holds (== live trie nodes)."""
        return self._n_nodes

    @property
    def hit_rate(self) -> float:
        """Token-level hit rate over served requests."""
        return self.hit_tokens / self.queried_tokens if self.queried_tokens else 0.0

    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "queried_tokens": self.queried_tokens,
            "hit_rate": round(self.hit_rate, 4),
            "cached_pages": self._n_nodes,
            "evictions": self.evictions,
            "donated_pages": self.donated_pages,
        }

    def _tick(self, node: RadixNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    # -- lookup --------------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of `tokens`, clamped so >= 1 token remains
        uncached (the model needs a tail to produce next-token logits)."""
        toks = tuple(int(t) for t in tokens)
        limit = len(toks) - 1
        if limit <= 0:
            return PrefixMatch(nodes=[], boundary=None, matched_len=0)
        ps = self.page_size
        path: List[RadixNode] = []
        node = self.root
        i = 0
        while i + ps <= len(toks):
            child = node.children.get(toks[i : i + ps])
            if child is None:
                break
            path.append(child)
            node = child
            i += ps
        # token-level reach into ONE more node (the copy-on-write boundary)
        best_k, best_child = 0, None
        rest = toks[i:]
        if rest:
            for block, child in node.children.items():
                k = _lcp(block, rest)
                if k > best_k:
                    best_k, best_child = k, child
        m = min(i + best_k, limit)
        full, k = m // ps, m % ps
        if full < len(path):
            # the clamp demoted the last fully-matched node to a boundary
            boundary = path[full] if k else None
            path = path[:full]
        else:
            boundary = best_child if k else None
        for n in path:
            self._tick(n)
        if boundary is not None:
            self._tick(boundary)
        return PrefixMatch(nodes=path, boundary=boundary, matched_len=m)

    def note(self, match: Optional[PrefixMatch], n_tokens: int) -> None:
        """Record one *served* request's lookup in the hit-rate counters
        (kept separate from `match` so admission retries under page
        backpressure do not inflate the rate). `match=None` counts as a
        miss (a match demoted under terminal page pressure)."""
        self.lookups += 1
        self.queried_tokens += int(n_tokens)
        if match is not None and match.hit:
            self.hits += 1
            self.hit_tokens += match.matched_len

    # -- pinning across admission --------------------------------------------
    def lock(self, match: PrefixMatch) -> None:
        """Add one holder per matched page (and the boundary source) so the
        admission in flight can never have them evicted underneath it."""
        self.pool.acquire(match.shared_pages)
        if match.boundary is not None:
            self.pool.acquire([match.boundary.page])

    def unlock_boundary(self, match: PrefixMatch) -> None:
        """Drop the boundary hold once its content has been gathered into
        the tail prefill (the copy half of copy-on-write is done)."""
        if match.boundary is not None:
            self.pool.release([match.boundary.page])

    def unlock(self, match: PrefixMatch) -> None:
        """Failure path: drop every hold `lock` took."""
        self.pool.release(match.shared_pages)
        self.unlock_boundary(match)

    # -- completion: return pages through the trie ---------------------------
    def commit(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Walk a finished request's written sequence back into the trie.

        `tokens` is the sequence whose K/V the pages hold (prompt + emitted
        tokens that were fed back); `pages` maps logical page j to the
        physical page the slot used (shared prefix pages first, then drawn
        pages). Every page loses the request's holder: full-page blocks
        already cached are released (shared pages survive via the cache's
        own holder, duplicates free immediately), uncached full pages are
        donated (the request's holder becomes the cache's), and trailing
        pages (the partially-filled boundary and unused growth pages) are
        released outright. Returns the number of pages donated."""
        ps = self.page_size
        n_full = len(tokens) // ps
        donated = 0
        node = self.root
        for j in range(n_full):
            block = tuple(int(t) for t in tokens[j * ps : (j + 1) * ps])
            page = int(pages[j])
            child = node.children.get(block)
            if child is None:
                child = RadixNode(block, page, parent=node)
                node.children[block] = child
                self._n_nodes += 1
                donated += 1
            else:
                # cached already (it may even be `page` itself, shared at
                # admission): drop the request's holder, keep the cache's
                self.pool.release([page])
            self._tick(child)
            node = child
        self.pool.release(list(pages[n_full:]))
        self.donated_pages += donated
        return donated

    # -- eviction -------------------------------------------------------------
    def _leaves(self):
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node

    def _remove(self, node: RadixNode) -> None:
        del node.parent.children[node.block]
        self.pool.release([node.page])
        self._n_nodes -= 1
        self.evictions += 1

    def evict(self, n_pages: int) -> int:
        """Free up to `n_pages` pages by LRU-evicting leaf nodes the cache
        is the only holder of (refcount 1). Pages shared with any active
        request are pinned by their extra holders. Returns pages freed.

        One trie walk total: the leaf set is collected once and maintained
        as evictions expose parents, so the cost is O(cached + evicted log
        evicted), not a full rescan per freed page."""
        heap = [(leaf.last_used, id(leaf), leaf) for leaf in self._leaves()]
        heapq.heapify(heap)
        freed = 0
        # single-threaded: no match/commit can interleave, so heap entries
        # never go stale — each node is pushed at most once (leaves up
        # front, parents when their last child is removed)
        while freed < n_pages and heap:
            _, _, leaf = heapq.heappop(heap)
            if self.pool.refcount(leaf.page) != 1:
                continue  # an active request still reads this page
            parent = leaf.parent
            self._remove(leaf)
            freed += 1
            if parent is not self.root and not parent.children:
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        return freed

    def reset(self) -> None:
        """Drop every cached page (benchmark pass isolation; also the
        clean-shutdown path). Refuses nothing: pages shared with active
        requests keep their other holders and only lose the cache's."""
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.pool.release([node.page])
        self.root.children.clear()
        self._n_nodes = 0
