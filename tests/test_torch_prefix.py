"""The port's prefix cache against the JAX reference.

* The refcounted pool and radix-cache invariants of `tests/test_prefix_cache.py`
  (`TestRefcountedSlotPool`, `TestRadixCacheSemantics` and the refcount
  property test), each case run over the reference's and the port's
  `MemorySlotPool` / `RadixCache`; the same page lifecycle on both
  `PagedKVPool`s gives the same accounting.
* `gather_paged_caches`, `tail_prefill_attention` and `lm_prefix_prefill` on
  REDUCED gemma3-1b (fp32, the reference's weights bridged in) against the
  reference, within 1e-4.
* The `tests/test_serve.py::TestPrefixCacheScheduler` workloads (shared
  system prompts, an identical resubmission, a resumed conversation,
  eviction under page pressure, the demote-to-miss admission) through the
  port's scheduler token-identical to the reference's scheduler, with equal
  cache counters and every page back.
* The workload generators equal to the reference's, and the serving CLI
  with ``--prefix-cache`` on the CPU.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import definitions as jdefs  # noqa: E402
from repro.core import managers as jmanagers  # noqa: E402
from repro.core.runtime import Runtime as JaxRuntime  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import kv_pool as jkv_pool  # noqa: E402
from repro.serve import prefix_cache as jprefix  # noqa: E402
from repro.serve import workload as jworkload  # noqa: E402
from repro.serve.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import definitions as tdefs  # noqa: E402
from repro_torch.core import managers as tmanagers  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.serve import kv_pool as tkv_pool  # noqa: E402
from repro_torch.serve import prefix_cache as tprefix  # noqa: E402
from repro_torch.serve import workload as tworkload  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request  # noqa: E402

ATOL = 1e-4

IMPLS = {
    "reference": (jmanagers.MemorySlotPool, jprefix.RadixCache, jdefs.LifetimeError),
    "port": (tmanagers.MemorySlotPool, tprefix.RadixCache, tdefs.LifetimeError),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


# ---------------------------------------------------------------------------
# refcounted pool and radix cache (tests/test_prefix_cache.py), both packages
# ---------------------------------------------------------------------------


def _drawn(pool, n):
    assert pool.reserve(n)
    return pool.draw(n)


def _serve_miss(cache, pool, tokens):
    """One request that misses entirely: draw pages for every full block,
    then commit (donating them to the cache)."""
    n = len(tokens) // cache.page_size
    assert pool.reserve(n)
    pages = pool.draw(n)
    cache.commit(tokens, pages)
    return pages


class TestRefcountedSlotPool:
    def test_double_free_raises_lifetime_error(self, impl):
        Pool, _, LifetimeError = impl
        pool = Pool(64, 4)
        [b] = _drawn(pool, 1)
        pool.free([b])
        with pytest.raises(LifetimeError, match="double free"):
            pool.free([b])
        assert len(set(_drawn(pool, 4))) == 4

    def test_free_of_never_drawn_block_raises(self, impl):
        Pool, _, LifetimeError = impl
        with pytest.raises(LifetimeError, match="double free"):
            Pool(64, 4).free([2])

    def test_acquire_release_refcount_cycle(self, impl):
        Pool, _, _ = impl
        pool = Pool(64, 4)
        [b] = _drawn(pool, 1)
        assert pool.refcount(b) == 1
        pool.acquire([b])
        pool.share([b])
        assert pool.refcount(b) == 3
        pool.release([b])
        pool.release([b])
        assert pool.refcount(b) == 1 and pool.blocks_used == 1
        pool.release([b])
        assert pool.refcount(b) == 0 and pool.blocks_used == 0

    def test_acquire_of_free_block_raises(self, impl):
        Pool, _, LifetimeError = impl
        with pytest.raises(LifetimeError, match="not allocated"):
            Pool(64, 4).acquire([1])

    def test_shared_block_survives_one_release(self, impl):
        Pool, _, _ = impl
        pool = Pool(64, 2)
        [b] = _drawn(pool, 1)
        pool.acquire([b])
        pool.release([b])
        assert pool.blocks_free == 1
        assert b not in _drawn(pool, 1)


class TestRadixCacheSemantics:
    def test_miss_then_full_page_match(self, impl):
        Pool, Cache, _ = impl
        pool = Pool(1, 16)
        cache = Cache(pool, page_size=4)
        seq = [1, 2, 3, 4, 5, 6, 7, 8]
        pages = _serve_miss(cache, pool, seq)
        assert cache.cached_pages == 2
        m = cache.match(seq + [9, 9])
        assert m.matched_len == 8 and [n.page for n in m.nodes] == pages
        assert m.boundary is None

    def test_boundary_partial_match(self, impl):
        Pool, Cache, _ = impl
        pool = Pool(1, 16)
        cache = Cache(pool, page_size=4)
        _serve_miss(cache, pool, [1, 2, 3, 4, 5, 6, 7, 8])
        m = cache.match([1, 2, 3, 4, 5, 6, 99, 99])
        assert m.matched_len == 6
        assert len(m.nodes) == 1 and m.boundary is not None
        assert m.boundary.block == (5, 6, 7, 8)

    def test_full_prompt_match_is_clamped(self, impl):
        Pool, Cache, _ = impl
        pool = Pool(1, 16)
        cache = Cache(pool, page_size=4)
        seq = [1, 2, 3, 4, 5, 6, 7, 8]
        _serve_miss(cache, pool, seq)
        m = cache.match(seq)
        assert m.matched_len == 7
        assert len(m.nodes) == 1 and m.boundary is not None

    def test_tiny_prompt_never_matches_everything(self, impl):
        Pool, Cache, _ = impl
        pool = Pool(1, 8)
        cache = Cache(pool, page_size=4)
        _serve_miss(cache, pool, [1, 2, 3, 4])
        assert cache.match([7]).matched_len == 0
        m = cache.match([1, 2])
        assert m.matched_len == 1 and m.boundary is not None

    def test_commit_releases_duplicates(self, impl):
        Pool, Cache, _ = impl
        pool = Pool(1, 16)
        cache = Cache(pool, page_size=4)
        seq = [1, 2, 3, 4, 5, 6, 7, 8]
        _serve_miss(cache, pool, seq)
        used = pool.blocks_used
        _serve_miss(cache, pool, seq)
        assert pool.blocks_used == used and cache.cached_pages == 2

    def test_shared_page_refcounts_and_commit(self, impl):
        Pool, Cache, _ = impl
        pool = Pool(1, 16)
        cache = Cache(pool, page_size=4)
        base = [1, 2, 3, 4, 5, 6, 7, 8]
        _serve_miss(cache, pool, base)
        prompt = base + [9, 9]
        m = cache.match(prompt)
        cache.lock(m)
        assert all(pool.refcount(p) == 2 for p in m.shared_pages)
        cache.unlock_boundary(m)
        drawn = _drawn(pool, 2)
        donated = cache.commit(prompt + [11, 12, 13, 14], m.shared_pages + drawn)
        assert donated == 1
        assert all(pool.refcount(p) == 1 for p in m.shared_pages)
        assert cache.cached_pages == 3 and pool.blocks_used == cache.cached_pages

    def test_evict_frees_lru_leaves_only(self, impl):
        Pool, Cache, _ = impl
        pool = Pool(1, 32)
        cache = Cache(pool, page_size=4)
        _serve_miss(cache, pool, [1, 2, 3, 4, 5, 6, 7, 8])
        _serve_miss(cache, pool, [9, 9, 9, 9])
        assert cache.evict(1) == 1
        assert cache.match([1, 2, 3, 4, 9]).matched_len == 4
        assert cache.cached_pages == 2

    def test_evict_skips_pages_shared_with_active_requests(self, impl):
        Pool, Cache, _ = impl
        pool = Pool(1, 8)
        cache = Cache(pool, page_size=4)
        _serve_miss(cache, pool, [1, 2, 3, 4])
        m = cache.match([1, 2, 3, 4, 5])
        cache.lock(m)
        assert cache.evict(1) == 0
        cache.unlock(m)
        assert cache.evict(1) == 1 and pool.blocks_used == 0

    def test_reset_releases_everything(self, impl):
        Pool, Cache, _ = impl
        pool = Pool(1, 16)
        cache = Cache(pool, page_size=4)
        _serve_miss(cache, pool, [1, 2, 3, 4, 5, 6, 7, 8])
        cache.reset()
        assert cache.cached_pages == 0 and pool.blocks_used == 0

    def test_note_tracks_hit_rate(self, impl):
        Pool, Cache, _ = impl
        pool = Pool(1, 16)
        cache = Cache(pool, page_size=4)
        _serve_miss(cache, pool, [1, 2, 3, 4])
        cache.note(cache.match([1, 2, 3, 4, 5, 6]), 6)
        cache.note(cache.match([7, 7, 7, 7]), 4)
        st = cache.stats()
        assert (st["lookups"], st["hits"], st["hit_tokens"], st["queried_tokens"]) == (2, 1, 4, 10)
        assert st["hit_rate"] == 0.4


def _schedule(Pool, Cache, seed, n_blocks, steps):
    """A seeded admit/finish/evict schedule (tests/test_prefix_cache.py's
    property test) checking refcount == holders after every step; returns
    the trace of (op, pages used, cached pages)."""
    rng = random.Random(seed)
    ps = 4
    pool = Pool(1, n_blocks)
    cache = Cache(pool, page_size=ps)
    active, trace = [], []

    def invariants():
        stack, nodes = list(cache.root.children.values()), []
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            nodes.append(n)
        node_pages = [n.page for n in nodes]
        assert len(set(node_pages)) == len(node_pages) == cache.cached_pages
        sharers, owned = {}, set()
        for req in active:
            for p in req["shared"]:
                sharers[p] = sharers.get(p, 0) + 1
            owned.update(req["owned"])
        for n in nodes:
            assert pool.refcount(n.page) == 1 + sharers.get(n.page, 0)
        assert all(pool.refcount(p) == 1 for p in owned)
        assert pool.blocks_used == len(set(node_pages) | owned)

    for _ in range(steps):
        op = rng.choice(("admit", "admit", "finish", "evict"))
        if op == "admit":
            length = rng.randint(2, 14)
            toks = [rng.randint(0, 2) for _ in range(length)]
            m = cache.match(toks)
            need = -(-length // ps) - len(m.nodes)
            cache.lock(m)
            if not pool.reserve(need):
                cache.evict(need - pool.blocks_available)
                if not pool.reserve(need):
                    cache.unlock(m)
                    continue
            owned = pool.draw(need)
            cache.unlock_boundary(m)
            cache.note(m, length)
            active.append({"tokens": toks, "shared": m.shared_pages, "owned": owned})
        elif op == "finish" and active:
            req = active.pop(rng.randrange(len(active)))
            cache.commit(req["tokens"], req["shared"] + req["owned"])
        elif op == "evict":
            cache.evict(rng.randint(1, 3))
        invariants()
        trace.append((op, pool.blocks_used, cache.cached_pages))
    while active:
        req = active.pop()
        cache.commit(req["tokens"], req["shared"] + req["owned"])
        invariants()
    cache.evict(n_blocks)
    assert pool.blocks_used == cache.cached_pages == 0
    return trace, cache.stats()


@pytest.mark.parametrize("seed,n_blocks,steps", [(0, 8, 40), (1, 16, 60), (7, 40, 60)])
def test_refcount_schedule_holds_invariants_as_reference(seed, n_blocks, steps):
    """The seeded schedule keeps refcount == holders in both packages, step
    for step the same pages and counters."""
    got = _schedule(*IMPLS["port"][:2], seed, n_blocks, steps)
    want = _schedule(*IMPLS["reference"][:2], seed, n_blocks, steps)
    assert got == want


# ---------------------------------------------------------------------------
# the paged pool's refcount surface
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundle():
    jcfg = jax_get_config("gemma3-1b", reduced=True)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("gemma3-1b", reduced=True)
    tparams = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, (jcfg, jmodel, jparams), (build(cfg), tparams)


@pytest.fixture(scope="module")
def runtime():
    with Runtime("torchdev", device="cpu") as rt:
        yield rt


def _pool_lifecycle(pool, Cache):
    """Reserve, draw, share, commit through a radix cache, evict: the
    accounting after each step."""
    out = []

    def snap():
        out.append((pool.pages_free, pool.pages_used, pool.pages_available, pool.capacity,
                    pool.can_admit(5), pool.can_admit(pool.capacity + 1)))

    cache = Cache(pool, page_size=8)
    assert pool.reserve(3)
    snap()
    pages = pool.draw(3)
    pool.acquire(pages[:1])
    pool.share(pages[:1])
    out.append([pool.refcount(p) for p in pages])
    pool.release(pages[:1])
    pool.release(pages[:1])
    cache.commit(list(range(24)), pages)
    snap()
    m = cache.match(list(range(20)))
    cache.lock(m)
    out.append((m.matched_len, [pool.refcount(p) for p in m.shared_pages]))
    cache.unlock(m)
    out.append(cache.evict(2))
    snap()
    cache.reset()
    snap()
    return out


def test_kv_pool_refcount_surface_matches_reference(bundle, runtime):
    cfg, (jcfg, jmodel, _), (model, _) = bundle
    kw = dict(max_slots=2, max_len=32, page_size=8, shared=True)
    tpool = tkv_pool.PagedKVPool(runtime, model, model.paged_ops.layout(**kw), device="cpu")
    with JaxRuntime("jaxdev") as jrt:
        jpool = jkv_pool.PagedKVPool(jrt, jmodel, jmodel.paged_ops.layout(**kw))
    assert tpool.layout.shared and tpool.capacity == jpool.capacity
    assert _pool_lifecycle(tpool, tprefix.RadixCache) == \
        _pool_lifecycle(jpool, jprefix.RadixCache)


# ---------------------------------------------------------------------------
# the tail prefill against a gathered prefix
# ---------------------------------------------------------------------------


def _random_pools(cfg, layout, rng):
    """Per-layer (k, v) pools of random content, as numpy, and both
    packages' pool trees over them."""
    shape = (len(ttf.serving_windows(cfg)), layout.num_pages, layout.page_size,
             cfg.num_kv_heads, cfg.resolved_head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tpools = [(torch.from_numpy(k[i].copy()), torch.from_numpy(v[i].copy()))
              for i in range(shape[0])]
    unit_len, n_units, n_tail = ttf.unit_structure(cfg)
    order = np.arange(shape[0])
    units = order[: unit_len * n_units].reshape(n_units, unit_len)
    jpools = {"units": {
        "k_local": jnp.asarray(k[units[:, :-1]]), "v_local": jnp.asarray(v[units[:, :-1]]),
        "k_global": jnp.asarray(k[units[:, -1]]), "v_global": jnp.asarray(v[units[:, -1]])}}
    if n_tail:
        jpools["tail"] = {"k": jnp.asarray(k[order[-n_tail:]]),
                          "v": jnp.asarray(v[order[-n_tail:]])}
    return tpools, jpools


def _layers_of(cfg, jcaches):
    """The reference's unit/tail cache tree as per-layer (k, v), in layer
    order (numpy)."""
    unit_len, n_units, n_tail = ttf.unit_structure(cfg)
    out = []
    u = jcaches["units"]
    for i in range(n_units):
        for j in range(unit_len - 1):
            out.append((np.asarray(u["k_local"][i, j]), np.asarray(u["v_local"][i, j])))
        out.append((np.asarray(u["k_global"][i]), np.asarray(u["v_global"][i])))
    for t in range(n_tail):
        out.append((np.asarray(jcaches["tail"]["k"][t]), np.asarray(jcaches["tail"]["v"][t])))
    return out


@pytest.mark.parametrize("offset,tail", [(19, 5), (0, 12), (24, 1)],
                         ids=["boundary", "miss", "page-aligned"])
def test_lm_prefix_prefill_matches_reference(bundle, offset, tail):
    cfg, (jcfg, _, jparams), (_, tparams) = bundle
    kw = dict(max_slots=2, max_len=48, page_size=8, shared=True)
    jlayout, tlayout = jtf.make_paged_layout(jcfg, **kw), tattn.paged_layout(cfg, **kw)
    rng = np.random.default_rng(offset + tail)
    tpools, jpools = _random_pools(cfg, tlayout, rng)
    row = np.zeros((tlayout.n_pages_seq,), np.int32)
    row[: -(-offset // 8)] = rng.permutation(np.arange(1, tlayout.num_pages))[: -(-offset // 8)]
    tokens = rng.integers(1, cfg.vocab_size, (1, tail)).astype(np.int32)

    before = [k.clone() for k, _ in tpools]
    got = ttf.gather_paged_caches(cfg, tlayout, tpools, torch.from_numpy(row))
    want = _layers_of(cfg, jtf.gather_paged_caches(jcfg, jlayout, jpools, jnp.asarray(row)))
    for (gk, gv), (wk, wv) in zip(got, want):
        np.testing.assert_array_equal(gk.numpy(), wk)
        np.testing.assert_array_equal(gv.numpy(), wv)
    assert got[0][0].shape == (1, tlayout.cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)

    tlogits, tcaches = ttf.lm_prefix_prefill(cfg, tlayout, tparams, tpools,
                                             torch.from_numpy(row), torch.from_numpy(tokens),
                                             offset)
    jlogits, jcaches = jax.jit(
        lambda p, pools, r, t, off: jtf.lm_prefix_prefill(jcfg, jlayout, p, pools, r, t, off)
    )(jparams, jpools, jnp.asarray(row), jnp.asarray(tokens), jnp.int32(offset))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    assert np.array_equal(tlogits.argmax(-1).numpy(), np.asarray(jlogits).argmax(-1))
    for (gk, gv), (wk, wv) in zip(tcaches, _layers_of(cfg, jcaches)):
        np.testing.assert_allclose(gk.numpy(), wk, atol=ATOL, rtol=0)
        np.testing.assert_allclose(gv.numpy(), wv, atol=ATOL, rtol=0)
    # the pools were read, not written (copy-on-write)
    assert all(torch.equal(k, b) for (k, _), b in zip(tpools, before))


@pytest.mark.parametrize("window", [0, 16], ids=["global", "local"])
def test_tail_prefill_attention_matches_reference(bundle, window):
    cfg, (jcfg, _, jparams), (_, tparams) = bundle
    rng = np.random.default_rng(window)
    S_buf, offset, S = 40, 21, 6
    x = rng.standard_normal((1, S, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((1, S_buf, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0, 1], jparams["units"])["attn"]
    tp = tparams["layers"][1]["attn"]
    got, (gk, gv) = tattn.tail_prefill_attention(
        cfg, tp, torch.from_numpy(x), (torch.from_numpy(k.copy()), torch.from_numpy(v.copy())),
        offset, window=window)
    want, (wk, wv) = jattn.tail_prefill_attention(
        jcfg, jp, jnp.asarray(x), (jnp.asarray(k), jnp.asarray(v)), offset, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(gk.numpy()[:, :offset], k[:, :offset])  # prefix untouched


# ---------------------------------------------------------------------------
# the prefix-cache scheduler (tests/test_serve.py::TestPrefixCacheScheduler)
# ---------------------------------------------------------------------------


def _pair(bundle, runtime, **kw):
    """The port's and the reference's prefix-cache schedulers, one config."""
    _, (_, jmodel, jparams), (model, params) = bundle
    kw = dict(kv_mode="paged", prefix_cache=True, **kw)
    return (ContinuousBatchingScheduler(model, params, runtime=runtime, **kw),
            JaxScheduler(jmodel, jparams, **kw))


def _one_by_one(sched, requests):
    out = {}
    for r in requests:
        out.update({rid: fin.tokens for rid, fin in sched.serve([r]).items()})
    return out


def _settled(sched):
    """Every page is the cache's after a drain, and none after its reset."""
    kv = sched.decoder.kv
    held = (kv.pages_used, sched.prefix.cached_pages)
    stats = sched.prefix.stats()
    sched.prefix.reset()
    assert kv.pages_used == 0 and kv.pages_available == kv.capacity
    return held, stats


def test_shared_prompt_workload_token_identical_to_reference(bundle, runtime):
    cfg = bundle[0]
    rng = np.random.default_rng(7)
    system = rng.integers(1, cfg.vocab_size, (20,)).tolist()
    reqs = []
    for i in range(6):
        prompt = (system + rng.integers(1, cfg.vocab_size, (1 + i,)).tolist() if i % 2 == 0
                  else rng.integers(1, cfg.vocab_size, (8,)).tolist())
        reqs.append((f"p{i}", prompt, 4 + i))
    port, ref = _pair(bundle, runtime, max_batch=2, max_len=64, page_size=16, sync_interval=3)
    ops.reset_launch_counts()
    got = _one_by_one(port, [Request(*r) for r in reqs])
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel
    want = _one_by_one(ref, [JaxRequest(*r) for r in reqs])
    assert got == want
    held, stats = _settled(port)
    want_held, want_stats = _settled(ref)
    assert held == want_held and held[0] == held[1]
    assert stats == want_stats and stats["hits"] >= 2 and stats["hit_tokens"] >= 16


def test_identical_resubmission_is_a_full_hit_as_reference(bundle, runtime):
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3]
    results = []
    for sched, R in zip(_pair(bundle, runtime, max_batch=2, max_len=48, page_size=16,
                              sync_interval=2), (Request, JaxRequest)):
        first = sched.serve([R("a", prompt, 6)])["a"].tokens
        again = sched.serve([R("b", prompt, 6)])["b"].tokens
        assert again == first
        results.append((first, sched.prefix.stats()))
    assert results[0] == results[1]
    assert results[0][1]["hits"] == 1 and results[0][1]["hit_tokens"] == 16


def test_multi_turn_resumption_token_identical_to_reference(bundle, runtime):
    cfg = bundle[0]
    out = []
    for sched, R in zip(_pair(bundle, runtime, max_batch=2, max_len=64, page_size=16,
                              sync_interval=2), (Request, JaxRequest)):
        [[turn1, turn2]] = tworkload.multi_turn_requests(
            cfg.vocab_size, 1, 2, first_prompt_range=(8, 9), followup_range=(3, 4),
            steps_range=(9, 10), seed=4)
        r1 = sched.serve([R(turn1.rid, turn1.prompt, turn1.max_new_tokens)])[turn1.rid]
        prompt2 = tworkload.resume_prompt(turn1.prompt, r1.tokens, turn2.prompt)
        r2 = sched.serve([R(turn2.rid, prompt2, turn2.max_new_tokens)])[turn2.rid]
        out.append((r1.tokens, r2.tokens, _settled(sched)))
    assert out[0] == out[1]
    assert out[0][2][1]["hit_tokens"] >= 16


def test_eviction_under_page_pressure_as_reference(bundle, runtime):
    cfg = bundle[0]
    rng = np.random.default_rng(11)
    reqs = [(f"e{i}", rng.integers(1, cfg.vocab_size, (18,)).tolist(), 5) for i in range(5)]
    port, ref = _pair(bundle, runtime, max_batch=2, max_len=48, page_size=16, pool_pages=6,
                      sync_interval=2)
    got = _one_by_one(port, [Request(*r) for r in reqs])
    want = _one_by_one(ref, [JaxRequest(*r) for r in reqs])
    assert got == want
    held, stats = _settled(port)
    assert (held, stats) == _settled(ref)
    assert stats["evictions"] >= 1 and held[0] == held[1]


def test_own_locked_match_is_demoted_to_a_miss_as_reference(bundle, runtime):
    """The only evictable pages are the ones the request's own match locked
    and nothing is in flight: admission demotes the match and evicts."""
    out = []
    for sched, R in zip(_pair(bundle, runtime, max_batch=2, max_len=12, page_size=4,
                              pool_pages=4, sync_interval=2), (Request, JaxRequest)):
        a_prompt = [1, 2, 3, 4, 5, 6, 7, 8]
        sched.serve([R("a", a_prompt, 2)])
        assert sched.prefix.cached_pages == 2
        assert sched.try_admit(R("b", a_prompt[:6] + [91, 92], 2)) is True
        results = {}
        while "b" not in results:
            for fin in sched.step():
                results[fin.rid] = fin.tokens
        out.append((results["b"], sched.prefix.stats()))
    assert out[0] == out[1]


def test_mixed_batch_with_cache_matches_cache_off(bundle, runtime):
    """Several shared-prompt requests admitted together (hits and misses in
    one batch) give the port's own cache-off tokens."""
    cfg, _, (model, params) = bundle
    reqs = tworkload.shared_prefix_requests(cfg.vocab_size, 6, prefix_len=20, prefix_share=0.5,
                                            tail_range=(1, 6), steps_range=(3, 9), seed=3)
    kw = dict(kv_mode="paged", max_batch=4, max_len=40, page_size=8, sync_interval=3)
    on = ContinuousBatchingScheduler(model, params, runtime=runtime, prefix_cache=True, **kw)
    off = ContinuousBatchingScheduler(model, params, runtime=runtime, **kw)
    on.serve([Request("warm", reqs[0].prompt[:20] + [1], 2)])
    got = {rid: f.tokens for rid, f in on.serve(reqs).items()}
    want = {rid: f.tokens for rid, f in off.serve(reqs).items()}
    assert got == want
    assert on.prefix.stats()["hit_tokens"] > 0
    assert on.decoder.kv.pages_used == on.prefix.cached_pages and off.decoder.kv.pages_used == 0


# ---------------------------------------------------------------------------
# workloads and the CLI
# ---------------------------------------------------------------------------


def _rows(reqs):
    return [(r.rid, list(r.prompt), r.max_new_tokens) for r in reqs]


@pytest.mark.parametrize("kw", [
    dict(prefix_len=512, prefix_share=0.75, tail_range=(2, 8), steps_range=(8, 24), seed=1),
    dict(prefix_len=20, prefix_share=0.5, n_prefixes=3, seed=9),
    dict(prefix_len=4, prefix_share=0.0),
], ids=["bench", "three-prefixes", "unique"])
def test_shared_prefix_requests_match_reference(kw):
    assert _rows(tworkload.shared_prefix_requests(262144, 16, **kw)) == \
        _rows(jworkload.shared_prefix_requests(262144, 16, **kw))
    with pytest.raises(ValueError, match="prefix_share"):
        tworkload.shared_prefix_requests(100, 2, prefix_len=4, prefix_share=1.5)


def test_multi_turn_requests_and_resume_match_reference():
    kw = dict(first_prompt_range=(256, 512), followup_range=(16, 64), steps_range=(16, 32),
              seed=2)
    got = tworkload.multi_turn_requests(262144, 4, 3, **kw)
    want = jworkload.multi_turn_requests(262144, 4, 3, **kw)
    assert [_rows(c) for c in got] == [_rows(c) for c in want]
    assert tworkload.resume_prompt([1, 2], [3], [4, 5]) == \
        jworkload.resume_prompt([1, 2], [3], [4, 5]) == [1, 2, 3, 4, 5]


def test_launch_serve_prefix_cache_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--reduced", "--device", "cpu", "--kv-mode", "paged", "--prefix-cache",
                "--prefix-share", "0.6", "--max-batch", "4", "--requests", "8",
                "--prompt-len", "24", "--steps", "8"])
    out = capsys.readouterr().out
    assert "served 8 requests" in out and "prefix cache: hit_rate=" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("prefix cache:"))
    cached = int(line.split(" cached pages")[0].rsplit(" ", 1)[1])
    used = int(next(ln for ln in out.splitlines() if ln.startswith("kv pool:")).split()[2])
    assert used == cached > 0
    assert "(2/8 requests" in line  # the reference CLI's counters on this workload
