"""The port's gemma3-1b against the JAX reference through the weight bridge.

REDUCED gemma3-1b in fp32 with the reference's `init_lm(PRNGKey(0))` weights
bridged into the port: prefill logits, then 16 teacher-forced paged decode
ticks over a ring layout, within 1e-4 (XLA and torch sum in different orders
across 6 layers), with identical greedy tokens. The full config builds on the
``meta`` device with the reference's per-layer shapes, allocating nothing.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.attention import paged_layout  # noqa: E402
from repro_torch.models.bridge import params_from_jax, unstack_layers  # noqa: E402

ATOL = 1e-4


@pytest.fixture(scope="module")
def reduced():
    cfg = get_config("gemma3-1b", reduced=True)
    jcfg = jax_get_config("gemma3-1b", reduced=True)
    jparams, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, jparams, tparams


def test_config_copy_matches_reference():
    for reduced_ in (False, True):
        assert dataclasses.asdict(get_config("gemma3-1b", reduced=reduced_)) == \
            dataclasses.asdict(jax_get_config("gemma3-1b", reduced=reduced_))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        get_config("granite-20b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_layer_structure_matches_reference():
    for reduced_ in (False, True):
        cfg, jcfg = get_config("gemma3-1b", reduced=reduced_), jax_get_config("gemma3-1b", reduced=reduced_)
        assert ttf.layer_windows(cfg) == jtf.layer_windows(jcfg)
        assert ttf.unit_structure(cfg) == jtf.unit_structure(jcfg)
    full = get_config("gemma3-1b")
    assert ttf.unit_structure(full) == (6, 4, 2)
    assert sum(1 for w in ttf.layer_windows(full) if w) == 22


def test_bridge_maps_units_and_tail_to_layer_order():
    """Unit u, layer j -> layer 6u+j; tail layer t -> layer 24+t."""
    cfg = get_config("gemma3-1b")
    leaf_u = (100 * np.arange(4)[:, None] + np.arange(6)[None, :]).astype(np.float32)[..., None]
    leaf_t = (1000 + np.arange(2)).astype(np.float32)[:, None]
    tree = {
        "embed": {"embedding": np.zeros((1, 1))},
        "final_norm": np.zeros((1,)),
        "units": {"ln1": leaf_u, "attn": {"wq": leaf_u}},
        "tail": {"ln1": leaf_t, "attn": {"wq": leaf_t}},
    }
    layers = unstack_layers(cfg, tree)["layers"]
    assert len(layers) == 26
    for u in range(4):
        for j in range(6):
            assert layers[6 * u + j]["ln1"][0] == 100 * u + j
            assert layers[6 * u + j]["attn"]["wq"][0] == 100 * u + j
    assert [layers[24 + t]["ln1"][0] for t in range(2)] == [1000, 1001]


def test_full_config_builds_on_meta_with_reference_shapes():
    cfg = get_config("gemma3-1b")
    jcfg = jax_get_config("gemma3-1b")
    params = build(cfg).init(seed=0, device="meta")
    abstract = jax.eval_shape(lambda: jtf.init_lm(jcfg, jax.random.PRNGKey(0))[0])
    # zero-stride numpy stand-ins: indexable like the real stacks, no memory
    stand_in = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), abstract)
    want = unstack_layers(cfg, stand_in)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(params) == shapes(want)
    leaves = [params["embed"]["embedding"], params["final_norm"]] + [
        t for layer in params["layers"] for t in jax.tree_util.tree_leaves(layer)]
    assert all(t.is_meta for t in leaves)
    n_params = sum(t.numel() for t in leaves)
    assert n_params == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(abstract))


def test_seeded_init_is_deterministic_with_reference_distribution():
    cfg = get_config("gemma3-1b", reduced=True)
    a = build(cfg).init(seed=3, device="cpu")
    b = build(cfg).init(seed=3, device="cpu")
    assert torch.equal(a["layers"][2]["attn"]["wq"], b["layers"][2]["attn"]["wq"])
    assert not torch.equal(a["layers"][2]["attn"]["wq"], a["layers"][3]["attn"]["wq"])
    assert torch.count_nonzero(a["layers"][0]["ln1"]) == 0  # norm weights start at zero
    emb = a["embed"]["embedding"]
    assert abs(float(emb.std()) - cfg.d_model ** -0.5) < 0.01
    bf = build(cfg).init(seed=3, device="cpu", dtype=torch.bfloat16)
    assert bf["layers"][0]["ffn"]["w_up"].dtype == torch.bfloat16
    assert bf["layers"][0]["ln1"].dtype == torch.float32  # rms_norm reads fp32


def test_prefill_logits_match_reference(reduced):
    cfg, jcfg, jparams, tparams = reduced
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (2, 21)).astype(np.int32)
    jlogits, jcaches = jax.jit(lambda p, t, c: jtf.lm_prefill(jcfg, p, t, c))(
        jparams, jnp.asarray(tokens), jtf.init_caches(jcfg, 2, 40))
    tlogits, tcaches = ttf.lm_prefill(cfg, tparams, torch.from_numpy(tokens),
                                      ttf.init_caches(cfg, 2, 40, device="cpu"))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    assert np.array_equal(tlogits.argmax(-1).numpy(), np.asarray(jlogits).argmax(-1))
    # the ring caches of local layers and the full caches of the global one
    jk = np.asarray(jcaches["units"]["k_local"][0, 1])
    np.testing.assert_allclose(tcaches[1][0].numpy(), jk, atol=ATOL, rtol=0)
    jg = np.asarray(jcaches["units"]["v_global"][0])
    np.testing.assert_allclose(tcaches[5][1].numpy(), jg, atol=ATOL, rtol=0)


def test_paged_decode_teacher_forced_matches_reference(reduced):
    """Three slots on a ring layout (window 16, page 8): prompts of 13 and 5
    tokens, plus an inactive slot; 16 teacher-forced ticks wrap the ring."""
    cfg, jcfg, jparams, tparams = reduced
    B, max_len, page = 3, 32, 8
    jlayout = jtf.make_paged_layout(jcfg, max_slots=B, max_len=max_len, page_size=page)
    tlayout = paged_layout(cfg, max_slots=B, max_len=max_len, page_size=page)
    want = dataclasses.asdict(jlayout)
    assert want.pop("shared") is False  # the prefix-cache layout is not ported
    assert dataclasses.asdict(tlayout) == want
    assert tlayout.ring and tlayout.w_pages == 2
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (13, 5)]
    table = np.zeros((B, tlayout.n_pages_seq), np.int32)
    jpools = jtf.init_paged_caches(jcfg, jlayout)
    tpools = ttf.init_paged_caches(cfg, tlayout, device="cpu")
    jring, tring = jlayout.ring_table(), tlayout.ring_table()
    # jitted: eager JAX dispatches (and compiles) op by op
    jprefill = jax.jit(lambda p, t, c: jtf.lm_prefill(jcfg, p, t, c))
    jcommit = jax.jit(lambda pools, c, full, ring: jtf.commit_prefill_paged(
        jcfg, jlayout, pools, c, full, ring))
    jdecode = jax.jit(lambda p, pools, tbl, tok, ps, act: jtf.lm_paged_decode_step(
        jcfg, jlayout, p, pools, tbl, tok, ps, act))
    for s, prompt in enumerate(prompts):
        table[s] = 1 + s * tlayout.n_pages_seq + np.arange(tlayout.n_pages_seq)
        jl, jc = jprefill(jparams, jnp.asarray(prompt[None]),
                          jtf.init_caches(jcfg, 1, jlayout.cache_len))
        tl, tc = ttf.lm_prefill(cfg, tparams, torch.from_numpy(prompt[None]),
                                ttf.init_caches(cfg, 1, tlayout.cache_len, device="cpu"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        jpools = jcommit(jpools, jc, jnp.asarray(table[s]), jring[s])
        tpools = ttf.commit_prefill_paged(cfg, tlayout, tpools, tc, torch.from_numpy(table[s]),
                                          tring[s])
    pos = np.asarray([13, 5, 0], np.int32)
    active = np.asarray([True, True, False])
    for step in range(16):
        tokens = rng.integers(1, cfg.vocab_size, B).astype(np.int32)
        jl, jpools = jdecode(jparams, jpools, jnp.asarray(table), jnp.asarray(tokens),
                             jnp.asarray(pos), jnp.asarray(active))
        tl, tpools = ttf.lm_paged_decode_step(
            cfg, tlayout, tparams, tpools, torch.from_numpy(table), torch.from_numpy(tokens),
            torch.from_numpy(pos), torch.from_numpy(active))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl[:2].numpy(), jl[:2], atol=ATOL, rtol=0, err_msg=f"tick {step}")
        assert np.array_equal(tl[:2].argmax(-1).numpy(), jl[:2].argmax(-1)), step
        pos = pos + active.astype(np.int32)
    # the live slots' pages agree too (the inactive slot wrote only null/own pages)
    jk = np.asarray(jpools["units"]["k_global"][0])
    np.testing.assert_allclose(tpools[5][0][1:].numpy(), jk[1:], atol=ATOL, rtol=0)


def test_dense_decode_teacher_forced_matches_reference(reduced):
    """Three slots of dense caches (ring 16 on local layers, 40 deep on the
    global ones) at per-slot positions: the reference vmaps its B=1
    `lm_decode_step` over slots as its `SlotDecoder` does; the port runs one
    batched step with pos (B,). 20 teacher-forced ticks wrap the rings."""
    cfg, jcfg, jparams, tparams = reduced
    max_len = 40
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (13, 5, 9)]
    jprefill = jax.jit(lambda p, t: jtf.lm_prefill(jcfg, p, t, jtf.init_caches(jcfg, 1, max_len)))
    jstates, tcaches = [], None
    for s, prompt in enumerate(prompts):
        jl, jc = jprefill(jparams, jnp.asarray(prompt[None]))
        tl, tc = ttf.lm_prefill(cfg, tparams, torch.from_numpy(prompt[None]),
                                ttf.init_caches(cfg, 1, max_len, device="cpu"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        jstates.append(jc)
        if tcaches is None:
            tcaches = [tuple(torch.zeros((len(prompts),) + t.shape[1:]) for t in kv) for kv in tc]
        for (bk, bv), (k, v) in zip(tcaches, tc):
            bk[s], bv[s] = k[0], v[0]
    jstates = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jstates)

    @jax.jit
    def jdecode(p, states, tokens, pos):
        def one(state, tok, position):
            return jtf.lm_decode_step(jcfg, p, state, tok, position)
        return jax.vmap(one)(states, tokens[:, None, None], pos)

    pos = np.asarray([len(p) for p in prompts], np.int32)
    for step in range(20):
        tokens = rng.integers(1, cfg.vocab_size, len(prompts)).astype(np.int32)
        jl, jstates = jdecode(jparams, jstates, jnp.asarray(tokens), jnp.asarray(pos))
        tl, tcaches = ttf.lm_decode_step(cfg, tparams, tcaches, torch.from_numpy(tokens)[:, None],
                                         torch.from_numpy(pos))
        jl = np.asarray(jl)[:, 0]
        np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL, rtol=0, err_msg=f"tick {step}")
        assert np.array_equal(tl.argmax(-1).numpy(), jl.argmax(-1)), step
        pos = pos + 1
    # the global layer's cache agrees for every written position
    jg = np.asarray(jstates["units"]["k_global"][:, 0, 0])  # (B, S, KV, hd)
    np.testing.assert_allclose(tcaches[5][0].numpy(), jg, atol=ATOL, rtol=0)


def test_dense_decode_scalar_pos_matches_reference(reduced):
    """The serial engine's form: one scalar position for the whole batch."""
    cfg, jcfg, jparams, tparams = reduced
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, cfg.vocab_size, (2, 7)).astype(np.int32)
    jl, jc = jtf.lm_prefill(jcfg, jparams, jnp.asarray(prompts), jtf.init_caches(jcfg, 2, 24))
    tl, tc = ttf.lm_prefill(cfg, tparams, torch.from_numpy(prompts),
                            ttf.init_caches(cfg, 2, 24, device="cpu"))
    jdecode = jax.jit(lambda p, c, t, pos: jtf.lm_decode_step(jcfg, p, c, t, pos))
    for pos in range(7, 17):
        tokens = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jdecode(jparams, jc, jnp.asarray(tokens), jnp.int32(pos))
        tl, tc = ttf.lm_decode_step(cfg, tparams, tc, torch.from_numpy(tokens), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
