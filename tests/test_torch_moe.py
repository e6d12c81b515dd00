"""The MoE family (grok-1-314b, kimi-k2-1t-a32b) on the port against the JAX
reference.

grok is 8 experts top-2 with a GELU expert MLP (no `w_gate`); kimi 384
experts top-8 with SwiGLU experts and head_dim 112 (REDUCED: 8 experts
top-2, head_dim 16). For each REDUCED fp32 config, with the reference's
`init_lm(PRNGKey(0))` weights bridged in (`params_from_jax`):

* the config copies equal the reference's, full and REDUCED;
* `capacity` equals the reference's integer rule; `moe_ffn` matches the
  reference's within 1e-5 (fp32) and drops the same rows, also at a
  capacity factor low enough that rows drop;
* prefill and decode logits within 1e-4 of the reference's (the tolerance
  of `tests/test_torch_model.py`), with equal greedy tokens;
* feeding a prompt's last token through `decode_step` reproduces the full
  prefill's logits under dropless capacity (2e-3, the invariant of
  `tests/test_arch_smoke.py::test_decode_matches_teacher_forcing`);
* serves are token-identical to the reference's scheduler and engine in
  every mode: dense, paged, paged with the prefix cache, the serial engine
  and the fleet (against the reference's single-instance scheduler);
* the dense decoder keeps the reference's per-slot capacity: at 16 slots
  and a capacity factor of 0.5 a batched tick would drop rows (shown), yet
  the port's dense serve equals the reference's vmapped B=1 decode token
  for token;
* the full configs build on the ``meta`` device with the reference's
  per-layer shapes and parameter counts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.configs import PORTED_ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_jax, unstack_layers  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.router import run_fleet  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request  # noqa: E402
from repro_torch.serve.workload import shared_prefix_requests  # noqa: E402

ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b")
ATOL = 1e-4
MOE_ATOL = 1e-5

#: parameters at full width, counted from the configs (embeddings untied)
FULL_PARAMS = {"grok-1-314b": 213_410_125_824, "kimi-k2-1t-a32b": 1_041_166_988_288}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


def _bundles(arch, **overrides):
    jcfg = jax_get_config(arch, reduced=True).replace(**overrides)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch, reduced=True).replace(**overrides)
    tparams = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, (jcfg, jmodel, jparams), (build(cfg), tparams)


@pytest.fixture(scope="module")
def reduced(arch):
    return _bundles(arch)


@pytest.fixture(scope="module")
def runtime():
    with Runtime("torchdev", device="cpu") as rt:
        yield rt


def _workload(vocab, n, *, seed=0, lo_p=3, hi_p=12, lo_s=2, hi_s=14):
    """`tests/test_serve.py::_workload`: (rid, prompt, max_new_tokens)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(lo_p, hi_p))
        steps = int(rng.integers(lo_s, hi_s))
        out.append((f"r{seed}-{i}", rng.integers(1, vocab, (plen,)).tolist(), steps))
    return out


def _reference_dropped(idx: np.ndarray, C: int) -> np.ndarray:
    """The reference's capacity rule on its own top-k picks (N, k): rows
    sorted stably by expert, each row's position in its expert's group,
    rows at C or beyond dropped; returned in token order (N, k)."""
    N, k = idx.shape
    flat = idx.reshape(N * k)
    order = np.argsort(flat, kind="stable")
    sorted_e = flat[order]
    starts = np.searchsorted(sorted_e, sorted_e, side="left")
    dropped = np.empty(N * k, dtype=bool)
    dropped[order] = (np.arange(N * k) - starts) >= C
    return dropped.reshape(N, k)


# ---------------------------------------------------------------------------
# configs, capacity, the MoE layer
# ---------------------------------------------------------------------------


def test_configs_equal_reference_and_are_ported(arch):
    assert arch in PORTED_ARCH_IDS
    for reduced_ in (False, True):
        cfg = get_config(arch, reduced=reduced_)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(arch, reduced=reduced_))
        assert cfg.family == "moe" and cfg.is_moe
        assert ttf.unit_structure(cfg) == jtf.unit_structure(jax_get_config(arch, reduced=reduced_))


def test_capacity_equals_reference_rule(arch):
    for reduced_ in (False, True):
        base = get_config(arch, reduced=reduced_)
        for cf in (0.25, 0.5, 1.0, 1.25, 2.0, float(base.num_experts)):
            cfg, jcfg = base.replace(capacity_factor=cf), jax_get_config(
                arch, reduced=reduced_).replace(capacity_factor=cf)
            for n in (1, 2, 7, 8, 9, 16, 33, 100, 1024, 8265):
                assert tmoe.capacity(cfg, n) == jmoe.capacity(jcfg, n), (cf, n)
                assert tmoe.capacity(cfg, n) % 8 == 0 and tmoe.capacity(cfg, n) >= 8


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_ffn_matches_reference_with_the_same_drops(reduced, capacity_factor):
    cfg, (jcfg, _, jparams), (_, tparams) = reduced
    cfg, jcfg = (c.replace(capacity_factor=capacity_factor) for c in (cfg, jcfg))
    x = (np.random.default_rng(3).standard_normal((2, 40, cfg.d_model)) * 0.5).astype(np.float32)
    for layer in range(cfg.num_layers):
        jp = jax.tree_util.tree_map(lambda a: a[layer], jparams["layers"]["moe"])
        want, jaux = jax.jit(lambda p, v: jmoe.moe_ffn(jcfg, p, v))(jp, jnp.asarray(x))
        got, aux = tmoe.moe_ffn(cfg, tparams["layers"][layer]["moe"], torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_ATOL, rtol=0)
        idx = np.asarray(jaux["expert_indices"])
        np.testing.assert_array_equal(np.sort(aux["expert_indices"].numpy(), -1), np.sort(idx, -1))
        want_drop = _reference_dropped(idx, jmoe.capacity(jcfg, x.shape[0] * x.shape[1]))
        order_t = np.argsort(aux["expert_indices"].numpy(), -1)
        order_j = np.argsort(idx, -1)
        np.testing.assert_array_equal(np.take_along_axis(aux["dropped"].numpy(), order_t, -1),
                                      np.take_along_axis(want_drop, order_j, -1))
        if capacity_factor < 1:  # the low factor must really drop rows
            assert want_drop.any()
        else:
            assert not want_drop.any()


def test_dropless_keeps_every_row(reduced):
    cfg = reduced[0].replace(capacity_factor=0.25)
    p = reduced[2][1]["layers"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 64, cfg.d_model))
                         .astype(np.float32))
    assert tmoe.moe_ffn(cfg, p, x)[1]["dropped"].any()
    assert not tmoe.moe_ffn(cfg, p, x, dropless=True)[1]["dropped"].any()


def test_bridge_keeps_the_router_fp32(reduced):
    cfg, (_, _, jparams), _ = reduced
    tp = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu",
                         dtype=torch.bfloat16)
    for i, layer in enumerate(tp["layers"]):
        assert "ffn" not in layer
        m = layer["moe"]
        assert m["router"].dtype == torch.float32
        np.testing.assert_array_equal(m["router"].numpy(),
                                      np.asarray(jparams["layers"]["moe"]["router"][i]))
        assert m["w_up"].dtype == torch.bfloat16
        assert ("w_gate" in m) == (cfg.act == "silu")
        assert tuple(m["w_up"].shape) == (cfg.num_experts, cfg.d_model, cfg.expert_d_ff)


# ---------------------------------------------------------------------------
# the model: prefill, decode, teacher forcing
# ---------------------------------------------------------------------------


def test_prefill_and_decode_logits_match_reference(reduced):
    cfg, (jcfg, _, jparams), (_, tparams) = reduced
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (2, 21)).astype(np.int32)
    jlogits, jcaches = jax.jit(lambda p, t, c: jtf.lm_prefill(jcfg, p, t, c))(
        jparams, jnp.asarray(tokens), jtf.init_caches(jcfg, 2, 40))
    tlogits, tcaches = ttf.lm_prefill(cfg, tparams, torch.from_numpy(tokens),
                                      ttf.init_caches(cfg, 2, 40, device="cpu"))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    assert np.array_equal(tlogits.argmax(-1).numpy(), np.asarray(jlogits).argmax(-1))
    step = jax.jit(lambda p, c, t, pos: jtf.lm_decode_step(jcfg, p, c, t, pos))
    for i in range(4):
        nxt = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        jlogits, jcaches = step(jparams, jcaches, jnp.asarray(nxt), jnp.int32(21 + i))
        tlogits, tcaches = ttf.lm_decode_step(cfg, tparams, tcaches, torch.from_numpy(nxt), 21 + i)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
        assert np.array_equal(tlogits.argmax(-1).numpy(), np.asarray(jlogits).argmax(-1))


def test_decode_matches_teacher_forcing(reduced):
    """The last token through `decode_step` reproduces the full prefill's
    last logits; dropless capacity, as the reference's own test."""
    cfg = reduced[0].replace(capacity_factor=float(reduced[0].num_experts))
    model, tparams = build(cfg), reduced[2][1]
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 24)).astype(np.int32))
    full, _ = model.make_prefill()(tparams, {"tokens": tokens})
    _, state = model.make_prefill(24)(tparams, {"tokens": tokens[:, :23]})
    dec, _ = model.decode_step(tparams, state, {"tokens": tokens[:, 23:], "pos": 23})
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# serving, token-identical to the reference in every mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_continuous_serve_token_identical_to_reference(reduced, runtime, kv_mode):
    cfg, (_, jmodel, jparams), (model, tparams) = reduced
    reqs = _workload(cfg.vocab_size, 6, seed=1)
    kw = dict(max_batch=3, max_len=32, kv_mode=kv_mode, page_size=8, sync_interval=4)
    want = JaxScheduler(jmodel, jparams, **kw).serve([JaxRequest(*r) for r in reqs])
    ops.reset_launch_counts()
    sched = ContinuousBatchingScheduler(model, tparams, runtime=runtime, **kw)
    got = sched.serve([Request(*r) for r in reqs])
    for rid, _, steps in reqs:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason == "length"
        assert len(got[rid].tokens) == steps
    if kv_mode == "paged":
        assert sched.active_progress().pages_used == 0
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel


def test_prefix_cache_serve_token_identical_to_reference(reduced, runtime):
    cfg, (_, jmodel, jparams), (model, tparams) = reduced
    reqs = shared_prefix_requests(cfg.vocab_size, 6, prefix_len=16, prefix_share=0.7,
                                  tail_range=(1, 6), steps_range=(3, 8), seed=2)
    kw = dict(max_batch=3, max_len=40, kv_mode="paged", page_size=8, sync_interval=4,
              prefix_cache=True)
    jsched = JaxScheduler(jmodel, jparams, **kw)
    sched = ContinuousBatchingScheduler(model, tparams, runtime=runtime, **kw)
    want, got = {}, {}
    for r in reqs:  # one by one, so later requests hit the cached prefix
        want.update(jsched.serve([JaxRequest(r.rid, list(r.prompt), r.max_new_tokens)]))
        got.update(sched.serve([Request(r.rid, list(r.prompt), r.max_new_tokens)]))
    for r in reqs:
        assert got[r.rid].tokens == want[r.rid].tokens, r.rid
    stats = sched.prefix.stats()
    assert stats == jsched.prefix.stats()
    assert stats["hits"] > 0
    assert sched.decoder.kv.pages_used == sched.prefix.cached_pages


def test_serve_engine_token_identical_to_reference(reduced, runtime):
    cfg, (_, jmodel, jparams), (model, tparams) = reduced
    prompts = np.random.default_rng(5).integers(1, cfg.vocab_size, (3, 9)).astype(np.int32)
    got = ServeEngine(model, tparams, max_len=40, runtime=runtime).generate(prompts, steps=12)
    want = JaxServeEngine(jmodel, jparams, max_len=40).generate(prompts, steps=12)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.prefill_logits, np.asarray(want.prefill_logits, np.float32),
                               atol=ATOL, rtol=0)


def test_fleet_token_identical_to_reference(reduced):
    cfg, (_, jmodel, jparams), (model, tparams) = reduced
    reqs = _workload(cfg.vocab_size, 6, seed=3)
    want = JaxScheduler(jmodel, jparams, max_batch=4, max_len=32).serve(
        [JaxRequest(*r) for r in reqs])
    out = run_fleet(model, tparams, [Request(*r) for r in reqs], n_workers=2, max_batch=2,
                    max_len=32, device="cpu", launch_timeout=420)
    assert out.stats["worker_errors"] == {}
    for rid, _, _ in reqs:
        assert out.results[rid]["tokens"] == want[rid].tokens, rid


def test_dense_serve_keeps_per_slot_capacity(runtime, monkeypatch):
    """grok REDUCED (4 experts top-2) at 16 slots and a capacity factor of
    0.5: a batched tick's capacity is 8 rows an expert for 32 rows, so it
    drops rows, where the reference's vmapped B=1 decode never does. The
    port's dense serve drops none on its ticks and equals the reference
    token for token; a tick forced to batched capacity drops rows."""
    cfg, (_, jmodel, jparams), (model, tparams) = _bundles("grok-1-314b", capacity_factor=0.5)
    reqs = _workload(cfg.vocab_size, 16, seed=7, lo_s=8, hi_s=14)
    kw = dict(max_batch=16, max_len=32, kv_mode="dense")
    want = JaxScheduler(jmodel, jparams, **kw).serve([JaxRequest(*r) for r in reqs])

    tick_drops = []
    real = tmoe.moe_ffn

    def recording(cfg_, p, x, *, dropless=False):
        y, aux = real(cfg_, p, x, dropless=dropless)
        if x.shape[1] == 1:  # a decode tick (prefills are B=1 prompts)
            tick_drops.append(int(aux["dropped"].sum()))
        return y, aux

    monkeypatch.setattr(tmoe, "moe_ffn", recording)
    got = ContinuousBatchingScheduler(model, tparams, runtime=runtime, **kw).serve(
        [Request(*r) for r in reqs])
    for rid, _, _ in reqs:
        assert got[rid].tokens == want[rid].tokens, rid
    assert tick_drops and sum(tick_drops) == 0

    # the same serve with every tick at the batched capacity (no per_slot mark)
    batched = dataclasses.replace(
        model, decode_step=lambda p, s, b: model.decode_step(p, s, {**b, "per_slot": False}))
    tick_drops.clear()
    ContinuousBatchingScheduler(batched, tparams, runtime=runtime, **kw).serve(
        [Request(*r) for r in reqs])
    assert sum(tick_drops) > 0


# ---------------------------------------------------------------------------
# full width
# ---------------------------------------------------------------------------


def test_full_config_builds_on_meta_with_reference_shapes(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    params = build(cfg).init(seed=0, device="meta", dtype=torch.bfloat16)
    abstract = jax.eval_shape(lambda: jtf.init_lm(jcfg.replace(num_layers=2),
                                                  jax.random.PRNGKey(0))[0])
    stand_in = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), abstract)
    want = unstack_layers(jcfg.replace(num_layers=2), stand_in)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    got = shapes(params)
    assert got["embed"] == shapes(want)["embed"]
    assert got["layers"][0] == shapes(want)["layers"][0]
    assert len(got["layers"]) == cfg.num_layers
    leaves = jax.tree_util.tree_leaves(params)
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) == FULL_PARAMS[arch]
    router = params["layers"][0]["moe"]["router"]
    assert router.dtype == torch.float32  # the experts bf16, the router fp32
    assert params["layers"][0]["moe"]["w_up"].dtype == torch.bfloat16


def test_launch_serve_moe_on_cpu(capsys, arch):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--kv-mode", "paged",
                "--requests", "3", "--prompt-len", "12", "--steps", "5", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "0 pages used" in out
