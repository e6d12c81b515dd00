"""The dense family beside gemma3-1b (granite-20b, minitron-8b,
stablelm-12b) on the port against the JAX reference.

These configs run the transformer already ported, at shapes gemma3-1b does
not: an all-global stack with no sliding-window units, untied embeddings,
granite's two-matrix GELU MLP (no `w_gate`) beside SwiGLU, and query heads
per KV head of 6 (granite REDUCED; 48 at full width), 2 (minitron and
stablelm REDUCED; 4 at full width). For each REDUCED fp32 config, with the
reference's `init_lm(PRNGKey(0))` weights bridged in (`params_from_jax`):

* the config copies equal the reference's, full and REDUCED;
* prefill logits within 1e-4 of the reference's (the tolerance of
  `tests/test_torch_model.py`: XLA and torch sum in different orders), with
  equal greedy tokens;
* continuous serves, dense and paged, and the serial engine are
  token-identical to the reference's scheduler and engine; the paged pool
  is back after the drain;
* the full configs build on the ``meta`` device with the reference's
  per-layer shapes, and count the parameters the configs imply.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.configs import PORTED_ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_jax, unstack_layers  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request  # noqa: E402

ARCHS = ("granite-20b", "minitron-8b", "stablelm-12b")
ATOL = 1e-4

#: parameters at full width, counted from the configs (embeddings untied)
FULL_PARAMS = {"granite-20b": 20_315_756_544, "minitron-8b": 9_882_046_464,
               "stablelm-12b": 12_142_924_800}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def reduced(arch):
    jcfg = jax_get_config(arch, reduced=True)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch, reduced=True)
    tparams = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, (jcfg, jmodel, jparams), (build(cfg), tparams)


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


def test_configs_equal_reference_and_are_ported(arch):
    assert arch in PORTED_ARCH_IDS
    for reduced_ in (False, True):
        cfg = get_config(arch, reduced=reduced_)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(arch, reduced=reduced_))
        assert cfg.family == "dense" and not cfg.tie_embeddings and not cfg.sliding_window
        assert ttf.serving_windows(cfg) == [0] * cfg.num_layers  # all global, no units
        assert ttf.unit_structure(cfg) == jtf.unit_structure(jax_get_config(arch, reduced=reduced_))


def test_bridge_gives_untied_layers_and_the_config_mlp(reduced):
    cfg, (_, _, jparams), (_, tparams) = reduced
    assert len(tparams["layers"]) == cfg.num_layers
    assert tuple(tparams["embed"]["unembed"].shape) == (cfg.d_model, cfg.vocab_size)
    ffn = tparams["layers"][0]["ffn"]
    assert ("w_gate" in ffn) == (cfg.act == "silu")  # granite: gelu, two matrices
    for i, layer in enumerate(tparams["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      np.asarray(jparams["layers"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(layer["ffn"]["w_down"].numpy(),
                                      np.asarray(jparams["layers"]["ffn"]["w_down"][i]))


def test_prefill_logits_match_reference(reduced):
    cfg, (jcfg, _, jparams), (_, tparams) = reduced
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (2, 21)).astype(np.int32)
    jlogits, jcaches = jax.jit(lambda p, t, c: jtf.lm_prefill(jcfg, p, t, c))(
        jparams, jnp.asarray(tokens), jtf.init_caches(jcfg, 2, 40))
    tlogits, tcaches = ttf.lm_prefill(cfg, tparams, torch.from_numpy(tokens),
                                      ttf.init_caches(cfg, 2, 40, device="cpu"))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    assert np.array_equal(tlogits.argmax(-1).numpy(), np.asarray(jlogits).argmax(-1))
    last = cfg.num_layers - 1
    np.testing.assert_allclose(tcaches[last][0].numpy(), np.asarray(jcaches["k"][last]),
                               atol=ATOL, rtol=0)


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


def test_serve_engine_token_identical_to_reference(reduced, runtime):
    cfg, (_, jmodel, jparams), (model, tparams) = reduced
    prompts = np.random.default_rng(5).integers(1, cfg.vocab_size, (3, 9)).astype(np.int32)
    got = ServeEngine(model, tparams, max_len=40, runtime=runtime).generate(prompts, steps=12)
    want = JaxServeEngine(jmodel, jparams, max_len=40).generate(prompts, steps=12)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.prefill_logits, np.asarray(want.prefill_logits, np.float32),
                               atol=ATOL, rtol=0)


def test_full_config_builds_on_meta_with_reference_shapes(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    params = build(cfg).init(seed=0, device="meta")
    abstract = jax.eval_shape(lambda: jtf.init_lm(jcfg, jax.random.PRNGKey(0))[0])
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
    leaves = jax.tree_util.tree_leaves(params)
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) == FULL_PARAMS[arch]


def test_launch_serve_dense_family_on_cpu(capsys, arch):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--kv-mode", "paged",
                "--requests", "3", "--prompt-len", "12", "--steps", "5", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "0 pages used" in out
