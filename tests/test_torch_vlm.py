"""paligemma-3b, the VLM family, on the port against the JAX reference.

The backbone is the gemma transformer the port already runs; what is new is
the vision prefix: 256 stub patch embeddings (width 1152) projected by
``vision_proj`` in front of the prompt, attended bidirectionally within the
prefix and causally over the text (prefix-LM, ``prefix_len`` =
``vision_tokens``), and cache positions that count the prefix. For REDUCED
fp32 (8 vision tokens of width 32), with the reference's
`init_lm(PRNGKey(0))` weights bridged in (`params_from_jax`):

* the config copies equal the reference's, full and REDUCED;
* `ModelBundle.make_prefill(max_len)` logits within 1e-4 of the
  reference's (the tolerance of `tests/test_torch_model.py`), and a greedy
  chain of 16 tokens through `decode_step` identical to the reference's;
* feeding the last prompt token through `decode_step` reproduces the full
  prefill (2e-3, `tests/test_arch_smoke.py`'s invariant);
* the full config builds on the ``meta`` device with the reference's
  shapes and parameter count.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro_torch.configs import PORTED_ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.bridge import params_from_jax, unstack_layers  # noqa: E402

ARCH = "paligemma-3b"
ATOL = 1e-4
CHAIN = 16
FULL_PARAMS = 1_907_042_304  # tied embeddings


@pytest.fixture(scope="module")
def bundle():
    jcfg = jax_get_config(ARCH, reduced=True)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, reduced=True)
    tparams = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, (jcfg, jmodel, jparams), (build(cfg), tparams)


def _inputs(cfg, B=2, S=7, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.vision_tokens, cfg.vision_embed_dim)).astype(np.float32)
    return tokens, patches


def _greedy(prefill, decode, tokens, steps, first_pos, to_np):
    """Greedy chain: the prefill's pick, then `steps - 1` decode picks."""
    logits, state = prefill(tokens)
    out = [to_np(logits).argmax(-1).astype(np.int32)]
    for i in range(steps - 1):
        logits, state = decode(state, out[-1][:, None], first_pos + i)
        out.append(to_np(logits).argmax(-1).astype(np.int32))
    return np.stack(out, axis=1), logits


def test_config_equals_reference_and_is_ported():
    assert ARCH in PORTED_ARCH_IDS
    for reduced_ in (False, True):
        cfg = get_config(ARCH, reduced=reduced_)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH, reduced=reduced_))
        assert cfg.family == "vlm" and build(cfg).paged_ops is None


def test_bridge_carries_the_vision_projection(bundle):
    cfg, (_, _, jparams), (_, tparams) = bundle
    np.testing.assert_array_equal(tparams["vision_proj"].numpy(), np.asarray(jparams["vision_proj"]))
    assert len(tparams["layers"]) == cfg.num_layers
    assert "unembed" not in tparams["embed"]  # tied


def test_prefill_logits_and_greedy_chain_match_reference(bundle):
    cfg, (_, jmodel, jparams), (model, tparams) = bundle
    tokens, patches = _inputs(cfg)
    P, S = cfg.vision_tokens, tokens.shape[1]
    max_len = P + S + CHAIN
    jpre = jax.jit(jmodel.make_prefill(max_len))
    jdec = jax.jit(jmodel.decode_step)
    want, wlast = _greedy(
        lambda t: jpre(jparams, {"tokens": jnp.asarray(t), "patches": jnp.asarray(patches)}),
        lambda s, t, pos: jdec(jparams, s, {"tokens": jnp.asarray(t), "pos": jnp.int32(pos)}),
        tokens, CHAIN, P + S, np.asarray)
    tpre = model.make_prefill(max_len)
    got, glast = _greedy(
        lambda t: tpre(tparams, {"tokens": torch.from_numpy(t),
                                 "patches": torch.from_numpy(patches)}),
        lambda s, t, pos: model.decode_step(tparams, s, {"tokens": torch.from_numpy(t),
                                                         "pos": pos}),
        tokens, CHAIN, P + S, lambda x: x.numpy())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(glast.numpy(), np.asarray(wlast), atol=ATOL, rtol=0)
    tlogits, _ = tpre(tparams, {"tokens": torch.from_numpy(tokens),
                                "patches": torch.from_numpy(patches)})
    jlogits, _ = jpre(jparams, {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)


def test_embed_multimodal_matches_reference(bundle):
    from repro_torch.models import vlm as tvlm

    cfg, (jcfg, _, jparams), (_, tparams) = bundle
    tokens, patches = _inputs(cfg, seed=1)
    want = jvlm._embed_multimodal(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(patches))
    got = tvlm._embed_multimodal(cfg, tparams, torch.from_numpy(tokens), torch.from_numpy(patches))
    assert tuple(got.shape) == (2, cfg.vision_tokens + tokens.shape[1], cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_decode_matches_teacher_forcing(bundle):
    cfg, _, (model, tparams) = bundle
    tokens, patches = _inputs(cfg, B=1, S=24, seed=6)
    t, pt = torch.from_numpy(tokens), torch.from_numpy(patches)
    P = cfg.vision_tokens
    full, _ = model.make_prefill()(tparams, {"tokens": t, "patches": pt})
    _, state = model.make_prefill(P + 24)(tparams, {"tokens": t[:, :23], "patches": pt})
    dec, _ = model.decode_step(tparams, state, {"tokens": t[:, 23:], "pos": P + 23})
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_loss_waits_for_the_training_slice(bundle):
    """The training slice has landed: the bundle's loss (prefix-LM over the
    vision prefix, cross-entropy on the text) is the reference's on the same
    tokens, patches and weights (`tests/test_torch_train_families.py` holds
    its gradient)."""
    cfg, (_, jmodel, jparams), (model, params) = bundle
    tokens, patches = _inputs(cfg)
    labels = np.roll(tokens, -1, axis=1)
    want, _ = jmodel.loss(jparams, {"tokens": tokens, "labels": labels, "patches": patches})
    got, metrics = model.loss(params, {"tokens": torch.from_numpy(tokens),
                                       "labels": torch.from_numpy(labels),
                                       "patches": torch.from_numpy(patches)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert set(metrics) == {"ce_loss", "moe_aux"}


def test_full_config_builds_on_meta_with_reference_shapes():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    params = build(cfg).init(seed=0, device="meta")
    abstract = jax.eval_shape(lambda: jvlm.init_lm(jcfg, jax.random.PRNGKey(0))[0])
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
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(params)) == FULL_PARAMS
