"""whisper-small, the encoder-decoder (audio) family, on the port against
the JAX reference.

New here: the bidirectional encoder over stub frame embeddings (1500
frames at full width, 32 REDUCED), cross-attention of every decoder layer
to encoder K/V computed once a request at prefill (``causal=False``, one
query a decode step), and a decoder state of per-layer self-attention
caches beside the cross K/V. For REDUCED fp32, with the reference's
`init_lm(PRNGKey(0))` weights bridged in (`params_from_jax`):

* the config copies equal the reference's, full and REDUCED;
* the encoder output and every layer's cross K/V within 1e-4 of the
  reference's;
* `ModelBundle.make_prefill(max_len)` logits within 1e-4, and a greedy
  chain of 16 tokens through `decode_step` identical to the reference's;
* every layer's state tensors are its own (the port writes them in place);
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
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch.configs import PORTED_ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models.bridge import params_from_jax, unstack_encdec  # noqa: E402

ARCH = "whisper-small"
ATOL = 1e-4
CHAIN = 16
FULL_PARAMS = 279_045_120  # untied embeddings


@pytest.fixture(scope="module")
def bundle():
    jcfg = jax_get_config(ARCH, reduced=True)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, reduced=True)
    tparams = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, (jcfg, jmodel, jparams), (build(cfg), tparams)


def _inputs(cfg, B=2, S=5, seed=0):
    """Tokens and frames scaled by 0.02, as the reference's `make_batch`."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.encoder_context, cfg.d_model)) * 0.02).astype(np.float32)
    return tokens, frames


def _greedy(prefill, decode, tokens, steps, first_pos, to_np):
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
        assert cfg.family == "audio" and build(cfg).paged_ops is None


def test_bridge_unstacks_encoder_and_decoder(bundle):
    cfg, (_, _, jparams), (_, tparams) = bundle
    assert len(tparams["encoder"]) == cfg.encoder_layers
    assert len(tparams["decoder"]) == cfg.num_layers
    for i, layer in enumerate(tparams["decoder"]):
        assert set(layer) == {"ln1", "attn", "ln_x", "cross", "ln2", "ffn"}
        assert layer["ln_x"].dtype == torch.float32
        np.testing.assert_array_equal(layer["cross"]["wk"].numpy(),
                                      np.asarray(jparams["decoder"]["cross"]["wk"][i]))
    np.testing.assert_array_equal(tparams["enc_pos"].numpy(), np.asarray(jparams["enc_pos"]))
    assert tparams["enc_norm"].dtype == torch.float32


def test_encoder_and_cross_kv_match_reference(bundle):
    cfg, (jcfg, _, jparams), (_, tparams) = bundle
    _, frames = _inputs(cfg)
    want = jax.jit(lambda p, f: jencdec.encode(jcfg, p, f))(jparams, jnp.asarray(frames))
    got = tencdec.encode(cfg, tparams, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    jk, jv = jencdec._decoder_cross_kv(jcfg, jparams, want)
    for i, (k, v) in enumerate(tencdec._decoder_cross_kv(cfg, tparams, got)):
        assert k.is_contiguous() and v.is_contiguous()
        np.testing.assert_allclose(k.numpy(), np.asarray(jk[i]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv[i]), atol=ATOL, rtol=0)


def test_prefill_logits_and_greedy_chain_match_reference(bundle):
    cfg, (_, jmodel, jparams), (model, tparams) = bundle
    tokens, frames = _inputs(cfg)
    S = tokens.shape[1]
    max_len = S + CHAIN
    jpre = jax.jit(jmodel.make_prefill(max_len))
    jdec = jax.jit(jmodel.decode_step)
    want, wlast = _greedy(
        lambda t: jpre(jparams, {"tokens": jnp.asarray(t), "frames": jnp.asarray(frames)}),
        lambda s, t, pos: jdec(jparams, s, {"tokens": jnp.asarray(t), "pos": jnp.int32(pos)}),
        tokens, CHAIN, S, np.asarray)
    tpre = model.make_prefill(max_len)
    got, glast = _greedy(
        lambda t: tpre(tparams, {"tokens": torch.from_numpy(t),
                                 "frames": torch.from_numpy(frames)}),
        lambda s, t, pos: model.decode_step(tparams, s, {"tokens": torch.from_numpy(t),
                                                         "pos": pos}),
        tokens, CHAIN, S, lambda x: x.numpy())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(glast.numpy(), np.asarray(wlast), atol=ATOL, rtol=0)
    tlogits, _ = tpre(tparams, {"tokens": torch.from_numpy(tokens),
                                "frames": torch.from_numpy(frames)})
    jlogits, _ = jpre(jparams, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)


def test_every_layer_owns_its_state(bundle):
    cfg = bundle[0]
    states = tencdec.init_states(cfg, 2, 12, device="cpu")
    ptrs = [t.data_ptr() for name in ("k", "v", "cross_k", "cross_v") for t in states[name]]
    assert len(ptrs) == 4 * cfg.num_layers == len(set(ptrs))
    assert tuple(states["cross_k"][0].shape) == (2, cfg.encoder_context, cfg.num_kv_heads,
                                                 cfg.resolved_head_dim)


def test_decode_matches_teacher_forcing(bundle):
    cfg, _, (model, tparams) = bundle
    tokens, frames = _inputs(cfg, B=1, S=24, seed=6)
    t, fr = torch.from_numpy(tokens), torch.from_numpy(frames)
    full, _ = model.make_prefill()(tparams, {"tokens": t, "frames": fr})
    _, state = model.make_prefill(24)(tparams, {"tokens": t[:, :23], "frames": fr})
    dec, _ = model.decode_step(tparams, state, {"tokens": t[:, 23:], "pos": 23})
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_loss_waits_for_the_training_slice(bundle):
    """The training slice has landed: the bundle's loss (the teacher-forced
    decoder over the encoded frames) is the reference's on the same tokens,
    frames and weights (`tests/test_torch_train_families.py` holds its
    gradient)."""
    cfg, (_, jmodel, jparams), (model, params) = bundle
    tokens, frames = _inputs(cfg)
    labels = np.roll(tokens, -1, axis=1)
    want, _ = jmodel.loss(jparams, {"tokens": tokens, "labels": labels, "frames": frames})
    got, metrics = model.loss(params, {"tokens": torch.from_numpy(tokens),
                                       "labels": torch.from_numpy(labels),
                                       "frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert set(metrics) == {"ce_loss", "moe_aux"}


def test_full_config_builds_on_meta_with_reference_shapes():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    params = build(cfg).init(seed=0, device="meta")
    abstract = jax.eval_shape(lambda: jencdec.init_lm(jcfg, jax.random.PRNGKey(0))[0])
    stand_in = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), abstract)
    want = unstack_encdec(cfg, stand_in)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(params) == shapes(want)
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(params)) == FULL_PARAMS
