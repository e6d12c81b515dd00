"""The port's blocked twins (`repro_torch/kernels/blocked.py`) against the
reference's `repro/kernels/blocked.py`, on the CPU, in fp32 at the
reference's kernel tolerance (2e-5): the cases of `tests/test_kernels.py`'s
`TestBlockedAttention` and `TestSequentialSSD` (causal with GQA and a
ragged chunk, sliding windows, prefix-LM and bidirectional, a gradient
through the checkpointed chunks, the non-static-window fallback), with the
same inputs made from a seed with numpy on both sides. The config knobs
select the twins on the CPU route only (`attention_impl="blocked"`,
`ssd_impl="sequential"`), and a REDUCED model's loss is the same either
way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import blocked as jblocked  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import blocked, ops  # noqa: E402
from repro_torch.models import build  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _qkv(seed, B, S, H, KV, hd):
    return _rand(seed, (B, S, H, hd)), _rand(seed + 1, (B, S, KV, hd)), _rand(seed + 2, (B, S, KV, hd))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 256, 2, 2, 32),
    (2, 1024, 8, 2, 64),
    (1, 384, 6, 2, 32),   # non-pow2 seq: chunk divisor fallback
])
def test_causal_matches_reference(B, S, H, KV, hd):
    q, k, v = _qkv(B * 100 + S, B, S, H, KV, hd)
    want = jblocked.attention_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = ops.attention(*_t(q, k, v), causal=True, impl="blocked")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [64, 250, 512, 1000])
def test_sliding_window_band_matches_reference(window):
    q, k, v = _qkv(7, 1, 1024, 4, 4, 32)
    want = jblocked.attention_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=True, window=window)
    got = ops.attention(*_t(q, k, v), causal=True, window=window, impl="blocked")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kwargs", [dict(causal=True, prefix_len=96), dict(causal=False)],
                         ids=["prefix", "bidirectional"])
def test_prefix_and_noncausal_match_reference(kwargs):
    q, k, v = _qkv(8, 1, 512, 2, 2, 32)
    want = jblocked.attention_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs)
    got = ops.attention(*_t(q, k, v), impl="blocked", **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [0, 128])
def test_gradient_matches_reference(window):
    """The checkpointed backward (blocks recomputed) against the
    reference's jax.grad through its checkpointed scan."""
    q, k, v = _qkv(9, 1, 512, 2, 2, 32)
    want = jax.grad(lambda q: jblocked.attention_blocked(
        q, jnp.asarray(k), jnp.asarray(v), causal=True, window=window).sum())(jnp.asarray(q))
    qt, kt, vt = _t(q, k, v)
    qt.requires_grad_(True)
    ops.attention(qt, kt, vt, causal=True, window=window, impl="blocked").sum().backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(want), **TOL)


def test_tensor_window_falls_back_to_plain_version():
    """A window that is not a Python int (the reference's traced window)
    takes the plain version, as the reference falls back to its oracle."""
    from repro_torch.kernels import ref

    q, k, v = _t(*_qkv(10, 1, 128, 2, 2, 32))
    got = ops.attention(q, k, v, causal=True, window=torch.tensor(64), impl="blocked")
    want = ref.attention(q, k, v, causal=True, window=64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    blocked_out = ops.attention(q, k, v, causal=True, window=64, impl="blocked")
    np.testing.assert_allclose(blocked_out.numpy(), want.numpy(), **TOL)


def _scan_inputs(seed, B, H, S, dk, dv):
    q = _rand(seed, (B, H, S, dk), 0.5)
    k = _rand(seed + 1, (B, H, S, dk), 0.5)
    v = _rand(seed + 2, (B, H, S, dv), 0.5)
    la = -np.log1p(np.exp(_rand(seed + 3, (B, H, S)))).astype(np.float32)  # -softplus
    return q, k, v, la


@pytest.mark.parametrize("B,H,S,dk,dv,chunk", [
    (1, 2, 128, 16, 16, 64),
    (2, 3, 256, 16, 32, 64),
    (1, 1, 512, 32, 64, 128),
])
def test_sequential_scan_matches_reference(B, H, S, dk, dv, chunk):
    q, k, v, la = _scan_inputs(B * 1000 + S, B, H, S, dk, dv)
    wy, ws = jblocked.gated_linear_scan_sequential(*map(jnp.asarray, (q, k, v, la)), chunk=chunk)
    gy, gs = ops.gated_linear_scan(*_t(q, k, v, la), chunk=chunk, impl="sequential")
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


def test_sequential_scan_initial_state_and_gradient_match_reference():
    q, k, v, la = _scan_inputs(42, 1, 2, 128, 16, 16)
    s0 = _rand(46, (1, 2, 16, 16), 0.1)
    wy, wf = jblocked.gated_linear_scan_sequential(*map(jnp.asarray, (q, k, v, la)), chunk=32,
                                                   initial_state=jnp.asarray(s0))
    gy, gf = ops.gated_linear_scan(*_t(q, k, v, la), chunk=32, initial_state=torch.from_numpy(s0),
                                   impl="sequential")
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), **TOL)
    want = jax.grad(lambda v: jblocked.gated_linear_scan_sequential(
        jnp.asarray(q), jnp.asarray(k), v, jnp.asarray(la), chunk=32)[0].sum())(jnp.asarray(v))
    qt, kt, vt, lat = _t(q, k, v, la)
    vt.requires_grad_(True)
    ops.gated_linear_scan(qt, kt, vt, lat, chunk=32, impl="sequential")[0].sum().backward()
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(want), **TOL)


def test_sequential_scan_normaliser_is_two_scans():
    """``normaliser=True`` on the sequential route: the scan of v and of
    v = ones, as the plain route's two calls."""
    q, k, v, la = _t(*_scan_inputs(3, 1, 2, 64, 16, 8))
    n0 = torch.zeros((1, 2, 16, 1))
    got = ops.gated_linear_scan(q, k, v, la, chunk=32, normaliser=True, initial_normaliser=n0,
                                impl="sequential")
    want = ops.gated_linear_scan(q, k, v, la, chunk=32, normaliser=True, initial_normaliser=n0)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("arch,knob", [("gemma3-1b", dict(attention_impl="blocked")),
                                       ("whisper-small", dict(attention_impl="blocked")),
                                       ("zamba2-7b", dict(ssd_impl="sequential")),
                                       ("xlstm-125m", dict(ssd_impl="sequential"))])
def test_config_knobs_select_the_twins_with_the_same_loss(arch, knob, monkeypatch):
    """A REDUCED model's loss with the knob equals its loss without, and the
    twin really ran (counted through a wrapper)."""
    cfg = get_config(arch, reduced=True)
    model = build(cfg)
    params = model.init(seed=0, device="cpu")
    batch = model.make_batch(1, ShapeConfig("t", 64, 2, "train"), device="cpu")
    want, _ = model.loss(params, batch)
    calls = []
    name = "attention_blocked" if "attention_impl" in knob else "gated_linear_scan_sequential"
    orig = getattr(blocked, name)
    monkeypatch.setattr(blocked, name, lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    twin = build(cfg.replace(**knob))
    got, _ = twin.loss(params, batch)
    assert calls
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5)
