"""The port's kernel layer against the JAX reference.

On the CPU the port's plain PyTorch versions (`repro_torch.kernels.ref`,
`fused_linear.fused_linear_ref`) are held against the reference's Pallas
kernels (interpret mode, through `repro.kernels.ops` with ``impl="pallas"``
or the kernel module itself) and its jnp oracles, on the same numpy inputs,
at the reference's own tolerances (`tests/test_kernels.py`: 2e-5 fp32 /
2e-2 bf16 for attention and dense decode, 2e-5 for fused_linear;
`tests/test_kernels_paged.py`: 1e-5 fp32 / 5e-2 bf16 for paged decode; 2e-5
fp32 / 2e-2 bf16 for the gated linear scan). Tests marked ``gpu`` hold the CUDA kernels
against the plain versions on the card at the serving path's shapes; they
skip where there is no card, and they need no JAX (the machine with the card
may not have it; there the reference comparisons skip instead).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the JAX reference, on the CPU
    import jax.numpy as jnp

    from repro.kernels import fused_linear as jlinear
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = jops = jref = jlinear = None
from repro_torch.kernels import build as tbuild  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import decode_core as tcore  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import fused_linear as tlinear  # noqa: E402
from repro_torch.kernels import linear_scan as tscan  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_decode_attention as tpaged  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LINEAR_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PAGED_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H100_SMS = 132


@pytest.fixture
def reference():
    if jref is None:
        pytest.skip("needs the JAX reference package (jax is not installed)")


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (both round fp32 to
    bf16 to nearest even)."""
    return jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(TDT[dtype])


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# flash attention: port's plain version vs JAX flash (interpret) and oracle
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, KV, hd, kwargs, dtype); Sq <= 128 or a multiple of 128
# wherever the JAX Pallas kernel runs (its block-multiple assertion)
ATTN_CASES = [
    pytest.param(1, 128, 128, 1, 1, 64, {}, "float32", id="causal"),
    pytest.param(2, 128, 128, 8, 2, 32, {}, "bfloat16", id="gqa"),
    pytest.param(1, 128, 128, 4, 1, 256, {}, "bfloat16", id="mqa-hd256"),
    pytest.param(1, 256, 256, 4, 1, 256, {"window": 64}, "float32", id="mqa-hd256-window"),
    pytest.param(1, 128, 128, 4, 2, 16, {"window": 16}, "float32", id="window-hd16"),
    pytest.param(1, 128, 128, 2, 1, 32, {"prefix_len": 48}, "bfloat16", id="prefix"),
    pytest.param(1, 64, 128, 4, 1, 64, {"q_offset": 64}, "float32", id="q-offset"),
    pytest.param(1, 37, 37, 4, 1, 256, {"window": 8}, "bfloat16", id="ragged-37"),
    pytest.param(2, 96, 96, 4, 4, 32, {"causal": False}, "float32", id="non-causal"),
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,kw,dtype", ATTN_CASES)
def test_attention_plain_matches_jax_flash_and_oracle(reference, B, Sq, Skv, H, KV, hd, kw,
                                                     dtype):
    rng = np.random.default_rng(Sq * 31 + H * 7 + hd)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    got = tops.attention(tq, tk, tv, **kw)
    assert got.dtype == TDT[dtype] and got.shape == (B, Sq, H, hd)
    tol = ATTN_TOL[dtype]
    want_flash = jops.attention(jq, jk, jv, impl="pallas", **kw)
    want_ref = jref.attention(jq, jk, jv, **kw)
    np.testing.assert_allclose(_np(got), _np(want_flash), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(want_ref), rtol=tol, atol=tol)


def test_mask_matches_reference(reference):
    for kw in ({"causal": True, "window": 0, "prefix_len": 0, "q_offset": 0},
               {"causal": True, "window": 5, "prefix_len": 9, "q_offset": 3},
               {"causal": False, "window": 4, "prefix_len": 0, "q_offset": 0}):
        want = np.asarray(jref._build_mask(13, 17, **kw))
        got = tref._build_mask(13, 17, **kw).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# paged decode: port's plain version vs JAX Pallas (interpret) and oracle
# ---------------------------------------------------------------------------


def _pool_case(seed, *, B, H, KV, hd, page, n_pages, pool_pages, pos, poison=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((pool_pages, page, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((pool_pages, page, KV, hd)).astype(np.float32)
    if poison:  # the null page must never leak into the output
        kp[0] = 1e4
        vp[0] = 1e4
    table = np.zeros((B, n_pages), np.int32)
    for b in range(B):
        used = min(n_pages, pos[b] // page + 1)  # null padding past the allocation
        table[b, :used] = rng.permutation(pool_pages - 1)[:used] + 1
    return q, kp, vp, table, np.asarray(pos, np.int32)


_MQA = dict(B=8, H=4, KV=1, hd=256, page=16, n_pages=4, pool_pages=40,
            pos=[0, 15, 16, 20, 33, 47, 50, 63])
PAGED_CASES = [
    pytest.param(dict(B=4, H=8, KV=2, hd=16, page=8, n_pages=4, pool_pages=24,
                      pos=[0, 7, 12, 31]), 0, "float32", id="uneven-partial-pages-fp32"),
    pytest.param(dict(B=4, H=8, KV=2, hd=16, page=8, n_pages=4, pool_pages=24,
                      pos=[0, 7, 12, 31]), 0, "bfloat16", id="uneven-partial-pages-bf16"),
    pytest.param(dict(B=3, H=4, KV=1, hd=16, page=8, n_pages=6, pool_pages=20,
                      pos=[2, 17, 40], poison=True), 0, "float32", id="null-padding"),
    pytest.param(dict(B=4, H=4, KV=1, hd=32, page=8, n_pages=4, pool_pages=20,
                      pos=[3, 9, 20, 31]), 6, "float32", id="window"),
    pytest.param(dict(_MQA, poison=True), 0, "bfloat16", id="mqa-hd256"),
    pytest.param(_MQA, 24, "bfloat16", id="mqa-hd256-window"),
    # granite-20b's 48 query heads over 1 KV head (head groups on the card)
    pytest.param(dict(B=2, H=48, KV=1, hd=128, page=8, n_pages=4, pool_pages=12,
                      pos=[5, 31]), 0, "float32", id="groups-48"),
]


@pytest.mark.parametrize("case,window,dtype", PAGED_CASES)
def test_paged_plain_matches_jax_pallas_and_oracle(reference, case, window, dtype):
    q, kp, vp, table, pos = _pool_case(1, **case)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(kp, dtype), _pair(vp, dtype)
    got = tops.paged_decode_attention(
        tq, tk, tv, torch.from_numpy(table), torch.from_numpy(pos), window=window)
    assert got.dtype == TDT[dtype] and got.shape == q.shape
    tol = PAGED_TOL[dtype]
    jt, jp = jnp.asarray(table), jnp.asarray(pos)
    want_pallas = jops.paged_decode_attention(jq, jk, jv, jt, jp, window=window, impl="pallas")
    want_ref = jref.paged_decode_attention(jq, jk, jv, jt, jp, window=window)
    np.testing.assert_allclose(_np(got), _np(want_pallas), atol=tol)
    np.testing.assert_allclose(_np(got), _np(want_ref), atol=tol)
    assert np.all(np.abs(_np(got)) < 1e3)


# ---------------------------------------------------------------------------
# dense decode: port's plain version vs JAX Pallas (interpret) and oracle
# ---------------------------------------------------------------------------


def _decode_case(seed, *, B, S, H, KV, hd, pos, poison=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    if poison:  # cache slots past each slot's pos must never leak into the output
        for b, p in enumerate(np.broadcast_to(pos, (B,))):
            kc[b, p + 1 :] = 999.0
            vc[b, p + 1 :] = -999.0
    return q, kc, vc, pos


# S a multiple of min(512, S) wherever the JAX Pallas kernel runs (its
# block-multiple assertion); shapes of `tests/test_kernels.py::DECODE_SHAPES`
# plus per-slot positions, poison past pos, a REDUCED ring of 16 and
# gemma3's head_dim 256
DECODE_CASES = [
    pytest.param(dict(B=1, S=512, H=4, KV=4, hd=64, pos=256), id="s512"),
    pytest.param(dict(B=2, S=1024, H=8, KV=2, hd=64, pos=512), id="s1024-gqa"),
    pytest.param(dict(B=4, S=2048, H=8, KV=1, hd=128, pos=1024), id="s2048-mqa"),
    pytest.param(dict(B=3, S=512, H=4, KV=4, hd=64, pos=[10, 200, 511]), id="per-slot-pos"),
    pytest.param(dict(B=2, S=256, H=2, KV=1, hd=32, pos=[100, 37], poison=True), id="poison"),
    pytest.param(dict(B=4, S=16, H=4, KV=1, hd=16, pos=[0, 5, 15, 15]), id="ring-16"),
    pytest.param(dict(B=8, S=64, H=4, KV=1, hd=256, pos=[0, 1, 15, 16, 31, 40, 62, 63]),
                 id="mqa-hd256"),
    pytest.param(dict(B=2, S=512, H=48, KV=1, hd=128, pos=[40, 511]), id="groups-48"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_jax_pallas_and_oracle(reference, case, dtype):
    q, kc, vc, pos = _decode_case(5, **case)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(kc, dtype), _pair(vc, dtype)
    # the window reaches the plain version only, which ignores it as the
    # reference's oracle does
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(pos), window=16)
    assert got.dtype == TDT[dtype] and got.shape == q.shape
    tol = ATTN_TOL[dtype]
    jp = jnp.asarray(pos)
    want_pallas = jops.decode_attention(jq, jk, jv, jp, impl="pallas")
    want_ref = jref.decode_attention(jq, jk, jv, jp, window=16)
    np.testing.assert_allclose(_np(got), _np(want_pallas), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(want_ref), rtol=tol, atol=tol)
    if case.get("poison"):
        clean = _decode_case(5, **dict(case, poison=False))
        base = tref.decode_attention(*(torch.from_numpy(a) for a in clean[:3]),
                                     torch.from_numpy(pos))
        np.testing.assert_allclose(_np(got), _np(base), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# fused linear: port's plain version vs JAX Pallas (interpret) and oracle
# ---------------------------------------------------------------------------

# (M, K, N, act, Pallas blocks (bm, bn, bk)): `tests/test_kernels.py::
# TestFusedLinear`'s shapes, Test Case 2's two layers with the reference
# app's blocks, and a ragged shape the Pallas blocks divide
LINEAR_CASES = [
    pytest.param(256, 128, 256, "gelu", (128, 128, 128), id="256x128x256-gelu"),
    *[pytest.param(M, K, N, act, (128, 128, 128), id=f"{M}x{K}x{N}-{act}")
      for M, K, N in [(128, 128, 128), (256, 384, 128)] for act in ("none", "relu", "gelu")],
    pytest.param(256, 64, 32, "relu", (8, 16, 16), id="tc2-layer1"),
    pytest.param(256, 32, 10, "none", (8, 10, 16), id="tc2-layer2"),
    pytest.param(77, 50, 10, "gelu", (7, 10, 10), id="ragged-77x50x10"),
]


@pytest.mark.parametrize("M,K,N,act,blocks", LINEAR_CASES)
def test_fused_linear_plain_matches_jax_pallas_and_oracle(reference, M, K, N, act, blocks):
    rng = np.random.default_rng(M + 7 * K + 31 * N)
    x = (0.3 * rng.standard_normal((M, K))).astype(np.float32)
    w = (0.3 * rng.standard_normal((K, N))).astype(np.float32)
    b = (0.3 * rng.standard_normal((N,))).astype(np.float32)
    got = tops.fused_linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                            act=act)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    bm, bn, bk = blocks
    want_pallas = jlinear.fused_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act,
                                       block_m=bm, block_n=bn, block_k=bk, interpret=True)
    want_ref = jlinear.fused_linear_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act)
    tol = LINEAR_TOL["float32"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=tol, atol=tol)


def test_fused_linear_bf16_output_in_x_dtype(reference):
    rng = np.random.default_rng(8)
    x, w = rng.standard_normal((64, 48)).astype(np.float32), rng.standard_normal((48, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = _pair(x, "bfloat16"), _pair(w, "bfloat16"), _pair(b, "bfloat16")
    got = tops.fused_linear(tx, tw, tb, act="relu")
    assert got.dtype == torch.bfloat16
    want = jlinear.fused_linear_ref(jx, jw, jb, act="relu")
    np.testing.assert_allclose(_np(got), _np(want), rtol=LINEAR_TOL["bfloat16"],
                               atol=LINEAR_TOL["bfloat16"])
    with pytest.raises(ValueError, match="act"):
        tops.fused_linear(tx, tw, tb, act="tanh")


# ---------------------------------------------------------------------------
# gated linear scan: port's plain version vs JAX Pallas (interpret) and oracle
# ---------------------------------------------------------------------------

SCAN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# `tests/test_kernels.py::SCAN_SHAPES`: (B, H, S, dk, dv, chunk)
SCAN_SHAPES = [
    (1, 1, 128, 32, 32, 64),
    (2, 4, 256, 64, 64, 128),
    (1, 2, 256, 16, 64, 64),  # dk != dv (Mamba2 shape)
    (2, 2, 512, 32, 16, 128),
]


def _scan_inputs(seed, B, H, S, dk, dv, *, state=False):
    """The reference test's scales: q, k, v ~ 0.5 N(0, 1), log_a = -softplus(N(0, 1))."""
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((B, H, S, dk))).astype(np.float32)
    k = (0.5 * rng.standard_normal((B, H, S, dk))).astype(np.float32)
    v = (0.5 * rng.standard_normal((B, H, S, dv))).astype(np.float32)
    la = (-np.logaddexp(0.0, rng.standard_normal((B, H, S)))).astype(np.float32)
    s0 = (0.5 * rng.standard_normal((B, H, dk, dv))).astype(np.float32) if state else None
    return q, k, v, la, s0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,dk,dv,chunk", SCAN_SHAPES)
def test_scan_plain_matches_jax_pallas_and_oracle(reference, B, H, S, dk, dv, chunk, dtype):
    q, k, v, la, _ = _scan_inputs(S + dk + dv, B, H, S, dk, dv)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    y, st = tops.gated_linear_scan(tq, tk, tv, torch.from_numpy(la), chunk=chunk)
    assert y.dtype == TDT[dtype] and y.shape == (B, H, S, dv)
    assert st.dtype == torch.float32 and st.shape == (B, H, dk, dv)
    tol = SCAN_TOL[dtype]
    jla = jnp.asarray(la)
    for want_y, want_s in (jops.gated_linear_scan(jq, jk, jv, jla, chunk=chunk, impl="pallas"),
                           jref.gated_linear_scan(jq, jk, jv, jla, chunk=chunk)):
        np.testing.assert_allclose(_np(y), _np(want_y), rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(st), _np(want_s), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,dk,dv,chunk", [
    (2, 4, 64, 32, 32, 64),    # REDUCED xlstm's mLSTM heads
    (2, 4, 64, 32, 1, 64),     # its normaliser (v = ones)
    (3, 2, 1, 32, 32, 1),      # a decode step
    (1, 2, 96, 16, 24, 32),    # dk != dv
])
def test_scan_plain_with_initial_state_matches_jax_ops(reference, B, H, S, dk, dv, chunk, dtype):
    """A carried state: the reference's `ops` call (its Pallas wrapper routes
    this case to the oracle), as xlstm prefill and decode make it."""
    q, k, v, la, s0 = _scan_inputs(7 * S + dv, B, H, S, dk, dv, state=True)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    y, st = tops.gated_linear_scan(tq, tk, tv, torch.from_numpy(la), chunk=chunk,
                                   initial_state=torch.from_numpy(s0))
    tol = SCAN_TOL[dtype]
    jla, js0 = jnp.asarray(la), jnp.asarray(s0)
    for impl in ("pallas", "ref"):
        want_y, want_s = jops.gated_linear_scan(jq, jk, jv, jla, chunk=chunk,
                                                initial_state=js0, impl=impl)
        np.testing.assert_allclose(_np(y), _np(want_y), rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(st), _np(want_s), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,dk,dv,chunk,state", [
    (2, 4, 64, 32, 32, 64, False),   # REDUCED xlstm's forward
    (2, 4, 64, 32, 32, 64, True),    # its prefill carrying states
    (3, 2, 1, 32, 32, 1, True),      # a decode step
    (1, 2, 96, 16, 24, 32, True),    # dk != dv
    (1, 1, 128, 32, 32, 64, False),  # a reference SCAN_SHAPE
])
def test_scan_plain_normaliser_matches_jax_two_calls(reference, B, H, S, dk, dv, chunk, state,
                                                     dtype):
    """The fused call (``normaliser=True``) on the CPU equals the reference's
    two calls, with v and with v = ones (its mLSTM block), through its Pallas
    wrapper and its oracle."""
    q, k, v, la, s0 = _scan_inputs(5 * S + dk + dv, B, H, S, dk, dv, state=state)
    n0 = (np.random.default_rng(S).standard_normal((B, H, dk, 1)).astype(np.float32)
          if state else None)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    kw = dict(initial_state=torch.from_numpy(s0), initial_normaliser=torch.from_numpy(n0)) \
        if state else {}
    y, st, nrm, n = tops.gated_linear_scan(tq, tk, tv, torch.from_numpy(la), chunk=chunk,
                                           normaliser=True, **kw)
    assert nrm.dtype == TDT[dtype] and nrm.shape == (B, H, S, 1)
    assert n.dtype == torch.float32 and n.shape == (B, H, dk, 1)
    tol = SCAN_TOL[dtype]
    jla = jnp.asarray(la)
    jones = jnp.ones((B, H, S, 1), jq.dtype)
    for impl in ("pallas", "ref"):
        js0 = dict(initial_state=jnp.asarray(s0)) if state else {}
        jn0 = dict(initial_state=jnp.asarray(n0)) if state else {}
        want_y, want_s = jops.gated_linear_scan(jq, jk, jv, jla, chunk=chunk, impl=impl, **js0)
        want_nrm, want_n = jops.gated_linear_scan(jq, jk, jones, jla, chunk=chunk, impl=impl,
                                                  **jn0)
        for got, want in ((y, want_y), (st, want_s), (nrm, want_nrm), (n, want_n)):
            np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_scan_chunk_invariance_and_step_match_reference(reference):
    """The chunk is a tiling knob (the kernel ignores it); the chunkwise form
    equals the per-step recurrence, and the port's step equals the
    reference's."""
    B, H, S, dk, dv = 1, 2, 64, 16, 16
    q, k, v, la, s0 = _scan_inputs(22, B, H, S, dk, dv, state=True)
    tq, tk, tv, tla, ts0 = (torch.from_numpy(a) for a in (q, k, v, la, s0))
    tol = SCAN_TOL["float32"]
    y64, s64 = tref.gated_linear_scan(tq, tk, tv, tla, chunk=64, initial_state=ts0)
    y16, s16 = tref.gated_linear_scan(tq, tk, tv, tla, chunk=16, initial_state=ts0)
    torch.testing.assert_close(y16, y64, rtol=tol, atol=tol)
    torch.testing.assert_close(s16, s64, rtol=tol, atol=tol)
    state, jstate, ys = ts0, jnp.asarray(s0), []
    for t in range(S):
        y_t, state = tref.gated_linear_step(tq[:, :, t], tk[:, :, t], tv[:, :, t], tla[:, :, t],
                                            state)
        jy_t, jstate = jref.gated_linear_step(*(jnp.asarray(a[:, :, t]) for a in (q, k, v, la)),
                                              jstate)
        np.testing.assert_allclose(_np(y_t), _np(jy_t), rtol=tol, atol=tol)
        ys.append(y_t)
    torch.testing.assert_close(torch.stack(ys, dim=2), y64, rtol=tol, atol=tol)
    torch.testing.assert_close(state, s64, rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(state), _np(jstate), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="divisible"):
        tref.gated_linear_scan(tq[:, :, :63], tk[:, :, :63], tv[:, :, :63], tla[:, :, :63],
                               chunk=16)


# ---------------------------------------------------------------------------
# dispatch by device
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    tops.reset_launch_counts()
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 9, 1, 16)).astype(np.float32))
    torch.testing.assert_close(tops.attention(q, k, k, window=4), tref.attention(q, k, k, window=4),
                               rtol=0, atol=0)
    qd, kp, vp, table, pos = (torch.from_numpy(a) for a in _pool_case(
        2, B=2, H=4, KV=1, hd=16, page=4, n_pages=3, pool_pages=8, pos=[5, 11]))
    torch.testing.assert_close(tops.paged_decode_attention(qd, kp, vp, table, pos),
                               tref.paged_decode_attention(qd, kp, vp, table, pos),
                               rtol=0, atol=0)
    qd, kc, vc, pos = (torch.from_numpy(a) for a in _decode_case(
        4, B=2, S=12, H=4, KV=1, hd=16, pos=[3, 11]))
    torch.testing.assert_close(tops.decode_attention(qd, kc, vc, pos),
                               tref.decode_attention(qd, kc, vc, pos), rtol=0, atol=0)
    x, w, b = torch.randn(5, 7), torch.randn(7, 3), torch.randn(3)
    torch.testing.assert_close(tops.fused_linear(x, w, b, act="gelu"),
                               tlinear.fused_linear_ref(x, w, b, act="gelu"), rtol=0, atol=0)
    q, k, v, la, s0 = (torch.from_numpy(a) for a in _scan_inputs(9, 2, 2, 32, 8, 4, state=True))
    for got, want in zip(tops.gated_linear_scan(q, k, v, la, chunk=16, initial_state=s0),
                         tref.gated_linear_scan(q, k, v, la, chunk=16, initial_state=s0)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    n0 = torch.ones((2, 2, 8, 1))
    fused = tops.gated_linear_scan(q, k, v, la, chunk=16, initial_state=s0, normaliser=True,
                                   initial_normaliser=n0)
    ones = torch.ones((2, 2, 32, 1))
    two_calls = (*tref.gated_linear_scan(q, k, v, la, chunk=16, initial_state=s0),
                 *tref.gated_linear_scan(q, k, ones, la, chunk=16, initial_state=n0))
    for got, want in zip(fused, two_calls, strict=True):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tops.launch_counts() == {"flash_attention": 0, "paged_decode_attention": 0,
                                    "decode_attention": 0, "fused_linear": 0,
                                    "gated_linear_scan": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch the CUDA kernel or raise: a CPU tensor never
    reaches a silent fallback inside them."""
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        tpaged.paged_decode_attention(
            torch.zeros((2, 4, 16)), torch.zeros((3, 4, 1, 16)), torch.zeros((3, 4, 1, 16)),
            torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tdecode.decode_attention(torch.zeros((2, 4, 16)), torch.zeros((2, 8, 1, 16)),
                                 torch.zeros((2, 8, 1, 16)), torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tlinear.fused_linear(torch.zeros((4, 8)), torch.zeros((8, 2)), torch.zeros((2,)))
    with pytest.raises(ValueError, match="CUDA"):
        tscan.gated_linear_scan(torch.zeros((1, 2, 5, 8)), torch.zeros((1, 2, 5, 8)),
                                torch.zeros((1, 2, 5, 1)), torch.zeros((1, 2, 5)))


def test_scan_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 2, 5, 8))
    with pytest.raises(ValueError, match="log_a"):
        tscan.gated_linear_scan(q, q, q, torch.zeros((1, 2, 4)))
    with pytest.raises(ValueError, match="dk"):
        big = torch.zeros((1, 1, 2, tscan.MAX_DK + 1))
        tscan.gated_linear_scan(big, big, q[:1, :1, :2], torch.zeros((1, 1, 2)))
    with pytest.raises(ValueError, match="chunk"):
        tscan.gated_linear_scan(q, q, q, torch.zeros((1, 2, 5)), chunk=0)
    with pytest.raises(ValueError, match="normaliser"):
        tscan.gated_linear_scan(q, q, q, torch.zeros((1, 2, 5)),
                                initial_normaliser=torch.zeros((1, 2, 8, 1)))
    with pytest.raises(ValueError, match="normaliser"):
        tops.gated_linear_scan(q, q, q, torch.zeros((1, 2, 5)),
                               initial_normaliser=torch.zeros((1, 2, 8, 1)))


def _strided(shape, dtype, layout):
    """(B, H, S, d) operands as the paths hand them over: "heads", a view of
    (B, S, H, d); "shared", one (B, 1, S, d) over the heads (Mamba2's C and
    B); "odd-rows", a view of rows 4 bytes longer than d; "unaligned", one
    element into a buffer."""
    B, H, S, d = shape
    if layout == "heads":
        return torch.zeros((B, S, H, d), dtype=dtype).transpose(1, 2)
    if layout == "shared":
        return torch.zeros((B, 1, S, d), dtype=dtype).expand(B, H, S, d)
    if layout == "odd-rows":
        return torch.zeros((B, H, S, d + 2), dtype=dtype)[..., :d]
    return torch.zeros(B * H * S * d + 8, dtype=dtype)[1:1 + B * H * S * d].view(B, H, S, d)


@pytest.mark.parametrize("dtype,S,dk,dv,layout,want", [
    ("bfloat16", 2048, 384, 384, "heads", "mma"),    # xlstm-125m's loss
    ("bfloat16", 777, 384, 384, "heads", "mma"),     # a ragged prefill
    ("bfloat16", 17, 384, 384, "heads", "mma"),
    ("bfloat16", 16, 384, 384, "heads", "step"),     # 16 positions and fewer: the step kernel
    ("bfloat16", 1, 384, 384, "heads", "step"),      # a decode tick
    ("float32", 1, 384, 384, "heads", "step"),
    ("bfloat16", 1024, 64, 224, "shared", "mma"),    # Mamba2's shared C and B
    ("bfloat16", 64, 32, 32, "heads", "mma"),        # REDUCED widths in bf16
    ("float32", 2048, 384, 384, "heads", "simt"),    # fp32 keeps exact FMA
    ("float32", 45, 32, 32, "heads", "simt"),        # REDUCED xlstm
    ("bfloat16", 777, 384, 1, "heads", "simt"),      # the normaliser alone: dv = 1
    ("bfloat16", 256, 512, 64, "heads", "simt"),     # dk past the state the registers hold
    ("bfloat16", 256, 36, 64, "heads", "simt"),      # dk not a multiple of 8
    ("bfloat16", 256, 64, 64, "odd-rows", "simt"),   # rows not 16-byte strided
    ("bfloat16", 256, 64, 64, "unaligned", "simt"),  # not 16-byte aligned
])
def test_scan_variant_rule(dtype, S, dk, dv, layout, want):
    """Which kernel a scan launches: the step kernel for 16 positions or
    fewer; the tensor-core kernel for bf16 with dk <= 384 and 16-byte rows;
    exact FMA for the rest."""
    q = _strided((2, 4, S, dk), TDT[dtype], layout)
    v = _strided((2, 4, S, dv), TDT[dtype], "heads" if layout == "shared" else layout)
    assert tscan.variant(q, q, v) == want
    if dtype == "bfloat16" and S > tscan.STEP_MAX_S:  # the layout alone decides
        assert (tscan.mma_layout_error(q, q, v) is None) == (want == "mma")


@pytest.mark.parametrize("B,H,columns,sms,want", [
    (4, 4, 385, H100_SMS, 64),   # the loss shape with its normaliser: 112 blocks
    (4, 4, 384, H100_SMS, 64),
    (1, 4, 385, H100_SMS, 16),   # a B=1 prefill: 100 blocks of 16 columns
    (2, 4, 385, H100_SMS, 32),   # 104 blocks of 32 columns
    (1, 32, 224, H100_SMS, 64),  # Mamba2: 128 blocks
    (8, 4, 385, H100_SMS, 64),   # no tile fits one wave: the fewest blocks
    (1, 4, 385, 64, 32),
])
def test_scan_tile_rule(B, H, columns, sms, want):
    """The tensor-core kernel's tile: the narrowest whose grid fits one wave
    of the card's SMs, else the widest."""
    assert tscan.tile_columns(B, H, columns, sms) == want


def test_flash_wrapper_rejects_unsupported_head_dim():
    q = torch.zeros((1, 8, 4, 48))
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention(q, q[:, :, :1], q[:, :, :1])


# ---------------------------------------------------------------------------
# the wrappers' variant rules (dtype, shape, alignment; no card needed)
# ---------------------------------------------------------------------------


def _unaligned(shape, dtype):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte boundary."""
    n = math.prod(shape)
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)



@pytest.mark.parametrize("dtype,M,K,N,layout,sms,want", [
    ("bfloat16", 256, 64, 32, "aligned", H100_SMS, "wgmma"),   # Test Case 2's layer 1 in bf16
    ("bfloat16", 4096, 4096, 4096, "aligned", H100_SMS, "wgmma"),
    ("bfloat16", 77, 512, 264, "aligned", H100_SMS, "wgmma"),  # ragged M, N tiles: TMA fills
    ("bfloat16", 256, 32, 10, "aligned", H100_SMS, "simt"),    # N = 10: W's rows not 16-B strided
    ("bfloat16", 256, 50, 32, "aligned", H100_SMS, "simt"),    # K = 50: x's rows not 16-B strided
    ("bfloat16", 256, 64, 32, "unaligned-x", H100_SMS, "simt"),
    ("float32", 256, 64, 32, "aligned", H100_SMS, "simt"),     # Test Case 2: 64 x 64 tiles
    ("float32", 1024, 1024, 1024, "aligned", H100_SMS, "simt"),  # 64 tiles: under a wave
    ("float32", 1024, 1024, 1024, "aligned", 64, "simt_tiled"),  # a wave of a 64-SM card
    ("float32", 1408, 1024, 1408, "aligned", H100_SMS, "simt"),  # 121 tiles
    ("float32", 1536, 1024, 1536, "aligned", H100_SMS, "simt_tiled"),  # 144 tiles
    ("float32", 4096, 4096, 4096, "aligned", H100_SMS, "simt_tiled"),
    ("float32", 4096, 4094, 4096, "aligned", H100_SMS, "simt"),  # K % 4: no 16-byte cp.async
    ("float32", 4096, 4096, 4096, "unaligned-x", H100_SMS, "simt"),
])
def test_fused_linear_variant_rule(monkeypatch, dtype, M, K, N, layout, sms, want):
    monkeypatch.setattr(tbuild, "sm_count", lambda device: sms)
    dt = TDT[dtype]
    x = _unaligned((M, K), dt) if layout == "unaligned-x" else torch.empty((M, K), dtype=dt)
    w, b = torch.empty((K, N), dtype=dt), torch.empty((N,), dtype=dt)
    assert tlinear.variant(x, w, b) == want


@pytest.mark.parametrize("dtype,H,KV,hd,layout,want", [
    ("bfloat16", 4, 1, 256, "aligned", "wgmma"),        # gemma3-1b at full width
    ("bfloat16", 8, 2, 128, "aligned", "wgmma"),
    ("bfloat16", 4, 4, 64, "aligned", "wgmma"),
    ("bfloat16", 64, 1, 64, "aligned", "wgmma"),        # 64 heads: one position a warpgroup
    ("bfloat16", 3, 1, 64, "aligned", "simt"),          # 3 heads a group do not divide 64 rows
    ("bfloat16", 4, 1, 32, "aligned", "simt"),          # REDUCED head dims
    ("bfloat16", 4, 1, 16, "aligned", "simt"),
    ("bfloat16", 4, 1, 256, "unaligned-q", "simt"),
    ("float32", 4, 1, 256, "aligned", "simt"),          # fp32 stays exact: no TF32
])
def test_flash_variant_rule(dtype, H, KV, hd, layout, want):
    dt = TDT[dtype]
    shape = (1, 9, H, hd)
    q = _unaligned(shape, dt) if layout == "unaligned-q" else torch.empty(shape, dtype=dt)
    k = torch.empty((1, 9, KV, hd), dtype=dt)
    assert tflash.variant(q, k, k) == want


@pytest.mark.parametrize("B,Sq,H,KV,sms,want", [
    (1, 1024, 4, 1, H100_SMS, 1),   # a gemma3 prompt: 64 blocks of 16 positions x 4 heads
    (4, 512, 4, 1, H100_SMS, 1),    # 128 blocks: one wave
    (8, 512, 4, 1, H100_SMS, 2),    # the serial engine's prefill: 256 blocks of one
    (1, 1024, 8, 2, H100_SMS, 1),   # GQA 8:2: 2 KV heads x 64
    (8, 1024, 4, 1, H100_SMS, 2),
    (1, 1024, 4, 1, 32, 2),         # the same prompt on a 32-SM card
    (3, 9, 64, 1, H100_SMS, 1),     # 64 heads: one position a warpgroup, 27 blocks
])
def test_flash_consumer_warpgroups_rule(monkeypatch, B, Sq, H, KV, sms, want):
    monkeypatch.setattr(tbuild, "sm_count", lambda device: sms)
    q = torch.empty((B, Sq, H, 64), dtype=torch.bfloat16)
    k = torch.empty((B, Sq, KV, 64), dtype=torch.bfloat16)
    assert tflash.consumer_warpgroups(q, k) == want


@pytest.mark.parametrize("units,sms,want", [
    (1, H100_SMS, 8), (8, H100_SMS, 8),    # gemma3's 8 slots x 1 KV head: the cap of 8
    (64, H100_SMS, 4), (512, H100_SMS, 1),  # 64 x 2 = 128 blocks would not fill 132 SMs
    (1, 114, 8), (8, 114, 8), (64, 114, 2), (512, 114, 1),
    (132, H100_SMS, 1), (33, H100_SMS, 4), (3, 2, 1),
])
def test_decode_cluster_size_rule(monkeypatch, units, sms, want):
    """Blocks a cluster per (slot, KV head): the smallest power of two up to
    8 whose clusters fill one wave of the card's SMs, 1 when the (slot, KV
    head) pairs alone fill it; the same for the dense and the paged layout."""
    monkeypatch.setattr(tbuild, "sm_count", lambda device: sms)
    for B, KV in ((units, 1), (1, units)):
        q = torch.empty((B, 2 * KV, 16), dtype=torch.bfloat16)
        assert tcore.cluster_size(q, torch.empty((B, 32, KV, 16), dtype=torch.bfloat16)) == want
        assert tcore.cluster_size(q, torch.empty((9, 16, KV, 16), dtype=torch.bfloat16)) == want


def test_decode_cluster_size_rule_follows_the_cap(monkeypatch):
    """With the cap raised to the non-portable 16, gemma3's 8 (slot, KV head)
    pairs take clusters of 16 on an H100."""
    monkeypatch.setattr(tbuild, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(tcore, "MAX_CLUSTER", 16)
    q = torch.empty((8, 4, 256), dtype=torch.bfloat16)
    assert tcore.cluster_size(q, torch.empty((8, 1088, 1, 256), dtype=torch.bfloat16)) == 16


@pytest.mark.parametrize("groups,n_groups,per_block", [
    (1, 1, 1), (4, 1, 4), (8, 1, 8),   # one group: the launch of 8 heads or fewer
    (9, 2, 5), (12, 2, 6), (16, 2, 8), (48, 6, 8), (50, 7, 8),
])
def test_decode_head_groups_rule(monkeypatch, groups, n_groups, per_block):
    """More query heads a KV head than a block holds split into groups of at
    most 8 (the last may hold fewer), a grid axis; the cluster size counts
    the (slot, KV head, group) units."""
    assert tcore.head_groups(groups) == n_groups
    assert tcore.block_group(groups) == per_block
    assert per_block * (n_groups - 1) < groups <= per_block * n_groups
    monkeypatch.setattr(tbuild, "sm_count", lambda device: H100_SMS)
    q = torch.empty((8, groups, 128), dtype=torch.bfloat16)
    k = torch.empty((8, 64, 1, 128), dtype=torch.bfloat16)
    units = 8 * n_groups
    want = next(c for c in (1, 2, 4, 8) if c == 8 or units * c >= H100_SMS)
    assert tcore.cluster_size(q, k) == want


@pytest.mark.parametrize("dtype,H,KV,hd,layout,want", [
    ("bfloat16", 4, 1, 256, "aligned", None),     # gemma3-1b at full width
    ("float32", 4, 1, 256, "aligned", None),
    ("bfloat16", 4, 1, 16, "aligned", None),      # REDUCED: 32-byte rows, two lanes a row
    ("float32", 4, 1, 16, "aligned", None),
    ("bfloat16", 8, 1, 128, "aligned", None),     # 8 query heads a KV head
    ("bfloat16", 8, 2, 112, "aligned", None),     # a head_dim between the powers of two
    ("bfloat16", 6, 1, 8, "aligned", None),       # one 16-byte load a row
    ("float32", 4, 4, 36, "aligned", None),
    ("bfloat16", 16, 1, 64, "aligned", None),     # head groups: two of 8
    ("bfloat16", 48, 1, 128, "aligned", None),    # granite-20b: six groups of 8
    ("float32", 12, 1, 128, "aligned", None),     # two groups of 6
    ("bfloat16", 4, 1, 512, "aligned", "head_dim 512"),
    ("bfloat16", 4, 1, 100, "aligned", "head_dim 100 of 2-byte elements"),
    ("float32", 4, 1, 18, "aligned", "head_dim 18 of 4-byte elements"),
    ("bfloat16", 4, 1, 4, "aligned", "head_dim 4 of 2-byte elements"),
    ("bfloat16", 4, 1, 256, "unaligned-k", "k is not 16-byte aligned"),
    ("float32", 4, 1, 64, "unaligned-v", "v is not 16-byte aligned"),
])
def test_decode_layout_rule(dtype, H, KV, hd, layout, want):
    """The shapes and pointers the decode kernels' 16-byte row loads take;
    the wrappers raise with the reason on any other."""
    dt = TDT[dtype]
    shape = (3, 16, KV, hd)
    k = _unaligned(shape, dt) if layout == "unaligned-k" else torch.empty(shape, dtype=dt)
    v = _unaligned(shape, dt) if layout == "unaligned-v" else torch.empty(shape, dtype=dt)
    got = tcore.layout_error(H, k, v)
    if want is None:
        assert got is None
    else:
        assert got is not None and got.startswith(want)


@pytest.mark.parametrize("dtype,hd,want", [
    ("bfloat16", 256, "mma"),    # gemma3-1b at full width
    ("bfloat16", 128, "mma"), ("bfloat16", 64, "mma"), ("bfloat16", 32, "mma"),
    ("bfloat16", 16, "mma"),     # REDUCED in bf16: one k16 step
    ("bfloat16", 112, "simt"),   # the tensor-core walk is unrolled for powers of two
    ("bfloat16", 48, "simt"),
    ("bfloat16", 8, "simt"),     # not a whole k16 step
    ("bfloat16", 40, "simt"),
    ("float32", 256, "simt"),    # fp32 stays exact: no bf16 products
    ("float32", 16, "simt"),     # REDUCED serving in fp32
])
def test_decode_variant_rule(dtype, hd, want):
    """bf16 rows of 16 to 256 dims, a power of two, are scored on the tensor
    cores, the rest by exact fp32 FMA; the same rule for the dense and the
    paged layout."""
    q = torch.empty((2, 4, hd), dtype=TDT[dtype])
    assert tcore.variant(q, torch.empty((2, 32, 1, hd), dtype=TDT[dtype])) == want
    assert tcore.variant(q, torch.empty((9, 16, 1, hd), dtype=TDT[dtype])) == want


def test_variant_counts_start_at_zero_and_reset():
    tlinear.variant_launches["wgmma"] += 1
    tflash.variant_launches["simt"] += 1
    assert tops.variant_counts()["fused_linear"]["wgmma"] >= 1
    tops.reset_launch_counts()
    assert tops.variant_counts() == {
        "flash_attention": {"simt": 0, "wgmma": 0},
        "paged_decode_attention": {"simt": 0, "mma": 0},
        "decode_attention": {"simt": 0, "mma": 0},
        "fused_linear": {"simt": 0, "simt_tiled": 0, "wgmma": 0},
        "gated_linear_scan": {"simt": 0, "mma": 0, "step": 0},
    }


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel vs its plain version (skips without a GPU)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,window,kw", [
    (37, 0, {}), (300, 512, {}), (1024, 0, {}), (1024, 512, {}),
    (300, 0, {"prefix_len": 100}), (64, 0, {"q_offset": 236}),
])
def test_flash_kernel_matches_plain_on_card(cuda, Sq, window, kw, dtype):
    gen = torch.Generator(device=cuda).manual_seed(Sq)
    Skv = Sq + kw.get("q_offset", 0)
    q = torch.randn((1, Sq, 4, 256), generator=gen, device=cuda).to(TDT[dtype])
    k = torch.randn((1, Skv, 1, 256), generator=gen, device=cuda).to(TDT[dtype])
    v = torch.randn((1, Skv, 1, 256), generator=gen, device=cuda).to(TDT[dtype])
    before = tflash.launches
    got = tops.attention(q, k, v, window=window, **kw)
    want = tref.attention(q, k, v, window=window, **kw)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 512, 5])
def test_paged_kernel_matches_plain_on_card(cuda, window, dtype):
    pos = [0, 15, 16, 100, 511, 512, 777, 1087]
    q, kp, vp, table, pos = (torch.from_numpy(a).to(cuda) for a in _pool_case(
        4, B=8, H=4, KV=1, hd=256, page=16, n_pages=68, pool_pages=545, pos=pos, poison=True))
    q, kp, vp = (x.to(TDT[dtype]) for x in (q, kp, vp))
    before = tpaged.launches
    got = tops.paged_decode_attention(q, kp, vp, table, pos, window=window)
    want = tref.paged_decode_attention(q, kp, vp, table, pos, window=window)
    torch.cuda.synchronize()
    assert tpaged.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=PAGED_TOL[dtype])


def _decode_on_card(cuda, dtype, *, B, S, H, KV, hd, pos, poison=False, seed=6):
    q, kc, vc, pos = (torch.from_numpy(a).to(cuda) for a in _decode_case(
        seed, B=B, S=S, H=H, KV=KV, hd=hd, pos=pos, poison=poison))
    return tuple(x.to(TDT[dtype]) for x in (q, kc, vc)) + (pos,)


@pytest.mark.gpu
@pytest.mark.parametrize("case,kind", [
    (dict(B=8, S=1088, H=4, KV=1, hd=256, pos=[0, 15, 16, 100, 511, 512, 777, 1087]), "mma"),
    (dict(B=4, S=300, H=8, KV=1, hd=128, pos=[299, 0, 150, 77]), "mma"),
    (dict(B=3, S=77, H=6, KV=2, hd=64, pos=[76, 3, 40]), "mma"),
    (dict(B=2, S=16, H=4, KV=1, hd=16, pos=[5, 15]), "mma"),
    (dict(B=4, S=300, H=8, KV=1, hd=112, pos=[299, 0, 150, 77]), "simt"),
    (dict(B=3, S=77, H=6, KV=2, hd=48, pos=[76, 3, 40]), "simt"),
    (dict(B=3, S=100, H=4, KV=1, hd=40, pos=[99, 0, 50]), "simt"),
    (dict(B=3, S=100, H=4, KV=2, hd=8, pos=[99, 0, 50]), "simt"),
], ids=["hd256", "hd128-groups8", "hd64-groups3", "hd16", "hd112-groups8", "hd48-groups3",
        "hd40", "hd8"])
def test_decode_kernel_variants_match_plain_on_card(cuda, case, kind):
    """Each walk at the bf16 head dims its rule sends it, both entry points,
    against the plain versions at the reference's bf16 tolerances."""
    q, kc, vc, pos = _decode_on_card(cuda, "bfloat16", **case)
    assert tcore.variant(q, kc) == kind
    before = (tdecode.variant_launches[kind], tpaged.variant_launches[kind])
    got = tops.decode_attention(q, kc, vc, pos)
    B, S = kc.shape[:2]
    table = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    got_paged = tops.paged_decode_attention(q, kc, vc, table, pos, window=S // 3)
    want = tref.decode_attention(q, kc, vc, pos)
    want_paged = tref.paged_decode_attention(q, kc, vc, table, pos, window=S // 3)
    torch.cuda.synchronize()
    assert (tdecode.variant_launches[kind], tpaged.variant_launches[kind]) == (
        before[0] + 1, before[1] + 1)
    tol = ATTN_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got_paged.float(), want_paged.float(), rtol=0,
                               atol=PAGED_TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    dict(B=8, S=1088, H=4, KV=1, hd=256, pos=[0, 15, 16, 100, 511, 512, 777, 1087]),
    dict(B=8, S=512, H=4, KV=1, hd=256, pos=[0, 5, 200, 511, 511, 511, 300, 17]),  # clamped ring
    dict(B=4, S=300, H=8, KV=2, hd=128, pos=[299, 0, 64, 150]),
    dict(B=3, S=777, H=4, KV=1, hd=256, pos=[700, 33, 776], poison=True),
    dict(B=2, S=16, H=4, KV=1, hd=16, pos=[5, 15]),
    dict(B=8, S=8192, H=4, KV=1, hd=256, pos=[8191, 0, 1, 2, 4095, 5000, 7777, 300]),
    # clusters of 8 blocks take shares of 8, then 16, ... positions
    dict(B=8, S=1088, H=4, KV=1, hd=256, pos=[63, 64, 127, 128, 7, 8, 1023, 1024]),
    dict(B=3, S=64, H=4, KV=1, hd=256, pos=[0, 1, 2]),
    dict(B=4, S=300, H=8, KV=1, hd=128, pos=[299, 0, 150, 77]),
    # more query heads a KV head than a block holds: head groups of 6 and 8
    dict(B=8, S=1088, H=12, KV=1, hd=128, pos=[0, 15, 16, 100, 511, 512, 777, 1087]),
    dict(B=8, S=1088, H=48, KV=1, hd=128, pos=[0, 15, 16, 100, 511, 512, 777, 1087]),
    dict(B=3, S=300, H=24, KV=2, hd=128, pos=[299, 0, 150]),
], ids=["global-1088", "ring-512", "gqa-ragged-300", "poison", "reduced-ring-16", "long-8192",
        "share-boundaries", "fewer-positions-than-blocks", "groups-8-hd128", "groups-12-hd128",
        "groups-48-hd128", "groups-12-kv2-hd128"])
def test_decode_kernel_matches_plain_on_card(cuda, case, dtype):
    q, kc, vc, pos = _decode_on_card(cuda, dtype, **case)
    before = tdecode.launches
    got = tops.decode_attention(q, kc, vc, pos)
    want = tref.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert tdecode.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # a Python int is broadcast over the batch
    torch.testing.assert_close(tops.decode_attention(q, kc, vc, 7).float(),
                               tref.decode_attention(q, kc, vc, 7).float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,window", [
    (dict(B=8, H=4, KV=1, hd=256, page=16, n_pages=512, pool_pages=4097,
          pos=[8191, 0, 1, 2, 4095, 5000, 7777, 300]), 0),
    (dict(B=8, H=4, KV=1, hd=256, page=16, n_pages=512, pool_pages=4097,
          pos=[8191, 0, 1, 2, 4095, 5000, 7777, 300]), 3000),
    (dict(B=8, H=4, KV=1, hd=256, page=16, n_pages=68, pool_pages=545,
          pos=[63, 64, 127, 128, 7, 8, 1023, 1024]), 0),
    (dict(B=3, H=8, KV=1, hd=128, page=16, n_pages=68, pool_pages=545, pos=[0, 1, 2]), 0),
    (dict(B=4, H=8, KV=1, hd=128, page=16, n_pages=20, pool_pages=81,
          pos=[299, 0, 150, 77]), 100),
    (dict(B=4, H=8, KV=2, hd=128, page=16, n_pages=20, pool_pages=81,
          pos=[299, 0, 150, 77]), 0),
    (dict(B=4, H=12, KV=1, hd=128, page=16, n_pages=20, pool_pages=81,
          pos=[299, 0, 150, 77]), 0),
    (dict(B=4, H=48, KV=1, hd=128, page=16, n_pages=20, pool_pages=81,
          pos=[299, 0, 150, 77]), 100),
], ids=["long-8192", "long-8192-window", "share-boundaries", "fewer-positions-than-blocks",
        "groups-8-hd128-window", "gqa-kv2-hd128", "groups-12-hd128", "groups-48-hd128-window"])
def test_paged_kernel_edge_cases_on_card(cuda, case, window, dtype):
    q, kp, vp, table, pos = (torch.from_numpy(a).to(cuda) for a in _pool_case(
        8, poison=True, **case))
    q, kp, vp = (x.to(TDT[dtype]) for x in (q, kp, vp))
    before = tpaged.launches
    got = tops.paged_decode_attention(q, kp, vp, table, pos, window=window)
    want = tref.paged_decode_attention(q, kp, vp, table, pos, window=window)
    torch.cuda.synchronize()
    assert tpaged.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=PAGED_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    dict(B=8, S=1088, H=4, KV=1, hd=256, pos=[0, 15, 16, 100, 511, 512, 777, 1087]),
    dict(B=4, S=304, H=8, KV=2, hd=128, pos=[299, 0, 64, 303]),
    dict(B=2, S=16, H=4, KV=1, hd=16, pos=[5, 15]),
    dict(B=8, S=8192, H=4, KV=1, hd=256, pos=[8191, 0, 1, 2, 4095, 5000, 7777, 300]),
], ids=["global-1088", "gqa-304", "reduced-16", "long-8192"])
def test_dense_and_paged_kernels_bitwise_equal_on_card(cuda, case, dtype):
    """One decode core behind both entry points: the paged kernel over the
    dense cache seen as a pool (one page per slot, and pages of 16) gives
    the dense kernel's output bit for bit, one launch each."""
    q, kc, vc, pos = _decode_on_card(cuda, dtype, **case)
    B, S, KV, hd = kc.shape
    before = (tdecode.launches, tpaged.launches)
    dense = tops.decode_attention(q, kc, vc, pos)
    one = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    paged = tops.paged_decode_attention(q, kc, vc, one, pos)
    pools = (kc.view(B * S // 16, 16, KV, hd), vc.view(B * S // 16, 16, KV, hd))
    table = torch.arange(B * S // 16, dtype=torch.int32, device=cuda).view(B, S // 16)
    paged16 = tops.paged_decode_attention(q, *pools, table, pos)
    torch.cuda.synchronize()
    assert (tdecode.launches, tpaged.launches) == (before[0] + 1, before[1] + 2)
    assert torch.equal(paged, dense) and torch.equal(paged16, dense)
    torch.testing.assert_close(dense.float(), tref.decode_attention(q, kc, vc, pos).float(),
                               rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "relu", "gelu"])
@pytest.mark.parametrize("M,K,N", [(256, 64, 32), (256, 32, 10), (128, 128, 128),
                                   (256, 384, 128), (77, 50, 10)])
def test_fused_linear_kernel_matches_plain_on_card(cuda, M, K, N, act, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    gen = torch.Generator(device=cuda).manual_seed(M * K + N)
    x, w, b = (0.3 * torch.randn(shape, generator=gen, device=cuda)
               for shape in ((M, K), (K, N), (N,)))
    x, w, b = (t.to(TDT[dtype]) for t in (x, w, b))
    before = tlinear.launches
    got = tops.fused_linear(x, w, b, act=act)
    want = tlinear.fused_linear_ref(x, w, b, act=act)
    torch.cuda.synchronize()
    assert tlinear.launches == before + 1 and got.dtype == x.dtype
    tol = LINEAR_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("Sq,kw", [
    (37, {}), (300, {}), (777, {}), (1024, {}),
    (37, {"window": 512}), (300, {"window": 512}), (777, {"window": 512}),
    (1024, {"window": 512}),
    (300, {"prefix_len": 100}), (64, {"q_offset": 236}), (64, {"q_offset": 236, "window": 100}),
    (200, {"H": 8, "KV": 2}), (300, {"H": 8, "KV": 2, "window": 64}),  # GQA 4:1 in 8:2
    (130, {"Skv": 77, "KV": 4, "causal": False}),
    (50, {"Skv": 20, "H": 2, "window": 8}),                      # rows with no valid key
    (1024, {"B": 8}),                                           # a grid over a wave
    (512, {"B": 8}), (512, {"B": 8, "window": 512}),            # the serial engine's prefill
])
def test_flash_wgmma_matches_plain_on_card(cuda, hd, Sq, kw):
    """The tensor-core variant at every head dim it takes, against the plain
    version at the reference's bf16 tolerance."""
    kw = dict(kw)
    B, H, KV = kw.pop("B", 1), kw.pop("H", 4), kw.pop("KV", 1)
    Skv = kw.pop("Skv", Sq + kw.get("q_offset", 0))
    gen = torch.Generator(device=cuda).manual_seed(Sq * hd + H)
    q = torch.randn((B, Sq, H, hd), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((B, Skv, KV, hd), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((B, Skv, KV, hd), generator=gen, device=cuda).to(torch.bfloat16)
    assert tflash.variant(q, k, v) == "wgmma"
    before = tflash.variant_launches["wgmma"]
    got = tops.attention(q, k, v, **kw)
    want = tref.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tflash.variant_launches["wgmma"] == before + 1
    tol = ATTN_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["none", "relu", "gelu"])
@pytest.mark.parametrize("M,K,N,kind", [
    (128, 128, 128, "wgmma"), (256, 64, 32, "wgmma"),              # aligned
    (1000, 520, 264, "wgmma"), (300, 72, 8, "wgmma"),              # ragged tiles
    (1536, 1024, 1280, "wgmma"),                                    # over 1024^3
    (256, 32, 10, "simt"), (77, 50, 10, "simt"),                   # not TMA-aligned
])
def test_fused_linear_bf16_variants_match_plain_on_card(cuda, M, K, N, kind, act):
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    x, w, b = (0.3 * torch.randn(shape, generator=gen, device=cuda)
               for shape in ((M, K), (K, N), (N,)))
    x, w, b = (t.to(torch.bfloat16) for t in (x, w, b))
    assert tlinear.variant(x, w, b) == kind
    before = tlinear.variant_launches[kind]
    got = tops.fused_linear(x, w, b, act=act)
    want = tlinear.fused_linear_ref(x, w, b, act=act)
    torch.cuda.synchronize()
    assert tlinear.variant_launches[kind] == before + 1 and got.dtype == torch.bfloat16
    tol = LINEAR_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["none", "gelu"])
def test_fused_linear_fp32_tiled_matches_plain_on_card(cuda, act):
    """The 128 x 128 exact-FMA tiles, at a wave of tiles with ragged M and N."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    M, K, N = 1800, 256, 1412
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, w, b = (0.3 * torch.randn(shape, generator=gen, device=cuda)
               for shape in ((M, K), (K, N), (N,)))
    assert tlinear.variant(x, w, b) == "simt_tiled"
    got = tops.fused_linear(x, w, b, act=act)
    want = tlinear.fused_linear_ref(x, w, b, act=act)
    torch.cuda.synchronize()
    tol = LINEAR_TOL["float32"]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def _scan_on_card(cuda, dtype, *, B, H, S, dk, dv, state=False, layout="heads", seed=7):
    """Inputs as the model paths hand them over: head-split views of
    (B, S, H, d) projections ("heads"), or q and k broadcast over the heads
    ("shared", Mamba2's C and B)."""
    q, k, v, la, s0 = _scan_inputs(seed, B, H, S, dk, dv, state=state)
    to = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    if layout == "shared":
        q, k = (to(a[:, :1]).to(TDT[dtype]).expand(B, H, S, dk) for a in (q, k))
    else:
        q, k = (to(a.transpose(0, 2, 1, 3).copy()).to(TDT[dtype]).transpose(1, 2) for a in (q, k))
    v = to(v.transpose(0, 2, 1, 3).copy()).to(TDT[dtype]).transpose(1, 2)
    return q, k, v, to(la), (to(s0) if s0 is not None else None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    dict(B=1, H=4, S=777, dk=384, dv=384),                        # ragged prefill
    dict(B=1, H=4, S=777, dk=384, dv=384, state=True),
    dict(B=1, H=4, S=777, dk=384, dv=1, state=True),               # the normaliser
    dict(B=8, H=4, S=1, dk=384, dv=384, state=True),               # a decode tick
    dict(B=8, H=4, S=1, dk=384, dv=1, state=True),
    dict(B=1, H=32, S=300, dk=64, dv=224, layout="shared"),        # Mamba2: dk != dv
    dict(B=2, H=4, S=45, dk=32, dv=32, state=True),                # REDUCED widths
    dict(B=2, H=2, S=512, dk=32, dv=16),                           # a reference SCAN_SHAPE
    # y and the normaliser in one launch (the mLSTM's call)
    dict(B=1, H=4, S=777, dk=384, dv=384, norm=True),
    dict(B=1, H=4, S=777, dk=384, dv=384, state=True, norm=True),
    dict(B=8, H=4, S=1, dk=384, dv=384, state=True, norm=True),
    dict(B=2, H=4, S=45, dk=32, dv=32, state=True, norm=True),
    dict(B=2, H=4, S=300, dk=384, dv=384, norm=True),              # 32-column tiles
    dict(B=4, H=4, S=2048, dk=384, dv=384, norm=True),             # the loss shape
], ids=["ragged-777", "ragged-777-state", "normaliser", "decode", "decode-normaliser",
        "mamba2-shared-qk", "reduced", "ref-2x2x512x32x16", "fused-ragged-777",
        "fused-ragged-777-state", "fused-decode", "fused-reduced", "fused-300-b2", "fused-loss"])
def test_scan_kernel_matches_plain_on_card(cuda, case, dtype):
    """Against the plain version at a chunk of at most 16 positions: its fp32
    cumulated decay over the path's chunk of 128 alone exceeds the fp32
    tolerance at dk = 384 (the kernels ignore the chunk). With ``norm``, the
    one launch against the plain version's two calls."""
    case = dict(case)
    norm = case.pop("norm", False)
    q, k, v, la, s0 = _scan_on_card(cuda, dtype, **case)
    chunk = math.gcd(case["S"], 16)
    before = tscan.launches
    if norm:
        n0 = None if s0 is None else torch.ones(s0.shape[:3] + (1,), device=cuda)
        got = tops.gated_linear_scan(q, k, v, la, chunk=chunk, initial_state=s0,
                                     normaliser=True, initial_normaliser=n0)
        want = tref.gated_linear_scan_normalised(q, k, v, la, chunk=chunk, initial_state=s0,
                                                 initial_normaliser=n0)
    else:
        got = tops.gated_linear_scan(q, k, v, la, chunk=chunk, initial_state=s0)
        want = tref.gated_linear_scan(q, k, v, la, chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert tscan.launches == before + 1
    tol = SCAN_TOL[dtype]
    out_dtypes = (TDT[dtype], torch.float32) * (len(want) // 2)  # y, state[, nrm, n]
    for x, want_x, out_dtype in zip(got, want, out_dtypes, strict=True):
        assert x.dtype == out_dtype and x.shape == want_x.shape
        torch.testing.assert_close(x.float(), want_x.float(), rtol=tol, atol=tol)
