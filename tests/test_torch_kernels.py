"""The port's kernel layer against the JAX reference.

On the CPU the port's plain PyTorch versions (`repro_torch.kernels.ref`) are
held against the reference's Pallas kernels (interpret mode, through
`repro.kernels.ops` with ``impl="pallas"``) and its jnp oracles, on the same
numpy inputs, at the reference's own tolerances (`tests/test_kernels.py`:
2e-5 fp32 / 2e-2 bf16 for attention; `tests/test_kernels_paged.py`: 1e-5 fp32
/ 5e-2 bf16 for paged decode). Tests marked ``gpu`` hold the CUDA kernels
against the plain versions on the card at the serving path's shapes; they
skip where there is no card, and they need no JAX (the machine with the card
may not have it; there the reference comparisons skip instead).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the JAX reference, on the CPU
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = jops = jref = None
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_decode_attention as tpaged  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PAGED_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    assert tops.launch_counts() == {"flash_attention": 0, "paged_decode_attention": 0}


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


def test_flash_wrapper_rejects_unsupported_head_dim():
    q = torch.zeros((1, 8, 4, 48))
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention(q, q[:, :, :1], q[:, :, :1])


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
@pytest.mark.parametrize("window", [0, 512])
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
