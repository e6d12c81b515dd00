"""The gradient of the port's attention: the plain backward, the autograd
wiring and the kernel wrappers under grad mode.

On the CPU `ref.attention_backward` (the flash backward kernel's formulas
from the forward's log-sum-exp, in plain PyTorch) is held against autograd
through `ref.attention` and against `jax.grad` of the reference's oracle
`repro.kernels.ref.attention` (the reference trains through it: its Pallas
flash has no VJP), in fp32 within 1e-5, over causal, window, prefix-LM and
q_offset masks (rows with no key included) and G in {1, 4}.
`FlashAttentionFn` runs with the plain forward and backward, so the wiring
is tested where no kernel runs. Tests marked ``gpu`` hold the backward
kernel against the plain version on the card and check that the four
wrappers without a backward raise under grad mode there.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the JAX reference, on the CPU
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref as jref
except ImportError:
    jax = jnp = jref = None
from repro_torch.kernels import build as tbuild  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import fused_linear as tlinear  # noqa: E402
from repro_torch.kernels import linear_scan as tscan  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_decode_attention as tpaged  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 1e-5

# (B, Sq, Skv, H, KV, hd, kwargs): masks the reference's oracle takes
CASES = [
    pytest.param(2, 24, 24, 4, 1, 16, {}, id="causal-mqa"),
    pytest.param(1, 24, 24, 4, 4, 16, {}, id="causal-mha"),
    pytest.param(2, 33, 33, 4, 1, 32, {"window": 8}, id="window"),
    pytest.param(1, 20, 20, 4, 1, 16, {"prefix_len": 7}, id="prefix"),
    pytest.param(1, 20, 20, 8, 2, 16, {"prefix_len": 7, "window": 5}, id="prefix-window-g4"),
    pytest.param(1, 12, 30, 4, 1, 16, {"q_offset": 18}, id="q-offset"),
    pytest.param(1, 12, 20, 4, 4, 16, {"q_offset": 15, "window": 4}, id="q-offset-empty-rows"),
    pytest.param(2, 9, 17, 4, 1, 16, {"causal": False}, id="bidirectional"),
]


def _inputs(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    return q, k, v, do


def _autograd(fn, q, k, v, do, kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(qt, kt, vt, **kw)
    return out.detach(), torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,kw", CASES)
def test_plain_backward_matches_autograd_and_jax(B, Sq, Skv, H, KV, hd, kw):
    q, k, v, do = _inputs(Sq * 7 + H, B, Sq, Skv, H, KV, hd)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = tref.attention_with_lse(tq, tk, tv, **kw)
    torch.testing.assert_close(out, tref.attention(tq, tk, tv, **kw), rtol=0, atol=0)
    got = tref.attention_backward(tq, tk, tv, out, lse, tdo, **kw)
    _, want = _autograd(tref.attention, q, k, v, do, kw)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL, msg=f"d{name}")
    if jref is None:
        return
    jkw = {n: kw[n] for n in kw}
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, **jkw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, a, b in zip("qkv", got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=f"d{name} vs jax.grad")


def test_lse_is_the_rows_logsumexp():
    q, k, v, _ = _inputs(3, 1, 10, 10, 4, 1, 16)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = tref.attention_with_lse(tq, tk, tv, window=3)
    scores = torch.einsum("bqhd,bkd->bhqk", tq / 4.0, tk[:, :, 0])
    mask = tref._build_mask(10, 10, causal=True, window=3, prefix_len=0, q_offset=0)
    want = torch.logsumexp(scores.masked_fill(~mask, float("-inf")), dim=-1)
    assert lse.shape == (1, 4, 10) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,kw", CASES[:6])
def test_flash_function_with_plain_versions_matches_autograd(B, Sq, Skv, H, KV, hd, kw):
    """`FlashAttentionFn` wired to the plain forward and backward: the
    output and every gradient of autograd through `ref.attention`."""
    q, k, v, do = _inputs(11 + Sq, B, Sq, Skv, H, KV, hd)
    full = dict(causal=True, window=0, prefix_len=0, q_offset=0, scale=None)
    full.update(kw)
    fn = lambda a, b, c, **kw_: tflash.FlashAttentionFn.apply(  # noqa: E731
        a, b, c, tref.attention_with_lse, tref.attention_backward, kw_)
    out, got = _autograd(fn, q, k, v, do, full)
    want_out, want = _autograd(tref.attention, q, k, v, do, kw)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL, msg=f"d{name}")


def test_flash_function_takes_a_strided_output_gradient():
    """The backward makes `d_out` contiguous before the launch: a gradient
    that arrives as a transposed view gives the same result."""
    q, k, v, _ = _inputs(5, 1, 8, 8, 4, 1, 16)
    seen = []

    def bwd(*args, **kw):
        seen.append(args[5].is_contiguous())
        return tref.attention_backward(*args, **kw)

    qt = torch.from_numpy(q).requires_grad_()
    out = tflash.FlashAttentionFn.apply(qt, torch.from_numpy(k), torch.from_numpy(v),
                                        tref.attention_with_lse, bwd, {})
    g = torch.randn(1, 4, 8, 16).transpose(1, 2)  # (1, 8, 4, 16), not contiguous
    (gq,) = torch.autograd.grad(out, qt, g)
    (want,) = torch.autograd.grad(tref.attention(qt, torch.from_numpy(k), torch.from_numpy(v)),
                                  qt, g)
    assert seen == [True]
    torch.testing.assert_close(gq, want, rtol=TOL, atol=TOL)


def test_cpu_attention_stays_differentiable_and_launches_nothing():
    tops.reset_launch_counts()
    q, k, v, do = _inputs(9, 1, 16, 16, 4, 1, 16)
    out, got = _autograd(tops.attention, q, k, v, do, {"window": 4})
    _, want = _autograd(tref.attention, q, k, v, do, {"window": 4})
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(tops.launch_counts().values()) == {0}


def _no_backward_calls(device):
    """One call of each wrapper that has no backward kernel, on tensors of
    `device`, with q (or x) requiring grad."""
    z = lambda *shape, **kw: torch.zeros(shape, device=device, **kw)  # noqa: E731
    q = z(2, 4, 16, requires_grad=True)
    return {
        "decode_attention": lambda: tdecode.decode_attention(
            q, z(2, 8, 1, 16), z(2, 8, 1, 16), z(2, dtype=torch.int32)),
        "paged_decode_attention": lambda: tpaged.paged_decode_attention(
            q, z(3, 4, 1, 16), z(3, 4, 1, 16), z(2, 2, dtype=torch.int32),
            z(2, dtype=torch.int32)),
        "fused_linear": lambda: tlinear.fused_linear(
            z(4, 8, requires_grad=True), z(8, 4), z(4)),
        "gated_linear_scan": lambda: tscan.gated_linear_scan(
            z(1, 2, 5, 8), z(1, 2, 5, 8), z(1, 2, 5, 4, requires_grad=True), z(1, 2, 5)),
    }


@pytest.mark.parametrize("name", ["decode_attention", "paged_decode_attention", "fused_linear",
                                  "gated_linear_scan"])
def test_wrappers_without_backward_refuse_grad_mode(name):
    """Under grad mode with an input that requires grad, a wrapper whose
    kernel has no backward raises before anything else (its output would
    carry no gradient); under `torch.no_grad()` it goes on to its usual
    checks (here: a CPU tensor is refused)."""
    call = _no_backward_calls("cpu")[name]
    with pytest.raises(RuntimeError, match="requires grad.*no backward"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call()


def test_flash_forward_refuses_grad_mode_outside_the_function():
    q = torch.zeros((1, 8, 4, 16), requires_grad=True)
    k = torch.zeros((1, 8, 1, 16))
    with pytest.raises(RuntimeError, match="ops.attention"):
        tflash.flash_attention(q, k, k)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, k, k)


def test_backward_wrapper_checks_its_operands():
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 1, 16))
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_backward(q, k, k, q, lse, q)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention_backward(torch.zeros((1, 8, 4, 24)), torch.zeros((1, 8, 1, 24)),
                                        torch.zeros((1, 8, 1, 24)), torch.zeros((1, 8, 4, 24)),
                                        lse, torch.zeros((1, 8, 4, 24)))


def test_backward_counts_add_up_across_threads():
    """The backward's launches count through the shared lock like every
    wrapper's (`build.count_launch` on a `LaunchCounter`)."""
    tops.reset_launch_counts()
    start = threading.Barrier(4)

    def worker():
        start.wait()
        for _ in range(500):
            tbuild.count_launch(tflash.backward, "simt")

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    try:
        assert tops.launch_counts()["flash_attention_bwd"] == 2000
        assert tops.variant_counts()["flash_attention_bwd"] == {"simt": 2000}
        assert tops.launch_counts()["flash_attention"] == 0
    finally:
        tops.reset_launch_counts()
    assert tflash.backward.launches == 0


# ---------------------------------------------------------------------------
# on the card (skips without a GPU)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,S,H,KV,hd,kw", [
    (torch.bfloat16, 2, 256, 4, 1, 256, {}),
    (torch.bfloat16, 2, 256, 4, 1, 256, {"window": 64}),
    (torch.bfloat16, 1, 200, 8, 2, 128, {"prefix_len": 50}),
    (torch.bfloat16, 1, 100, 4, 4, 112, {}),
    (torch.float32, 2, 45, 4, 1, 16, {"window": 16}),
    (torch.float32, 1, 40, 4, 1, 32, {"q_offset": 30, "window": 8}),
])
def test_backward_kernel_matches_plain_on_card(cuda, dtype, B, S, H, KV, hd, kw):
    gen = torch.Generator(device=cuda).manual_seed(S + hd)
    Skv = S + kw.get("q_offset", 0) // 3
    q = torch.randn((B, S, H, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, Skv, KV, hd), generator=gen, device=cuda).to(dtype)
    do = torch.randn((B, S, H, hd), generator=gen, device=cuda).to(dtype)
    out, lse = tflash.flash_attention_with_lse(q, k, v, **kw)
    got = tflash.flash_attention_backward(q, k, v, out, lse, do, **kw)
    want = tref.attention_backward(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, b in zip("qkv", got, want):
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
        assert err <= tol, f"d{name}: {err}"


@pytest.mark.gpu
def test_attention_gradient_goes_through_the_kernels_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, 64, n, 16), generator=gen, device=cuda).requires_grad_()
               for n in (4, 1, 1))
    tops.reset_launch_counts()
    got = torch.autograd.grad(tops.attention(q, k, v, window=16).square().sum(), (q, k, v))
    counts = tops.launch_counts()
    want = torch.autograd.grad(tref.attention(q, k, v, window=16).square().sum(), (q, k, v))
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["decode_attention", "paged_decode_attention", "fused_linear",
                                  "gated_linear_scan"])
def test_wrappers_without_backward_refuse_grad_mode_on_card(cuda, name):
    with pytest.raises(RuntimeError, match="requires grad.*no backward"):
        _no_backward_calls(cuda)[name]()
