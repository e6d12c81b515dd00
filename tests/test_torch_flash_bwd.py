"""The gradient of the port's attention: the plain backward, the autograd
wiring and the kernel wrappers under grad mode.

On the CPU `ref.attention_backward` (the flash backward kernel's formulas
from the forward's log-sum-exp, in plain PyTorch) is held against autograd
through `ref.attention` and against `jax.grad` of the reference's oracle
`repro.kernels.ref.attention` (the reference trains through it: its Pallas
flash has no VJP), in fp32 within 1e-5, over causal, window, prefix-LM and
q_offset masks (rows with no key included) and G in {1, 4}; `ops.attention`
and its gradient likewise at the shapes the tensor-core variants took in
their second redesign (head_dim 80, 112, 160; G = 6 and 48).
`FlashAttentionFn` runs with the plain forward and backward, so the wiring
is tested where no kernel runs; so are the backward's variant rule, the
split of its dK/dV walks and its scratch, which decide on the host. Tests
marked ``gpu`` hold both backward variants against the plain version on the
card and check that the three wrappers without a backward raise under grad
mode there (the scan's backward has its own tests, `test_torch_scan_bwd.py`).
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


# Shapes the tensor-core variants take since their head dims were padded to
# whole 64-column tiles and their rows to whole positions: head_dim 80, 112,
# 160 and groups that do not divide 64 (6, 48), at small sizes
TENSOR_CORE_CASES = [
    pytest.param(1, 20, 20, 6, 1, 112, {}, id="hd112-g6"),
    pytest.param(2, 17, 17, 4, 4, 112, {"window": 5}, id="hd112-window"),
    pytest.param(1, 23, 23, 12, 2, 80, {"prefix_len": 6}, id="hd80-g6-prefix"),
    pytest.param(1, 11, 19, 6, 1, 160, {"q_offset": 8}, id="hd160-g6-offset"),
    pytest.param(1, 9, 9, 48, 1, 112, {}, id="hd112-g48"),
    pytest.param(2, 13, 13, 6, 1, 112, {"causal": False}, id="hd112-g6-bidirectional"),
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,kw", TENSOR_CORE_CASES)
def test_attention_and_gradient_match_jax_at_tensor_core_shapes(B, Sq, Skv, H, KV, hd, kw):
    """`ops.attention` and its gradient on the CPU (the plain versions both
    kernels are held to) against the reference's oracle and `jax.vjp` of
    it, in fp32 within 1e-5; in bf16 on the card these operands take the
    `wgmma` variants both ways."""
    q, k, v, do = _inputs(Sq * 5 + hd, B, Sq, Skv, H, KV, hd)
    assert tflash.variant(*(torch.from_numpy(x).bfloat16() for x in (q, k, v))) == "wgmma"
    out, got = _autograd(tops.attention, q, k, v, do, kw)
    if jref is None:
        return
    want, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, **kw),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for name, a, b in zip("qkv", got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=f"d{name} vs jax.vjp")


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
    }


@pytest.mark.parametrize("name", ["decode_attention", "paged_decode_attention", "fused_linear"])
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


@pytest.mark.parametrize("normaliser", [False, True])
def test_scan_forward_refuses_grad_mode_outside_the_function(normaliser):
    """The scan's raw forward, like flash's, raises under grad mode with an
    input that requires grad (its output would carry no gradient): training
    goes through `ops.gated_linear_scan` (`GatedLinearScanFn`)."""
    v = torch.zeros((1, 2, 5, 4), requires_grad=True)
    q = torch.zeros((1, 2, 5, 8))
    with pytest.raises(RuntimeError, match="ops.gated_linear_scan"):
        tscan.gated_linear_scan(q, q, v, torch.zeros((1, 2, 5)), normaliser=normaliser)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tscan.gated_linear_scan(q, q, v, torch.zeros((1, 2, 5)), normaliser=normaliser)


def test_cpu_scan_stays_differentiable_and_launches_nothing():
    tops.reset_launch_counts()
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 16, 8)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    la = torch.from_numpy(-rng.random((1, 2, 16)).astype(np.float32)).requires_grad_()
    y, _, nrm, _ = tops.gated_linear_scan(q, k, v, la, chunk=8, normaliser=True)
    got = torch.autograd.grad(y.sum() + nrm.square().sum(), (q, k, v, la))
    y2, _, nrm2, _ = tref.gated_linear_scan_normalised(q, k, v, la, chunk=8)
    want = torch.autograd.grad(y2.sum() + nrm2.square().sum(), (q, k, v, la))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(tops.launch_counts().values()) == {0}


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
        assert tops.variant_counts()["flash_attention_bwd"] == {"simt": 2000, "wgmma": 0,
                                                                 "tf32x3": 0}
        assert tops.launch_counts()["flash_attention"] == 0
    finally:
        tops.reset_launch_counts()
    assert tflash.backward.launches == 0


# ---------------------------------------------------------------------------
# the backward's variant rule, walk split and scratch (decided on the host)
# ---------------------------------------------------------------------------

H100_SMS = 132


def _unaligned(shape, dtype):
    """A contiguous tensor of `shape` whose data starts 2 bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    return torch.empty(n + 8, dtype=dtype)[1:n + 1].view(shape)


@pytest.mark.parametrize("dtype,H,KV,hd,layout,want", [
    # each config's attention at its training width (bf16 compute) ...
    ("bfloat16", 4, 1, 256, "aligned", "wgmma"),     # gemma3-1b
    ("bfloat16", 8, 1, 256, "aligned", "wgmma"),     # paligemma-3b
    ("bfloat16", 12, 12, 64, "aligned", "wgmma"),    # whisper-small
    ("bfloat16", 32, 8, 128, "aligned", "wgmma"),    # minitron-8b
    ("bfloat16", 48, 1, 128, "aligned", "wgmma"),    # granite-20b: one position, 48 rows
    ("bfloat16", 48, 8, 128, "aligned", "wgmma"),    # grok-1-314b: 10 positions, 60 rows
    ("bfloat16", 32, 8, 160, "aligned", "wgmma"),    # stablelm-12b: hd 160, tiles of 192
    ("bfloat16", 64, 8, 112, "aligned", "wgmma"),    # kimi-k2: hd 112, tiles of 128
    ("bfloat16", 32, 32, 112, "aligned", "wgmma"),   # zamba2-7b: hd 112
    # ... REDUCED (fp32, hd 16), fp32 at a tensor-core shape, and alignment:
    # fp32 takes three TF32 products a product (fp32's accuracy) at every
    # head dim and group
    ("float32", 4, 1, 16, "aligned", "tf32x3"),
    ("float32", 4, 1, 256, "aligned", "tf32x3"),
    ("float32", 8, 2, 80, "aligned", "tf32x3"),      # train_100m
    ("float32", 130, 2, 32, "aligned", "tf32x3"),    # groups over 64
    ("float32", 8, 2, 80, "unaligned-q", "simt"),
    ("float32", 8, 2, 80, "unaligned-k", "simt"),
    ("bfloat16", 8, 2, 80, "aligned", "wgmma"),
    ("bfloat16", 64, 1, 64, "aligned", "wgmma"),     # 64 heads: one position a tile
    ("bfloat16", 72, 1, 64, "aligned", "simt"),      # more heads than a tile's rows
    ("bfloat16", 4, 1, 256, "unaligned-q", "simt"),
    ("bfloat16", 4, 1, 256, "unaligned-k", "simt"),
    # an output or output gradient off 16 bytes (a contiguous view at an
    # odd offset) sends aligned q, k, v to simt as well
    ("float32", 8, 2, 80, "unaligned-out", "simt"),
    ("float32", 8, 2, 80, "unaligned-d_out", "simt"),
    ("bfloat16", 4, 1, 256, "unaligned-d_out", "simt"),
])
def test_backward_variant_rule(dtype, H, KV, hd, layout, want):
    dt = getattr(torch, dtype)
    q = _unaligned((1, 9, H, hd), dt) if layout == "unaligned-q" else torch.empty(
        (1, 9, H, hd), dtype=dt)
    k = _unaligned((1, 9, KV, hd), dt) if layout == "unaligned-k" else torch.empty(
        (1, 9, KV, hd), dtype=dt)
    v = torch.empty((1, 9, KV, hd), dtype=dt)
    out, d_out = (_unaligned(q.shape, dt) if layout == f"unaligned-{name}" else torch.empty_like(q)
                  for name in ("out", "d_out"))
    assert tflash.backward_variant(q, k, v, out, d_out) == want
    if layout in ("unaligned-out", "unaligned-d_out"):
        assert tflash.backward_variant(q, k, v) != "simt"  # q, k, v alone are aligned
    else:  # the forward's rule, fp32's tf32x3 included
        assert tflash.backward_variant(q, k, v) == tflash.variant(q, k, v) == want


def test_backward_counter_counts_by_variant():
    tops.reset_launch_counts()
    try:
        assert set(tflash.backward.variant_launches) == {"simt", "wgmma", "tf32x3"}
        tbuild.count_launch(tflash.backward, "wgmma")
        tbuild.count_launch(tflash.backward, "wgmma")
        tbuild.count_launch(tflash.backward, "simt")
        tbuild.count_launch(tflash.backward, "tf32x3")
        assert tops.launch_counts()["flash_attention_bwd"] == 4
        assert tops.variant_counts()["flash_attention_bwd"] == {"simt": 1, "wgmma": 2,
                                                                 "tf32x3": 1}
    finally:
        tops.reset_launch_counts()
    assert tops.variant_counts()["flash_attention_bwd"] == {"simt": 0, "wgmma": 0, "tf32x3": 0}


MASKS = [
    pytest.param(dict(causal=True), id="causal"),
    pytest.param(dict(causal=True, window=512), id="window"),
    pytest.param(dict(causal=True, window=100), id="window-100"),
    pytest.param(dict(causal=True, prefix_len=256), id="prefix"),
    pytest.param(dict(causal=False), id="bidirectional"),
    pytest.param(dict(causal=False, window=70), id="bidirectional-window"),
    pytest.param(dict(causal=True, q_offset=30, window=8), id="q-offset-empty-rows"),
    pytest.param(dict(causal=True, q_offset=200), id="q-offset"),
]


@pytest.mark.parametrize("kw", MASKS)
@pytest.mark.parametrize("Sq,Skv,G", [(1024, 1024, 4), (288, 288, 8), (40, 50, 4),
                                      (64, 1500, 1), (300, 300, 64), (1024, 1024, 48),
                                      (300, 300, 6), (77, 90, 6), (40, 50, 48)])
def test_backward_walks_cover_the_mask(kw, Sq, Skv, G):
    """Every query tile with a row that may attend a key of a key tile, or
    with a row that attends no key at all (it spreads over every key), lies
    in that key tile's walk: the host's copy of the kernel's rule, checked
    against the plain version's mask."""
    P = 64 // G
    full = dict(causal=True, window=0, prefix_len=0, q_offset=0)
    full.update(kw)
    mask = tref._build_mask(Sq, Skv, **full)
    empty = ~mask.any(dim=1)
    walks = tflash._query_tiles_seen(Sq, Skv, P, full["causal"], full["window"],
                                     full["prefix_len"], full["q_offset"])
    assert len(walks) == -(-Skv // 64)
    for j, (lo, hi) in enumerate(walks):
        seen = mask[:, 64 * j:64 * (j + 1)].any(dim=1) | empty
        tiles = {int(p) // P for p in torch.nonzero(seen).flatten()}
        assert all(lo <= t < hi for t in tiles), (j, lo, hi, sorted(tiles))
        assert 0 <= lo <= hi and (lo == hi or hi <= -(-Sq // P))  # an empty walk loads nothing


@pytest.mark.parametrize("B,Sq,Skv,H,KV,kw,sms,want", [
    # gemma3-1b training: 16 key tiles x 4 batches = 64 blocks unsplit
    (4, 1024, 1024, 4, 1, {}, H100_SMS, (22, 3)),
    (4, 1024, 1024, 4, 1, {"window": 512}, H100_SMS, (18, 4)),
    # whisper-small's encoder and cross-attention: a wave or more unsplit
    (8, 1500, 1500, 12, 12, {"causal": False}, H100_SMS, (24, 1)),
    (8, 64, 1500, 12, 12, {"causal": False}, H100_SMS, (1, 1)),
    # paligemma-3b's prefix-LM at B=2: 10 blocks unsplit
    (2, 288, 288, 8, 1, {"prefix_len": 256}, H100_SMS, (3, 12)),
    # a card of 1000 SMs splits more; one of 64 does not split gemma3's 64 blocks
    (4, 1024, 1024, 4, 1, {}, 1000, (3, 22)),
    (4, 1024, 1024, 4, 1, {}, 64, (64, 1)),
    # granite-20b's 48 heads a group (1024 query tiles of one position: 16
    # blocks unsplit), and zamba2-7b's training shape (1024 blocks: a wave
    # unsplit)
    (1, 1024, 1024, 48, 1, {}, H100_SMS, (70, 15)),
    (4, 300, 300, 48, 1, {"window": 64}, H100_SMS, (18, 17)),
    (2, 1024, 1024, 32, 32, {}, H100_SMS, (16, 1)),
])
def test_backward_plan_rule(monkeypatch, B, Sq, Skv, H, KV, kw, sms, want):
    monkeypatch.setattr(tbuild, "sm_count", lambda device: sms)
    q = torch.empty((B, Sq, H, 256), dtype=torch.bfloat16)
    k = torch.empty((B, Skv, KV, 256), dtype=torch.bfloat16)
    chunk, splits = tflash.backward_plan(q, k, **kw)
    assert (chunk, splits) == want
    n_qt = -(-Sq // (64 // (H // KV)))
    assert chunk * splits >= n_qt  # the grid covers every walk the card may compute
    walks = tflash._query_tiles_seen(Sq, Skv, 64 // (H // KV), kw.get("causal", True),
                                     kw.get("window", 0), kw.get("prefix_len", 0), 0)
    if splits > 1:  # some walk is split, and its blocks fit the card
        assert max(hi - lo for lo, hi in walks) > chunk
        blocks = B * KV * sum(max(1, -(-(hi - lo) // chunk)) for lo, hi in walks)
        assert blocks <= 2 * sms


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,chunk,splits", [
    (4, 1024, 1024, 4, 1, 256, 22, 3),
    (2, 288, 288, 8, 1, 256, 3, 12),
    (1, 40, 50, 4, 1, 64, 1, 3),
    (2, 1500, 1500, 12, 12, 64, 24, 1),
    (1, 1024, 1024, 48, 1, 128, 70, 15),   # granite-20b: a tile of one position
    (1, 1024, 1024, 48, 8, 128, 21, 5),    # grok-1: tiles of 10 positions
    (2, 1024, 1024, 32, 32, 112, 16, 1),   # zamba2-7b's training shape
    (1, 77, 77, 6, 1, 160, 3, 5),          # hd 160: partials of the real 160 columns
])
def test_backward_scratch_matches_the_entry_points_contract(B, Sq, Skv, H, KV, hd, chunk,
                                                            splits):
    q = torch.empty((B, Sq, H, hd), dtype=torch.bfloat16)
    k = torch.empty((B, Skv, KV, hd), dtype=torch.bfloat16)
    stat, partial = tflash.backward_scratch(q, k, chunk, splits)
    n_qt = -(-Sq // (64 // (H // KV)))
    assert stat.dtype == torch.float32 and stat.numel() == B * KV * n_qt * 128
    assert stat.data_ptr() % 16 == 0 and stat.device == q.device
    if splits == 1:
        assert partial is None
    else:
        assert partial.shape == (splits, B * KV, -(-Skv // 64) * 64, 2, hd)
        assert partial.dtype == torch.float32 and partial.data_ptr() % 16 == 0


def test_backward_scratch_refuses_a_split_that_misses_tiles():
    q = torch.empty((4, 1024, 4, 256), dtype=torch.bfloat16)
    k = torch.empty((4, 1024, 1, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not cover 64 query tiles"):
        tflash.backward_scratch(q, k, 21, 3)
    with pytest.raises(ValueError, match="does not cover"):
        tflash.backward_scratch(q, k, 0, 64)


# ---------------------------------------------------------------------------
# the fp32 backward's tf32x3 variant: its walk split and its arithmetic
# ---------------------------------------------------------------------------


def _tf32_round(x):
    """fp32 x rounded to TF32 as the tf32x3 kernels round it
    (`csrc/flash_attention_bwd.cu::tx::tf32_bits`): half a TF32 ulp added to
    the magnitude, then the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32x3_walks(q, k, **kw):
    """For each key tile of the tf32x3 dK/dV launch, the (split, [(query
    head, query tile), ...]) its blocks walk, in the order they walk them:
    the kernel's walk (`flash_bwd_dkdv_tf32x3_kernel`: pairs heads
    outermost, split `walk_splits` ways) over the host's plan."""
    B, Sq, H, hd = q.shape
    G, P = H // k.shape[2], tflash.tf32x3_walk_rows(hd)
    chunk, _ = tflash.tf32x3_plan(q, k, **kw)
    out = []
    for lo, hi in tflash._query_tiles_seen(Sq, k.shape[1], P, kw["causal"], kw["window"],
                                           kw["prefix_len"], kw["q_offset"]):
        nq = hi - lo
        pairs = [(p // nq, lo + p % nq) for p in range(G * nq)]
        n_splits = -(-len(pairs) // chunk) if len(pairs) > chunk else 1
        out.append([(s, pairs[s * chunk:(s + 1) * chunk]) for s in range(n_splits)])
    return out


@pytest.mark.parametrize("kw", MASKS)
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,sms", [
    (4, 256, 256, 8, 2, 80, H100_SMS),     # examples/train_100m_torch.py
    (4, 32, 32, 4, 1, 16, H100_SMS),       # REDUCED gemma3-1b's training batch
    (2, 64, 64, 8, 2, 32, H100_SMS),
    (1, 300, 300, 8, 2, 256, H100_SMS),    # walks of 16-row query tiles
    (2, 77, 90, 6, 1, 160, H100_SMS),
    (4, 256, 256, 8, 2, 80, 16),           # a small card: fewer splits
])
def test_tf32x3_walks_cover_every_pair_once(monkeypatch, kw, B, Sq, Skv, H, KV, hd, sms):
    """The tf32x3 dK/dV walks (`_tf32x3_walks`): each key tile's splits
    take, in split order, every (query head, query tile) pair
    whose tile its walk covers exactly once, heads outermost, at most
    `chunk` a split and within the grid's `splits`; every query tile with a
    row that may attend one of the tile's keys, or with a row that attends
    none, is in the walk."""
    monkeypatch.setattr(tbuild, "sm_count", lambda device: sms)
    q = torch.empty((B, Sq, H, hd))
    k = torch.empty((B, Skv, KV, hd))
    full = dict(causal=True, window=0, prefix_len=0, q_offset=0)
    full.update(kw)
    chunk, splits = tflash.tf32x3_plan(q, k, **full)
    G, P = H // KV, tflash.tf32x3_walk_rows(hd)
    assert chunk * splits >= G * -(-Sq // P)
    walks = _tf32x3_walks(q, k, **full)
    mask = tref._build_mask(Sq, Skv, **full)
    empty = ~mask.any(dim=1)
    assert len(walks) == -(-Skv // tflash.WGMMA_KEYS)
    for j, parts in enumerate(walks):
        assert [s for s, _ in parts] == list(range(len(parts))) and len(parts) <= splits
        assert all(len(pairs) <= chunk for _, pairs in parts) or len(parts) == 1
        pairs = [x for _, part in parts for x in part]
        tiles = sorted({t for _, t in pairs})
        assert pairs == [(g, t) for g in range(G) for t in tiles]  # each once, heads outermost
        assert tiles == list(range(tiles[0], tiles[-1] + 1)) if tiles else True
        seen = mask[:, 64 * j:64 * (j + 1)].any(dim=1) | empty
        need = {int(i) // P for i in torch.nonzero(seen).flatten()}
        assert need <= set(tiles), (j, sorted(need), tiles)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,kw,sms,want", [
    # train_100m: 4 key tiles x 8 (batch, KV head) units, walks of 32, 24, 16
    # and 8 pairs, two blocks an SM at hd 80
    (4, 256, 256, 8, 2, 80, {}, H100_SMS, (3, 11)),
    (4, 256, 256, 8, 2, 80, {"window": 256}, H100_SMS, (3, 11)),
    # REDUCED gemma3-1b (B=4 x 32, 4 heads over 1, hd 16): one key tile, its
    # four (head, query tile) pairs on four blocks
    (4, 32, 32, 4, 1, 16, {}, H100_SMS, (1, 4)),
    # a grid that fills the card is not split: (G x query tiles, 1)
    (64, 256, 256, 8, 2, 80, {}, H100_SMS, (32, 1)),
    # hd 256: one block an SM, 16-row query tiles (76 pairs for key tile 0)
    (1, 300, 300, 8, 2, 256, {}, H100_SMS, (4, 19)),
])
def test_tf32x3_plan_rule(monkeypatch, B, Sq, Skv, H, KV, hd, kw, sms, want):
    monkeypatch.setattr(tbuild, "sm_count", lambda device: sms)
    q = torch.empty((B, Sq, H, hd))
    k = torch.empty((B, Skv, KV, hd))
    assert tflash.tf32x3_plan(q, k, **kw) == want
    delta, partial = tflash.tf32x3_scratch(q, k, *want)
    assert delta.shape == (B, H, Sq) and delta.dtype == torch.float32
    if want[1] == 1:
        assert partial is None
    else:
        assert partial.shape == (want[1], B * KV, -(-Skv // 64) * 64, 2, hd)
        assert partial.dtype == torch.float32 and partial.data_ptr() % 16 == 0


def test_tf32x3_scratch_refuses_a_split_that_misses_pairs():
    q = torch.empty((4, 256, 8, 80))
    k = torch.empty((4, 256, 2, 80))
    with pytest.raises(ValueError, match="does not cover 32"):
        tflash.tf32x3_scratch(q, k, 3, 10)


def test_tf32_round_clears_the_low_mantissa_bits_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-12, -1.0 - 2.0**-12,
                      3.14159265, -2.0**-20 * 1.7])
    r = _tf32_round(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((r - x).abs() <= x.abs() * 2.0**-11).all()  # half a TF32 ulp
    # TF32's ulp at 1 is 2^-10: half an ulp goes away from zero, a quarter
    # down, three quarters up; the sign stays
    assert r[1] == 1.0 + 2.0**-10 and r[2] == 1.0 and r[3] == 1.0 + 2.0**-10 and r[4] == -1.0


def _tf32x3_backward(q, k, v, out, lse, do, *, passes, scale, **kw):
    """The tf32x3 kernels' arithmetic in plain torch: every product of the
    backward as three TF32 products of the operands' high and low parts
    (`passes=3`; `passes=1`: one TF32 product), fp32 accumulation; P and dS
    as the kernels form them. No rows without a key."""
    def parts(x):
        hi = _tf32_round(x)
        return hi, _tf32_round(x - hi)

    def mm(a, b):
        ah, al = parts(a)
        bh, bl = parts(b)
        return ah @ bh if passes == 1 else ah @ bh + (al @ bh + ah @ bl)

    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    qh, doh, oh = (x.transpose(1, 2) for x in (q, do, out))
    kh, vh = (x.transpose(1, 2).repeat_interleave(G, dim=1) for x in (k, v))
    mask = tref._build_mask(Sq, k.shape[1], **kw)
    p = torch.where(mask, torch.exp(mm(qh, kh.transpose(-1, -2)) * scale - lse[..., None]), 0.0)
    dp = mm(doh, vh.transpose(-1, -2))
    ds = p * (dp - (doh * oh).sum(-1, keepdim=True))
    dq = mm(ds, kh) * scale
    dk = (mm(ds.transpose(-1, -2), qh) * scale).unflatten(1, (-1, G)).sum(2)
    dv = mm(p.transpose(-1, -2), doh).unflatten(1, (-1, G)).sum(2)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


@pytest.mark.parametrize("kw", [dict(causal=True, window=0, prefix_len=0, q_offset=0),
                                dict(causal=True, window=24, prefix_len=0, q_offset=0),
                                dict(causal=True, window=0, prefix_len=20, q_offset=0)],
                         ids=["causal", "window", "prefix"])
def test_three_tf32_products_keep_fp32_parity(kw):
    """At the example's widths (8 query heads over 2, hd 80) and a small
    depth, the tf32x3 arithmetic stays within 2e-5 of the fp32 plain
    backward (max |d| / max |plain|) where one TF32 product a product does
    not: the premise of the variant."""
    B, S, H, KV, hd = 2, 64, 8, 2, 80
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(11, B, S, S, H, KV, hd))
    out, lse = tref.attention_with_lse(q, k, v, **kw)
    want = tref.attention_backward(q, k, v, out, lse, do, **kw)
    for passes, bound in ((3, 2e-5), (1, None)):
        got = _tf32x3_backward(q, k, v, out, lse, do, passes=passes, scale=hd**-0.5, **kw)
        errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)]
        if bound is not None:
            assert max(errs) <= bound, errs
        else:
            assert max(errs) > 2e-5, errs


# ---------------------------------------------------------------------------
# the fp32 forward's tf32x3 variant: its arithmetic
# ---------------------------------------------------------------------------


def _tf32x3_forward_keys(hd):
    """Keys of a K / V tile of the tf32x3 forward (`csrc/flash_attention.cu::
    ft::keys`); each of a block's two warp halves takes half of every tile."""
    return 64 if hd <= 112 else 32 if hd <= 160 else 16


def _tf32x3_forward(q, k, v, *, passes, scale, **kw):
    """The tf32x3 forward's arithmetic in plain torch: S = Q K^T and O += P V
    as three TF32 products of the operands' high and low parts (`passes=3`;
    `passes=1`: one TF32 product), fp32 accumulation; the online softmax in
    log2 units over the kernel's key tiles, each tile's two halves walked by
    their own warps with their own max, sum and output, merged at the end;
    masked scores at the reference's -1e30 (rows with no key: the uniform
    average)."""
    def parts(x):
        hi = _tf32_round(x)
        return hi, _tf32_round(x - hi)

    def mm(a, b):
        ah, al = parts(a)
        bh, bl = parts(b)
        return ah @ bh if passes == 1 else ah @ bh + (al @ bh + ah @ bl)

    B, Sq, H, hd = q.shape
    Skv, G = k.shape[1], H // k.shape[2]
    qh = q.transpose(1, 2)
    kh, vh = (x.transpose(1, 2).repeat_interleave(G, dim=1) for x in (k, v))
    mask = tref._build_mask(Sq, Skv, **kw)
    tile = _tf32x3_forward_keys(hd)
    halves = []
    for first in (0, tile // 2):
        m = torch.full((B, H, Sq, 1), -1e30)
        l = torch.zeros((B, H, Sq, 1))
        acc = torch.zeros((B, H, Sq, hd))
        for kt in range(0, Skv, tile):
            lo, hi = kt + first, min(kt + first + tile // 2, Skv)
            if lo >= hi:
                continue
            s = mm(qh, kh[:, :, lo:hi].transpose(-1, -2)) * (scale * 1.4426950408889634)
            s = torch.where(mask[:, lo:hi], s, torch.tensor(-1e30))
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha, p = torch.exp2(m - mx), torch.exp2(s - mx)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + mm(p, vh[:, :, lo:hi])
            m = mx
        halves.append((m, l, acc))
    (m1, l1, a1), (m2, l2, a2) = halves
    top = torch.maximum(m1, m2)
    w1, w2 = torch.exp2(m1 - top), torch.exp2(m2 - top)
    return ((a1 * w1 + a2 * w2) / (l1 * w1 + l2 * w2).clamp_min(1e-30)).transpose(1, 2)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,kw", [
    pytest.param(4, 45, 45, 4, 1, 16, dict(window=16), id="reduced-gemma3"),
    pytest.param(2, 64, 64, 8, 2, 80, {}, id="train100m-widths"),
    pytest.param(1, 40, 40, 6, 1, 160, dict(prefix_len=12), id="hd160-g6-prefix"),
    pytest.param(1, 12, 20, 4, 1, 32, dict(q_offset=15, window=4), id="empty-rows"),
])
def test_tf32x3_forward_arithmetic_keeps_fp32_parity(B, Sq, Skv, H, KV, hd, kw):
    """The tf32x3 forward's arithmetic (`_tf32x3_forward`) within 2e-5 of
    the reference's oracle (`repro.kernels.ref.attention`, fp32), where one
    TF32 product a product misses that tolerance: the premise of the
    variant, at a REDUCED shape and at the example's widths."""
    full = dict(causal=True, window=0, prefix_len=0, q_offset=0)
    full.update(kw)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(Sq + hd, B, Sq, Skv, H, KV, hd))
    want = tref.attention(q, k, v, **kw)
    if jref is not None:
        jwant = np.array(jref.attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                         jnp.asarray(v.numpy()), **kw))
        np.testing.assert_allclose(want.numpy(), jwant, rtol=TOL, atol=TOL)
        want = torch.from_numpy(jwant)
    errs = {}
    for passes in (3, 1):
        got = _tf32x3_forward(q, k, v, passes=passes, scale=hd**-0.5, **full)
        errs[passes] = float((got - want).abs().max())
    assert errs[3] <= 2e-5 < errs[1], errs


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
    (torch.float32, 2, 257, 8, 2, 80, {}),             # train_100m's head_dim, ragged
    (torch.bfloat16, 1, 256, 8, 2, 80, {"window": 64}),
    (torch.float32, 2, 45, 4, 1, 16, {"window": 16}),
    (torch.float32, 1, 40, 4, 1, 32, {"q_offset": 30, "window": 8}),
    # whisper-small's encoder (1500 frames: a ragged last key tile) and its
    # cross-attention (64 queries against 1500 keys, no mask)
    (torch.bfloat16, 2, 1500, 12, 12, 64, {"causal": False}),
    (torch.bfloat16, 2, 64, 12, 12, 64, {"causal": False, "skv": 1500}),
    # bf16 rows with no key (a window past the last key)
    (torch.bfloat16, 1, 40, 4, 1, 64, {"q_offset": 30, "window": 8, "skv": 50}),
    # gemma3-1b's training shape, one batch row
    (torch.bfloat16, 1, 1024, 4, 1, 256, {"window": 512}),
    # head dims padded to whole 64-column tiles, groups that do not divide
    # 64 (padding rows in every query tile), ragged Sq and Skv
    (torch.bfloat16, 1, 300, 32, 8, 160, {"window": 64}),
    (torch.bfloat16, 2, 77, 6, 1, 112, {}),
    (torch.bfloat16, 1, 130, 6, 1, 80, {"causal": False, "skv": 77}),
    (torch.bfloat16, 1, 257, 48, 1, 128, {}),
    (torch.bfloat16, 2, 100, 48, 8, 112, {"prefix_len": 30}),
    (torch.bfloat16, 1, 40, 48, 1, 160, {"q_offset": 30, "window": 8, "skv": 50}),
    (torch.bfloat16, 2, 129, 32, 32, 112, {}),  # zamba2-7b's heads, ragged
    (torch.float32, 1, 100, 48, 1, 112, {}),     # fp32 at those shapes: tf32x3
    # fp32 on tf32x3 at every head dim, split walks, prefix-LM, no-key rows
    (torch.float32, 4, 256, 8, 2, 80, {}),       # train_100m's shape: split dK/dV walks
    (torch.float32, 2, 200, 4, 1, 64, {"prefix_len": 50}),
    (torch.float32, 1, 300, 8, 2, 128, {"window": 64}),
    (torch.float32, 1, 100, 4, 1, 160, {"causal": False, "skv": 77}),
    (torch.float32, 1, 130, 4, 1, 256, {}),
    (torch.float32, 1, 40, 4, 1, 112, {"q_offset": 30, "window": 8, "skv": 50}),
    # what the rule leaves to simt: bf16 at hd 32, bf16 with more than 64
    # query heads a KV head, fp32 with q off 16 bytes
    (torch.bfloat16, 2, 64, 8, 2, 32, {"window": 16}),
    (torch.bfloat16, 1, 100, 72, 1, 64, {}),
    (torch.float32, 2, 257, 8, 2, 80, {"window": 64, "unaligned_q": True}),
])
def test_backward_kernel_matches_plain_on_card(cuda, dtype, B, S, H, KV, hd, kw):
    kw = dict(kw)
    Skv = kw.pop("skv", S + kw.get("q_offset", 0) // 3)
    unaligned = kw.pop("unaligned_q", False)
    gen = torch.Generator(device=cuda).manual_seed(S + hd)
    q = torch.randn((B, S, H, hd), generator=gen, device=cuda).to(dtype)
    if unaligned:  # the same values one element into a larger buffer
        q = torch.cat([q.new_zeros(1), q.flatten()])[1:].view(q.shape)
    k = torch.randn((B, Skv, KV, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, Skv, KV, hd), generator=gen, device=cuda).to(dtype)
    do = torch.randn((B, S, H, hd), generator=gen, device=cuda).to(dtype)
    out, lse = tflash.flash_attention_with_lse(q, k, v, **kw)
    kind = tflash.backward_variant(q, k, v)
    before = tflash.backward.variant_launches[kind]
    got = tflash.flash_attention_backward(q, k, v, out, lse, do, **kw)
    want = tref.attention_backward(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert tflash.backward.variant_launches[kind] == before + 1
    assert kind == ("simt" if unaligned else "tf32x3" if dtype == torch.float32 else
                    "wgmma" if H // KV <= 64 and hd >= 64 else "simt")
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5 if kind == "tf32x3" else 1e-4
    for name, a, b in zip("qkv", got, want):
        assert bool(torch.isfinite(a).all()), f"d{name} not finite"
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
        assert err <= tol, f"d{name}: {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("hd", tflash.SUPPORTED_HEAD_DIMS)
def test_tf32x3_tiling_matches_the_host_copy_on_card(cuda, hd):
    """The host's plan copies the kernels' query rows a visit and blocks an
    SM; the built kernels give theirs, and the card holds that many."""
    rows, per_sm, resident = tflash.tf32x3_tiling(hd)
    assert rows == tflash.tf32x3_walk_rows(hd)
    assert per_sm == tflash.tf32x3_blocks_per_sm(hd)
    assert resident >= per_sm


@pytest.mark.gpu
def test_backward_wgmma_gives_the_same_bits_every_run_on_card(cuda):
    """No atomics: the split walks' partials are added in a fixed order."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, do = (torch.randn((2, 512, 4, 256), generator=gen, device=cuda).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((2, 512, 1, 256), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    out, lse = tflash.flash_attention_with_lse(q, k, v)
    assert tflash.backward_plan(q, k)[1] > 1  # the split path
    first = tflash.flash_attention_backward(q, k, v, out, lse, do)
    second = tflash.flash_attention_backward(q, k, v, out, lse, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,KV,hd", [(1024, 48, 1, 128), (300, 48, 1, 112), (257, 6, 1, 160)],
                         ids=["granite-g48", "g48-hd112-ragged", "g6-hd160-ragged"])
def test_backward_wgmma_at_padded_rows_gives_the_same_bits_every_run_on_card(cuda, S, H, KV,
                                                                             hd):
    """Groups that do not divide 64 leave padding rows in every query tile;
    the walks stay split into fixed-order partials: no atomics, the same
    bits every run."""
    gen = torch.Generator(device=cuda).manual_seed(H + hd)
    q, do = (torch.randn((1, S, H, hd), generator=gen, device=cuda).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((1, S, KV, hd), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    out, lse = tflash.flash_attention_with_lse(q, k, v)
    assert tflash.backward_variant(q, k, v) == "wgmma"
    first = tflash.flash_attention_backward(q, k, v, out, lse, do)
    second = tflash.flash_attention_backward(q, k, v, out, lse, do)
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


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
@pytest.mark.parametrize("name", ["decode_attention", "paged_decode_attention", "fused_linear"])
def test_wrappers_without_backward_refuse_grad_mode_on_card(cuda, name):
    with pytest.raises(RuntimeError, match="requires grad.*no backward"):
        _no_backward_calls(cuda)[name]()
