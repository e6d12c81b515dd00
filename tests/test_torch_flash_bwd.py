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
        assert tops.variant_counts()["flash_attention_bwd"] == {"simt": 2000, "wgmma": 0}
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
    # ... REDUCED (fp32, hd 16), fp32 at a tensor-core shape, and alignment
    ("float32", 4, 1, 16, "aligned", "simt"),
    ("float32", 4, 1, 256, "aligned", "simt"),
    ("float32", 8, 2, 80, "aligned", "simt"),        # train_100m: fp32 stays exact
    ("bfloat16", 8, 2, 80, "aligned", "wgmma"),
    ("bfloat16", 64, 1, 64, "aligned", "wgmma"),     # 64 heads: one position a tile
    ("bfloat16", 72, 1, 64, "aligned", "simt"),      # more heads than a tile's rows
    ("bfloat16", 4, 1, 256, "unaligned-q", "simt"),
    ("bfloat16", 4, 1, 256, "unaligned-k", "simt"),
])
def test_backward_variant_rule(dtype, H, KV, hd, layout, want):
    dt = getattr(torch, dtype)
    q = _unaligned((1, 9, H, hd), dt) if layout == "unaligned-q" else torch.empty(
        (1, 9, H, hd), dtype=dt)
    k = _unaligned((1, 9, KV, hd), dt) if layout == "unaligned-k" else torch.empty(
        (1, 9, KV, hd), dtype=dt)
    v = torch.empty((1, 9, KV, hd), dtype=dt)
    assert tflash.backward_variant(q, k, v) == want
    assert tflash.backward_variant(q, k, v) == tflash.variant(q, k, v)  # the forward's rule


def test_backward_counter_counts_by_variant():
    tops.reset_launch_counts()
    try:
        assert set(tflash.backward.variant_launches) == {"simt", "wgmma"}
        tbuild.count_launch(tflash.backward, "wgmma")
        tbuild.count_launch(tflash.backward, "wgmma")
        tbuild.count_launch(tflash.backward, "simt")
        assert tops.launch_counts()["flash_attention_bwd"] == 3
        assert tops.variant_counts()["flash_attention_bwd"] == {"simt": 1, "wgmma": 2}
    finally:
        tops.reset_launch_counts()
    assert tops.variant_counts()["flash_attention_bwd"] == {"simt": 0, "wgmma": 0}


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
    (torch.float32, 1, 100, 48, 1, 112, {}),     # fp32 at those shapes stays on simt
])
def test_backward_kernel_matches_plain_on_card(cuda, dtype, B, S, H, KV, hd, kw):
    kw = dict(kw)
    Skv = kw.pop("skv", S + kw.get("q_offset", 0) // 3)
    gen = torch.Generator(device=cuda).manual_seed(S + hd)
    q = torch.randn((B, S, H, hd), generator=gen, device=cuda).to(dtype)
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
    assert kind == ("wgmma" if dtype == torch.bfloat16 and H // KV <= 64 and hd >= 64
                    else "simt")
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, b in zip("qkv", got, want):
        assert bool(torch.isfinite(a).all()), f"d{name} not finite"
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
        assert err <= tol, f"d{name}: {err}"


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
