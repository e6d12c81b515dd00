"""The gradient of the port's gated linear scan: the plain backward, the
autograd wiring, the backward kernel's wrapper and, on the card, the kernel.

On the CPU `ref.gated_linear_scan_backward` (autograd through the plain
chunked scan) is held against `jax.vjp` of the reference's oracle
`repro.kernels.ref.gated_linear_scan` (the reference trains through it: its
Pallas scan has no VJP), with the mLSTM's normaliser as the reference's
second call with v = ones (`repro/models/ssm.py:95-97`), with and without
an initial state and a final-state gradient, in fp32 within max |d| / max
|ref| <= 2e-5 (the reference's fp32 tolerance, `tests/test_kernels.py:26`).
A line-by-line model of the kernel's algorithm (the per-position forward and
reverse walks over 32-column tiles, the tiles' partials added in order,
dlog_a from the identity dA_t = q_t . dq_t - k_t . dk_t and a reverse sum)
is held against the plain backward, so the arithmetic the CUDA source
follows is tested where no kernel runs. `GatedLinearScanFn` runs with the
plain forward and backward. Tests marked ``gpu`` hold the kernel against the
plain version on the card at REDUCED shapes: max |d| / max |plain| within
1e-4 in fp32, 2e-2 in bf16 (the flash backward's).
"""
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
from repro_torch.kernels import linear_scan as tscan  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 2e-5
NAMES = ("dq", "dk", "dv", "dlog_a", "d_initial_state", "d_initial_normaliser")


def _inputs(seed, B, H, S, dk, dv, *, state=False, norm=False, d_state=False):
    """q, k, v, log_a, the initial states (or None) and the outputs'
    gradients (dy, d_state, dnrm, dn; None where the case has none), fp32
    numpy, scales as `tests/test_kernels.py::TestGatedLinearScan`."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = 0.5 * f(B, H, S, dk), 0.5 * f(B, H, S, dk), f(B, H, S, dv)
    log_a = -np.log1p(np.exp(f(B, H, S))).astype(np.float32)  # -softplus: a in (0, 1)
    s0 = 0.5 * f(B, H, dk, dv) if state else None
    n0 = f(B, H, dk, 1) if state and norm else None
    dy = f(B, H, S, dv)
    ds = f(B, H, dk, dv) if d_state else None
    dnrm = f(B, H, S, 1) if norm else None
    dn = f(B, H, dk, 1) if norm and d_state else None
    return (q, k, v, log_a, s0, n0), (dy, ds, dnrm, dn)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _plain(ins, grads, *, chunk, norm):
    q, k, v, log_a, s0, n0 = map(_t, ins)
    dy, ds, dnrm, dn = map(_t, grads)
    kw = dict(normaliser=True, initial_normaliser=n0, dnrm=dnrm, dn=dn) if norm else {}
    return tref.gated_linear_scan_backward(q, k, v, log_a, dy, ds, chunk=chunk,
                                           initial_state=s0, **kw)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (B, H, S, dk, dv, chunk, state, d_state, norm): S a multiple of chunk, as
# the reference's scan asserts
CASES = [
    pytest.param(2, 2, 32, 8, 8, 16, False, False, False, id="plain"),
    pytest.param(1, 2, 64, 16, 12, 16, True, True, False, id="state-dstate"),
    pytest.param(2, 1, 48, 8, 16, 16, False, False, True, id="normaliser"),
    pytest.param(1, 2, 32, 16, 8, 8, True, True, True, id="normaliser-state-dstate"),
    pytest.param(2, 2, 64, 32, 32, 32, True, False, True, id="reduced-xlstm-state"),
]


@pytest.mark.skipif(jax is None, reason="needs the JAX reference")
@pytest.mark.parametrize("B,H,S,dk,dv,chunk,state,d_state,norm", CASES)
def test_plain_backward_matches_jax_vjp(B, H, S, dk, dv, chunk, state, d_state, norm):
    ins, grads = _inputs(B * S + dk, B, H, S, dk, dv, state=state, norm=norm, d_state=d_state)
    q, k, v, log_a, s0, n0 = ins
    dy, ds, dnrm, dn = grads

    def ref_fn(q, k, v, log_a, s0, n0):
        y, st = jref.gated_linear_scan(q, k, v, log_a, chunk=chunk, initial_state=s0)
        if not norm:
            return y, st
        ones = jnp.ones(q.shape[:3] + (1,), q.dtype)
        nrm, n = jref.gated_linear_scan(q, k, ones, log_a, chunk=chunk, initial_state=n0)
        return y, st, nrm, n

    primals = [jnp.asarray(x) for x in (q, k, v, log_a)]
    zeros = lambda shape: np.zeros(shape, np.float32)  # noqa: E731
    s0_ = jnp.asarray(s0 if s0 is not None else zeros((B, H, dk, dv)))
    n0_ = jnp.asarray(n0 if n0 is not None else zeros((B, H, dk, 1)))
    outs, vjp = jax.vjp(ref_fn, *primals, s0_, n0_)
    cot = [dy, ds if ds is not None else zeros((B, H, dk, dv))]
    if norm:
        cot += [dnrm, dn if dn is not None else zeros((B, H, dk, 1))]
    want = vjp(tuple(jnp.asarray(c) for c in cot))
    got = _plain(ins, grads, chunk=chunk, norm=norm)
    for name, g, w, given in zip(NAMES, got, want, (1, 1, 1, 1, s0, n0)):
        if given is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert _rel_err(g.numpy(), w) <= TOL, f"{name}: {_rel_err(g.numpy(), w):.2e}"


def _kernel_model(ins, grads, *, norm, tile=tscan.BWD_TILE):
    """The backward kernel's arithmetic in fp32 torch, as
    `csrc/linear_scan_bwd.cu` orders it: per column tile of the extended
    value matrix [v | 1], a forward walk (S_t = a_t S_{t-1} + k_t^T v_t,
    dq partial dy_t S_t^T) and a reverse walk (G_t = a_{t+1} G_{t+1} +
    q_t^T dy_t, dk partial G_t v_t^T, dv_t = k_t G_t, d(init) = a_0 G_0);
    the tiles' partials added in tile order; dA_t = q_t . dq_t - k_t . dk_t
    (+ <dS, S_final> at the last position) and its reverse sum in fp64."""
    q, k, v, log_a, s0, n0 = map(_t, ins)
    dy, ds, dnrm, dn = map(_t, grads)
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    ext = lambda x, col: torch.cat([x, col], -1) if norm else x  # noqa: E731
    zeros = lambda *s: torch.zeros(s)  # noqa: E731
    V = ext(v, torch.ones(B, H, S, 1))
    DY = ext(dy, dnrm if dnrm is not None else zeros(B, H, S, 1))
    S0 = ext(s0 if s0 is not None else zeros(B, H, dk, dv),
             n0 if n0 is not None else zeros(B, H, dk, 1))
    DS = ext(ds if ds is not None else zeros(B, H, dk, dv),
             dn if dn is not None else zeros(B, H, dk, 1))
    a = torch.exp(log_a)
    dq_parts, dk_parts, fin_parts, dV, dS0 = [], [], [], [], []
    for j0 in range(0, V.shape[-1], tile):
        cols = slice(j0, j0 + tile)
        st, dq_p = S0[..., cols].clone(), []
        for t in range(S):
            st = a[..., t, None, None] * st + k[:, :, t, :, None] * V[:, :, t, None, cols]
            dq_p.append((st * DY[:, :, t, None, cols]).sum(-1))
        fin_parts.append((DS[..., cols] * st).sum((-1, -2)))
        g, dk_p, dv_p = DS[..., cols].clone(), [None] * S, [None] * S
        for t in reversed(range(S)):
            g = g + q[:, :, t, :, None] * DY[:, :, t, None, cols]
            dk_p[t] = (g * V[:, :, t, None, cols]).sum(-1)
            dv_p[t] = (k[:, :, t, :, None] * g).sum(-2)
            g = a[..., t, None, None] * g
        dq_parts.append(torch.stack(dq_p, 2))
        dk_parts.append(torch.stack(dk_p, 2))
        dV.append(torch.stack(dv_p, 2))
        dS0.append(g)
    dq_, dk_ = sum(dq_parts[1:], dq_parts[0]), sum(dk_parts[1:], dk_parts[0])
    dA = (q * dq_).sum(-1) - (k * dk_).sum(-1)
    dA[..., -1] += sum(fin_parts[1:], fin_parts[0])
    dla = torch.flip(torch.cumsum(torch.flip(dA.double(), (-1,)), -1), (-1,)).float()
    dV, dS0 = torch.cat(dV, -1), torch.cat(dS0, -1)
    return (dq_, dk_, dV[..., :dv], dla, dS0[..., :dv] if s0 is not None else None,
            dS0[..., dv:] if n0 is not None else None)


@pytest.mark.parametrize("B,H,S,dk,dv,chunk,state,d_state,norm", CASES)
def test_kernel_algorithm_matches_plain_backward(B, H, S, dk, dv, chunk, state, d_state, norm):
    """Two tiles or more where the extended columns pass 32 (dv 32 plus
    the normaliser): the partial sums over tiles are exercised."""
    ins, grads = _inputs(B * S + dv, B, H, S, dk, dv, state=state, norm=norm, d_state=d_state)
    got = _kernel_model(ins, grads, norm=norm)
    want = _plain(ins, grads, chunk=chunk, norm=norm)
    for name, g, w in zip(NAMES, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert _rel_err(g.numpy(), w.numpy()) <= 1e-5, f"{name}: {_rel_err(g, w):.2e}"


def _fn_grads(fn, q, k, v, la, s0, n0, grads, kw):
    """Gradients with respect to (q, k, v, log_a, s0, n0) of the sum of each
    output times its given gradient, `fn` returning the outputs."""
    leaves = [t.clone().requires_grad_() if t is not None else None
              for t in (q, k, v, la, s0, n0)]
    outs = fn(*leaves, kw)
    total = sum((o * g).sum() for o, g in zip(outs, grads) if g is not None)
    wrt = [t for t in leaves if t is not None]
    return torch.autograd.grad(total, wrt)


@pytest.mark.parametrize("norm,state,broadcast_q", [(False, False, False), (True, True, False),
                                                    (False, True, True)])
def test_function_with_plain_versions_matches_autograd(norm, state, broadcast_q):
    """`GatedLinearScanFn` with the plain forward (`ops.gated_linear_scan` on
    CPU tensors) and backward against autograd through the plain version,
    Mamba2's q broadcast over the heads (stride 0) included."""
    ins, grads = _inputs(5, 2, 3, 32, 8, 16, state=state, norm=norm, d_state=True)
    q, k, v, la, s0, n0 = map(_t, ins)
    if broadcast_q:
        q = q[:, :1].expand(q.shape)
    grads = [_t(g) for g in grads]
    kw = dict(chunk=16, normaliser=norm)

    def via_fn(q, k, v, la, s0, n0, kw):
        return tscan.GatedLinearScanFn.apply(q, k, v, la, s0, n0, tops.gated_linear_scan,
                                             tref.gated_linear_scan_backward, kw)

    def plain(q, k, v, la, s0, n0, kw):
        return tops.gated_linear_scan(q, k, v, la, initial_state=s0, initial_normaliser=n0, **kw)

    got = _fn_grads(via_fn, q, k, v, la, s0, n0, grads, kw)
    want = _fn_grads(plain, q, k, v, la, s0, n0, grads, kw)
    assert len(got) == len(want) == 4 + (s0 is not None) + (n0 is not None)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_function_passes_missing_output_gradients_as_none():
    """Only y reaches the loss: the backward gets None for the final state
    (and nothing is materialised), and the result equals autograd's."""
    ins, _ = _inputs(6, 1, 2, 16, 8, 8)
    q, k, v, la, _, _ = (_t(x).requires_grad_() if x is not None else None for x in ins)
    seen = []

    def bwd(*args, **kw):
        seen.append(args[5])
        return tref.gated_linear_scan_backward(*args, **kw)

    y, _ = tscan.GatedLinearScanFn.apply(q, k, v, la, None, None, tops.gated_linear_scan, bwd,
                                         dict(chunk=8, normaliser=False))
    got = torch.autograd.grad(y.square().sum(), (q, k, v, la))
    want = torch.autograd.grad(tref.gated_linear_scan(q, k, v, la, chunk=8)[0].square().sum(),
                               (q, k, v, la))
    assert seen == [None]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_backward_wrapper_checks_its_operands():
    q = torch.zeros((1, 2, 5, 8))
    la = torch.zeros((1, 2, 5))
    with pytest.raises(ValueError, match="CUDA"):
        tscan.gated_linear_scan_backward(q, q, q, la, q, None)
    with pytest.raises(ValueError, match="shapes"):
        tscan.gated_linear_scan_backward(q, q, q, torch.zeros((1, 2, 4)), q, None)
    with pytest.raises(ValueError, match="normaliser=True"):
        tscan.gated_linear_scan_backward(q, q, q, la, q, None, dnrm=torch.zeros((1, 2, 5, 1)))
    with pytest.raises(ValueError, match="dtype"):
        tscan.gated_linear_scan_backward(q.double(), q.double(), q.double(), la, None, None)
    with pytest.raises(ValueError, match="log_a dtype"):
        tscan.gated_linear_scan_backward(q, q, q, la.double(), None, None)
    with pytest.raises(ValueError, match="normaliser=True"):
        tref.gated_linear_scan_backward(q, q, q, la, q, None, chunk=5,
                                        dn=torch.zeros((1, 2, 8, 1)))


def test_backward_scratch_covers_every_tile():
    """Column tiles of 32 over the extended columns: xlstm's 384 + the
    normaliser take 13 tiles, Mamba2's 224 take 7."""
    B, H, S, dk = 4, 4, 2048, 384
    assert tscan.backward_scratch_elements(B, H, S, dk, 384, True) == (
        2 * 13 * B * H * S * dk + 13 * B * H + B * H * S)
    assert tscan.backward_scratch_elements(2, 32, 1024, 64, 224, False) == (
        2 * 7 * 2 * 32 * 1024 * 64 + 7 * 2 * 32 + 2 * 32 * 1024)


def test_backward_counter_counts_by_variant():
    tops.reset_launch_counts()
    assert tops.launch_counts()["gated_linear_scan_bwd"] == 0
    assert tops.variant_counts()["gated_linear_scan_bwd"] == {"simt": 0}
    tbuild.count_launch(tscan.backward, "simt")
    assert tops.launch_counts()["gated_linear_scan_bwd"] == 1
    assert tops.variant_counts()["gated_linear_scan_bwd"] == {"simt": 1}
    tops.reset_launch_counts()
    assert tscan.backward.launches == 0 and tscan.backward.variant_launches == {"simt": 0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_case(cuda, dtype, B, H, S, dk, dv, *, state, norm, d_state, broadcast_q=False):
    gen = torch.Generator(device=cuda).manual_seed(S + dk + dv)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda)  # noqa: E731
    q = (0.5 * r(B, 1 if broadcast_q else H, S, dk)).to(dtype).expand(B, H, S, dk)
    k, v = (0.5 * r(B, H, S, dk)).to(dtype), r(B, H, S, dv).to(dtype)
    la = -torch.nn.functional.softplus(r(B, H, S))
    s0 = 0.5 * r(B, H, dk, dv) if state else None
    n0 = r(B, H, dk, 1) if state and norm else None
    dy = r(B, H, S, dv).to(dtype)
    ds = r(B, H, dk, dv) if d_state else None
    dnrm = r(B, H, S, 1).to(dtype) if norm else None
    dn = r(B, H, dk, 1) if norm and d_state else None
    kw = dict(initial_state=s0)
    if norm:
        kw.update(normaliser=True, initial_normaliser=n0, dnrm=dnrm, dn=dn)
    return (q, k, v, la, dy, ds), kw


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,H,S,dk,dv,state,norm,d_state,broadcast_q", [
    (torch.float32, 2, 4, 45, 32, 32, True, True, True, False),  # REDUCED xlstm, ragged S
    (torch.float32, 2, 4, 64, 16, 32, False, False, False, True),  # REDUCED Mamba2
    (torch.bfloat16, 2, 4, 130, 64, 64, True, True, True, False),
    (torch.bfloat16, 1, 8, 200, 64, 96, False, False, True, True),
])
def test_backward_kernel_matches_plain_on_card(cuda, dtype, B, H, S, dk, dv, state, norm,
                                              d_state, broadcast_q):
    args, kw = _card_case(cuda, dtype, B, H, S, dk, dv, state=state, norm=norm,
                          d_state=d_state, broadcast_q=broadcast_q)
    before = tscan.backward.launches
    got = tscan.gated_linear_scan_backward(*args, **kw)
    import math
    want = tref.gated_linear_scan_backward(*args, chunk=math.gcd(S, 16), **kw)
    torch.cuda.synchronize()
    assert tscan.backward.launches == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, b in zip(NAMES, got, want):
        assert (a is None) == (b is None), name
        if b is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), f"{name} not finite"
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
        assert err <= tol, f"{name}: {err}"


@pytest.mark.gpu
def test_backward_kernel_gives_the_same_bits_every_run_on_card(cuda):
    args, kw = _card_case(cuda, torch.bfloat16, 2, 4, 100, 64, 64, state=True, norm=True,
                          d_state=True)
    first = tscan.gated_linear_scan_backward(*args, **kw)
    second = tscan.gated_linear_scan_backward(*args, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_scan_gradient_goes_through_the_kernels_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, 4, 40, 16), generator=gen, device=cuda).requires_grad_()
               for _ in range(3))
    la = (-torch.rand((2, 4, 40), generator=gen, device=cuda)).requires_grad_()
    tops.reset_launch_counts()
    y, st, nrm, n = tops.gated_linear_scan(q, k, v, la, chunk=8, normaliser=True)
    got = torch.autograd.grad((y.square().sum() + nrm.sum()), (q, k, v, la))
    counts = tops.launch_counts()
    y2, _, nrm2, _ = tref.gated_linear_scan_normalised(q, k, v, la, chunk=8)
    want = torch.autograd.grad((y2.square().sum() + nrm2.sum()), (q, k, v, la))
    assert counts["gated_linear_scan"] == 1 and counts["gated_linear_scan_bwd"] == 1
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
