"""The gradient of the port's gated linear scan: the plain backward, the
autograd wiring, the backward kernel's wrapper and, on the card, the kernel.

On the CPU `ref.gated_linear_scan_backward` (autograd through the plain
chunked scan) is held against `jax.vjp` of the reference's oracle
`repro.kernels.ref.gated_linear_scan` (the reference trains through it: its
Pallas scan has no VJP), with the mLSTM's normaliser as the reference's
second call with v = ones (`repro/models/ssm.py:95-97`), with and without
an initial state and a final-state gradient, in fp32 within max |d| / max
|ref| <= 2e-5 (the reference's fp32 tolerance, `tests/test_kernels.py:26`).
Models of the two kernels' algorithms are held against the plain backward,
so the arithmetic the CUDA source follows is tested where no kernel runs:
``simt``'s per-position forward and reverse walks over 32-column tiles, and
``mma``'s chunkwise walks (16-position chunks, the gates exp(A_i - A_j)
formed only for j <= i, the state products of each column tile, the tiles'
partials added in tile order), the latter also against `jax.vjp` of the
reference's oracle and with its non-exact operands rounded to bf16 hi + lo
halves as the kernel rounds them; both form dlog_a from the identity
dA_t = q_t . dq_t - k_t . dk_t and a reverse sum in fp64. The rule between
the variants, their counters and scratch are checked too.
`GatedLinearScanFn` runs with the plain forward and backward. Tests marked
``gpu`` hold both kernels against the plain version on the card at REDUCED
shapes: max |d| / max |plain| within 1e-4 in fp32, 2e-2 in bf16 (the flash
backward's).
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


def _bf16_pair(x):
    """x as the kernel feeds a non-exact operand to the tensor cores: bf16(x)
    plus bf16 of the remainder, in fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def _mma_model(ins, grads, *, norm, tile, L=16, split=False):
    """The tensor-core kernel's chunkwise arithmetic in fp32 torch, as
    `csrc/linear_scan_bwd.cu::scan_bwd_mma_kernel` orders it. Per column
    tile of the extended value matrix [v | 1] and chunk of L positions
    (A the chunk's cumulative log decay in fp64, Gamma_ij = exp(A_i - A_j)
    formed only for j <= i, P = dY V^T o Gamma over the tile's columns, R =
    Q K^T o Gamma): the forward walk, dq = exp(A_i) dY S_prev^T + P K and
    S = exp(a_tot) S + K^T (V exp(a_tot - A)); the reverse walk from dS,
    dk = exp(a_tot - A_i) V dS^T + P^T Q, dv = exp(a_tot - A_i) K dS + R^T dY
    and dS = exp(a_tot) dS + Q^T (dY exp(A)). The tiles' dq and dk partials
    are added in tile order; dA_t = q_t . dq_t - k_t . dk_t in fp64 from the
    two fp32 halves, plus the tiles' <dS, S_final> at the last position, and
    its reverse sum in fp64. With `split`, every operand that is not exact
    in bf16 (the state and its gradient, P and R, the scaled v and dy) is
    rounded to bf16 hi + lo halves as the kernel rounds it."""
    q, k, v, log_a, s0, n0 = map(_t, ins)
    dy, ds, dnrm, dn = map(_t, grads)
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    rnd = _bf16_pair if split else (lambda x: x)  # noqa: E731
    ext = lambda x, col: torch.cat([x, col], -1) if norm else x  # noqa: E731
    zeros = lambda *s: torch.zeros(s)  # noqa: E731
    V = ext(v, torch.ones(B, H, S, 1))
    DY = ext(dy, dnrm if dnrm is not None else zeros(B, H, S, 1))
    S0 = ext(s0 if s0 is not None else zeros(B, H, dk, dv),
             n0 if n0 is not None else zeros(B, H, dk, 1))
    DS = ext(ds if ds is not None else zeros(B, H, dk, dv),
             dn if dn is not None else zeros(B, H, dk, 1))
    nch = -(-S // L)
    pad = nch * L - S  # rows past S are zero and decay by exp(0) = 1
    padS = lambda x: torch.nn.functional.pad(x, (0, 0, 0, pad))  # noqa: E731
    Qp, Kp, Vp, DYp = padS(q), padS(k), padS(V), padS(DY)
    la = torch.nn.functional.pad(log_a, (0, pad)).double()
    tri = torch.ones(L, L, dtype=torch.bool).tril()
    chunks = []
    for c in range(nch):
        sl = slice(c * L, (c + 1) * L)
        A = torch.cumsum(la[..., sl], -1)
        a_tot = A[..., -1:]
        diff = torch.where(tri, A[..., :, None] - A[..., None, :], torch.zeros((), dtype=A.dtype))
        gam = torch.where(tri, torch.exp(diff.float()), torch.zeros(()))
        chunks.append((sl, gam, torch.exp(A.float()), torch.exp((a_tot - A).float()),
                       torch.exp(a_tot.float())[..., None]))
    dq_parts, dk_parts, fin_parts, dV, dS0 = [], [], [], [], []
    for j0 in range(0, V.shape[-1], tile):
        cols = slice(j0, j0 + tile)
        st, dq_p = S0[..., cols].clone(), torch.zeros(B, H, nch * L, dk)
        for sl, gam, eA, gl, e_tot in chunks:
            Kc, Vc, Yc = Kp[:, :, sl], Vp[:, :, sl, cols], DYp[:, :, sl, cols]
            P = rnd((Yc @ Vc.transpose(-1, -2)) * gam)
            dq_p[:, :, sl] = eA[..., None] * (Yc @ rnd(st).transpose(-1, -2)) + P @ Kc
            st = e_tot * st + Kc.transpose(-1, -2) @ rnd(Vc * gl[..., None])
        fin_parts.append((DS[..., cols] * st).sum((-1, -2)))
        x = DS[..., cols].clone()
        dk_p = torch.zeros(B, H, nch * L, dk)
        dv_p = torch.zeros(B, H, nch * L, Vp[..., cols].shape[-1])
        for sl, gam, eA, gl, e_tot in reversed(chunks):
            Qc, Kc, Vc, Yc = Qp[:, :, sl], Kp[:, :, sl], Vp[:, :, sl, cols], DYp[:, :, sl, cols]
            P = rnd((Yc @ Vc.transpose(-1, -2)) * gam)
            R = rnd((Qc @ Kc.transpose(-1, -2)) * gam)
            xs = rnd(x)
            dk_p[:, :, sl] = gl[..., None] * (Vc @ xs.transpose(-1, -2)) + P.transpose(-1, -2) @ Qc
            dv_p[:, :, sl] = gl[..., None] * (Kc @ xs) + R.transpose(-1, -2) @ Yc
            x = e_tot * x + Qc.transpose(-1, -2) @ rnd(Yc * eA[..., None])
        dq_parts.append(dq_p[:, :, :S])
        dk_parts.append(dk_p[:, :, :S])
        dV.append(dv_p[:, :, :S])
        dS0.append(x)
    dq_, dk_ = sum(dq_parts[1:], dq_parts[0]), sum(dk_parts[1:], dk_parts[0])
    dA = (q * dq_).sum(-1).double() - (k * dk_).sum(-1).double()
    dA[..., -1] += sum(fin_parts[1:], fin_parts[0]).double()
    dla = torch.flip(torch.cumsum(torch.flip(dA, (-1,)), -1), (-1,)).float()
    dV, dS0 = torch.cat(dV, -1), torch.cat(dS0, -1)
    return (dq_, dk_, dV[..., :dv], dla, dS0[..., :dv] if s0 is not None else None,
            dS0[..., dv:] if n0 is not None else None)


def _jax_vjp(ins, grads, *, chunk, norm):
    """The reference's gradient: `jax.vjp` of its oracle (with the
    normaliser as its second call with v = ones), zeros for what is absent."""
    q, k, v, log_a, s0, n0 = ins
    dy, ds, dnrm, dn = grads
    B, H, S, dk = q.shape
    dv = v.shape[-1]

    def ref_fn(q, k, v, log_a, s0, n0):
        y, st = jref.gated_linear_scan(q, k, v, log_a, chunk=chunk, initial_state=s0)
        if not norm:
            return y, st
        ones = jnp.ones(q.shape[:3] + (1,), q.dtype)
        nrm, n = jref.gated_linear_scan(q, k, ones, log_a, chunk=chunk, initial_state=n0)
        return y, st, nrm, n

    zeros = lambda shape: np.zeros(shape, np.float32)  # noqa: E731
    primals = [jnp.asarray(x) for x in (q, k, v, log_a)]
    s0_ = jnp.asarray(s0 if s0 is not None else zeros((B, H, dk, dv)))
    n0_ = jnp.asarray(n0 if n0 is not None else zeros((B, H, dk, 1)))
    _, vjp = jax.vjp(ref_fn, *primals, s0_, n0_)
    cot = [dy, ds if ds is not None else zeros((B, H, dk, dv))]
    if norm:
        cot += [dnrm, dn if dn is not None else zeros((B, H, dk, 1))]
    return vjp(tuple(jnp.asarray(c) for c in cot))


# (B, H, S, dk, dv, reference chunk, state, d_state, norm, broadcast q,
# column tile): S ragged against the model's 16-position chunks, the
# reference's chunk dividing S
MMA_CASES = [
    pytest.param(2, 2, 40, 16, 24, 8, False, False, True, False, 16, id="ragged-normaliser"),
    pytest.param(1, 2, 48, 32, 40, 16, True, True, False, False, 16, id="state-dstate-3-tiles"),
    pytest.param(1, 2, 33, 16, 32, 11, True, True, True, False, 32, id="ragged-normaliser-state"),
    pytest.param(2, 3, 32, 16, 24, 16, False, True, False, True, 16, id="mamba2-broadcast-q"),
]


@pytest.mark.skipif(jax is None, reason="needs the JAX reference")
@pytest.mark.parametrize("B,H,S,dk,dv,chunk,state,d_state,norm,bq,tile", MMA_CASES)
def test_mma_kernel_algorithm_matches_plain_and_jax(B, H, S, dk, dv, chunk, state, d_state,
                                                    norm, bq, tile):
    """The chunkwise model against the plain backward and against the
    reference's jax.vjp, within 1e-5 (fp32 sums in another order)."""
    ins, grads = _inputs(7 * S + dv, B, H, S, dk, dv, state=state, norm=norm, d_state=d_state)
    if bq:  # Mamba2: q = C broadcast over the heads
        ins = (np.broadcast_to(ins[0][:, :1], ins[0].shape).copy(),) + ins[1:]
    got = _mma_model(ins, grads, norm=norm, tile=tile)
    plain = _plain(ins, grads, chunk=chunk, norm=norm)
    ref = _jax_vjp(ins, grads, chunk=chunk, norm=norm)
    for name, g, w, r, given in zip(NAMES, got, plain, ref, (1, 1, 1, 1) + ins[4:]):
        assert (g is None) == (w is None) == (given is None), name
        if w is None:
            continue
        assert _rel_err(g.numpy(), w.numpy()) <= 1e-5, f"{name} vs plain: {_rel_err(g, w):.2e}"
        assert _rel_err(g.numpy(), r) <= 1e-5, f"{name} vs jax.vjp: {_rel_err(g.numpy(), r):.2e}"


@pytest.mark.parametrize("norm,state", [(True, True), (False, False)])
def test_mma_kernel_rounding_stays_within_bf16_tolerance(norm, state):
    """bf16 operands (q, k, v, dy exact in bf16, as on the card) at xlstm-like
    decays (log_a down to -2 a position: A reaches -32 within a chunk), the
    model rounding the state, its gradient, P, R and the scaled v and dy to
    bf16 hi + lo halves as the kernel does: well inside the bf16 tolerance
    of 2e-2 against the plain backward in fp32 on the same operands."""
    B, H, S, dk, dv = 1, 2, 70, 32, 24
    ins, grads = _inputs(11, B, H, S, dk, dv, state=state, norm=norm, d_state=state)
    rng = np.random.default_rng(12)
    log_a = (-2.0 * rng.random((B, H, S))).astype(np.float32)
    bf = lambda x: None if x is None else _t(x).to(torch.bfloat16).float().numpy()  # noqa: E731
    ins = (bf(ins[0]), bf(ins[1]), bf(ins[2]), log_a) + ins[4:]
    grads = (bf(grads[0]),) + grads[1:2] + (bf(grads[2]),) + grads[3:]
    got = _mma_model(ins, grads, norm=norm, tile=16, split=True)
    want = _plain(ins, grads, chunk=2, norm=norm)
    for name, g, w in zip(NAMES, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert _rel_err(g.numpy(), w.numpy()) <= 1e-4, f"{name}: {_rel_err(g, w):.2e}"


def test_backward_variant_rule():
    """bf16 that the forward's tensor-core layout takes, with at most 8
    column tiles of 64, runs mma (Mamba2's stride-0 q included); fp32, a
    misaligned layout, dk past 384 and too many columns run simt."""
    def ops(dtype, dk=64, dv=64, B=1, H=2, S=20):
        q = torch.zeros((B, H, S, dk), dtype=dtype)
        return q, q.clone(), torch.zeros((B, H, S, dv), dtype=dtype)

    q, k, v = ops(torch.bfloat16)
    assert tscan.backward_variant(q, k, v) == "mma"
    assert tscan.backward_variant(q[:, :1].expand(q.shape), k, v) == "mma"
    assert tscan.backward_variant(*ops(torch.bfloat16, 384, 384), normaliser=True) == "mma"
    assert tscan.backward_variant(*ops(torch.bfloat16, 64, 512)) == "mma"
    assert tscan.backward_variant(*ops(torch.bfloat16, 64, 512), normaliser=True) == "simt"
    assert tscan.backward_variant(*ops(torch.float32)) == "simt"
    assert tscan.backward_variant(*ops(torch.bfloat16, 392, 64)) == "simt"
    assert tscan.backward_variant(*ops(torch.bfloat16, 60, 64)) == "simt"
    wide = torch.zeros((1, 2, 20, 72), dtype=torch.bfloat16)
    assert tscan.backward_variant(wide[..., 4:68], k, v) == "simt"  # rows off 16 bytes


def test_backward_tile_columns_rule():
    """The narrowest tile whose grid fits one wave, of those that cut the
    columns into at most 8 tiles (one cluster), else the widest."""
    assert tscan.backward_tile_columns(4, 4, 385, 132) == 64  # xlstm: 7 tiles x 16
    assert tscan.backward_tile_columns(2, 32, 224, 132) == 64  # Mamba2: 4 tiles x 64
    assert tscan.backward_tile_columns(2, 4, 33, 132) == 16  # REDUCED xlstm: 3 x 8
    assert tscan.backward_tile_columns(1, 2, 385, 132) == 64  # 25 or 13 tiles: too many
    assert tscan.backward_tile_columns(8, 8, 100, 132) == 64  # 448, 256, then 128 blocks
    assert tscan.backward_tile_columns(8, 8, 100, 300) == 32


def test_backward_refuses_a_variant_the_operands_cannot_take():
    q = torch.zeros((1, 2, 5, 8))
    la = torch.zeros((1, 2, 5))
    with pytest.raises(ValueError, match="mma variant cannot take"):
        tscan.gated_linear_scan_backward(q, q, q, la, q, None, variant="mma")
    with pytest.raises(ValueError, match="variant 'wgmma'"):
        tscan.gated_linear_scan_backward(q, q, q, la, q, None, variant="wgmma")
    qb = torch.zeros((1, 2, 5, 400), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dk 400 > 384"):
        tscan.gated_linear_scan_backward(qb, qb, qb, la, None, None, variant="mma")


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
    """simt: column tiles of 32 over the extended columns: xlstm's 384 + the
    normaliser take 13 tiles, Mamba2's 224 take 7, each with dq and dk
    partials. mma: each tile's share of the two halves of dA and its
    final-state dot: xlstm's 385 columns take 7 tiles of 64, Mamba2's 224
    take 4 (14 of 16 at REDUCED widths)."""
    B, H, S, dk = 4, 4, 2048, 384
    assert tscan.backward_scratch_elements(B, H, S, dk, 384, True) == (
        2 * 13 * B * H * S * dk + 13 * B * H + B * H * S)
    assert tscan.backward_scratch_elements(2, 32, 1024, 64, 224, False) == (
        2 * 7 * 2 * 32 * 1024 * 64 + 7 * 2 * 32 + 2 * 32 * 1024)
    assert tscan.backward_scratch_elements(B, H, S, dk, 384, True, variant="mma", tile=64) == (
        2 * 7 * B * H * S + 7 * B * H)
    assert tscan.backward_scratch_elements(2, 32, 1024, 64, 224, False, variant="mma",
                                           tile=64) == 2 * 4 * 2 * 32 * 1024 + 4 * 2 * 32
    assert tscan.backward_scratch_elements(2, 4, 45, 32, 224, False, variant="mma",
                                           tile=16) == 2 * 14 * 2 * 4 * 45 + 14 * 2 * 4


def test_backward_counter_counts_by_variant():
    tops.reset_launch_counts()
    assert tops.launch_counts()["gated_linear_scan_bwd"] == 0
    assert tops.variant_counts()["gated_linear_scan_bwd"] == {"simt": 0, "mma": 0}
    tbuild.count_launch(tscan.backward, "simt")
    tbuild.count_launch(tscan.backward, "mma")
    tbuild.count_launch(tscan.backward, "mma")
    assert tops.launch_counts()["gated_linear_scan_bwd"] == 3
    assert tops.variant_counts()["gated_linear_scan_bwd"] == {"simt": 1, "mma": 2}
    tops.reset_launch_counts()
    assert tscan.backward.launches == 0
    assert tscan.backward.variant_launches == {"simt": 0, "mma": 0}


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
@pytest.mark.parametrize("dtype,B,H,S,dk,dv,state,norm,d_state,broadcast_q,variant", [
    (torch.float32, 2, 4, 45, 32, 32, True, True, True, False, "simt"),  # REDUCED xlstm, ragged S
    (torch.float32, 2, 4, 64, 16, 32, False, False, False, True, "simt"),  # REDUCED Mamba2
    (torch.bfloat16, 2, 4, 130, 64, 64, True, True, True, False, "simt"),
    (torch.bfloat16, 1, 8, 200, 64, 96, False, False, True, True, "simt"),
    (torch.bfloat16, 2, 4, 130, 64, 64, True, True, True, False, "mma"),
    (torch.bfloat16, 1, 8, 200, 64, 96, False, False, True, True, "mma"),
    (torch.bfloat16, 2, 4, 45, 32, 32, True, True, True, False, "mma"),  # 3 tiles of 16
    (torch.bfloat16, 1, 2, 33, 384, 384, True, True, True, False, "mma"),  # xlstm widths, 7 x 64
    (torch.bfloat16, 2, 4, 45, 64, 224, True, False, True, True, "mma"),  # Mamba2 widths
    (torch.bfloat16, 1, 2, 40, 128, 40, False, False, False, False, "mma"),  # 8 warps of 16 rows
])
def test_backward_kernel_matches_plain_on_card(cuda, dtype, B, H, S, dk, dv, state, norm,
                                              d_state, broadcast_q, variant):
    args, kw = _card_case(cuda, dtype, B, H, S, dk, dv, state=state, norm=norm,
                          d_state=d_state, broadcast_q=broadcast_q)
    if variant == "mma":
        assert tscan.backward_variant(*args[:3], normaliser=norm) == "mma"
    before = dict(tscan.backward.variant_launches)
    got = tscan.gated_linear_scan_backward(*args, variant=variant, **kw)
    import math
    want = tref.gated_linear_scan_backward(*args, chunk=math.gcd(S, 16), **kw)
    torch.cuda.synchronize()
    assert tscan.backward.variant_launches[variant] == before[variant] + 1
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
@pytest.mark.parametrize("variant,dk,dv", [("simt", 64, 64), ("mma", 64, 64), ("mma", 384, 384)])
def test_backward_kernel_gives_the_same_bits_every_run_on_card(cuda, variant, dk, dv):
    args, kw = _card_case(cuda, torch.bfloat16, 2, 4, 100, dk, dv, state=True, norm=True,
                          d_state=True)
    first = tscan.gated_linear_scan_backward(*args, variant=variant, **kw)
    second = tscan.gated_linear_scan_backward(*args, variant=variant, **kw)
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
