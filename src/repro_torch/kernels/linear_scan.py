"""Wrapper of the hand-written CUDA chunkwise gated linear scan
(`csrc/linear_scan.cu`).

Replaces the reference's Pallas TPU kernel
`repro/kernels/linear_scan.py::gated_linear_scan`:

    S_t = a_t * S_{t-1} + k_t^T v_t ;  y_t = q_t @ S_t ;  a_t = exp(log_a_t)

with the decay in log space (cumulated in fp64 inside a chunk) and the
(dk, dv) state accumulated in fp32. Any S runs; `chunk` is the reference's
tiling knob and does not change the result
(`tests/test_kernels.py::test_chunk_size_invariance`), so the kernels accept
and ignore it.

Carried state: an optional fp32 `initial_state` replaces the zeros, as the
reference's ``ops.gated_linear_scan(..., initial_state=s0)`` computes (its
Pallas wrapper routes that case to the jnp oracle); the xlstm serving path
prefills from zero states and decodes one position at a time through it.

The mLSTM's normaliser: ``normaliser=True`` also returns what the reference's
second call with v = ones computes (`repro/models/ssm.py:97`), nrm
(B, H, S, 1) and its state n (B, H, dk, 1), from `initial_normaliser`, in the
same launch: the kernels treat it as one more column of v.

Three kernels, by an explicit rule (`variant`), counted in
`variant_launches`:

* ``step``: S <= `STEP_MAX_S` (a decode tick), any dtype: the state read
  and written once with 16-byte loads, positions walked in fp32.
* ``mma``: bf16 with S > `STEP_MAX_S`, dk <= `MMA_MAX_DK`, dk and dv
  multiples of 8 and 16-byte aligned rows (`mma_layout_error`): the chunk
  products on the tensor cores (mma.sync, bf16 hi + lo halves wherever an
  operand is not exact in bf16), the state in registers, the next chunk
  copied in by cp.async while one computes. A block owns `tile_columns`
  state columns, picked from the card's SM count.
* ``simt``: the rest (fp32, whose 2e-5 parity is kept by exact FMA): the
  chunk kernel on CUDA cores.

The wrapper checks device, dtype and shape, passes q, k, v and log_a by
their strides (head-split views of a projection need no copy), allocates
the outputs with `torch.empty`, launches on the current stream without
synchronising, and counts its launches.

The gradient, `gated_linear_scan_backward` (`csrc/linear_scan_bwd.cu`),
stands for the gradient of that Pallas kernel, which has no VJP (the
reference trains through `jax.vjp` of its jnp oracle): dq, dk, dv, dlog_a
and the initial states' gradients from the forward's inputs and the
gradients of y, the final state and, with the normaliser, of nrm and n
(any of them None: zeros). It recomputes the forward states itself, so
nothing but the inputs is saved. `GatedLinearScanFn` wires it into
autograd; `kernels/ops.py::gated_linear_scan` takes that Function on CUDA
whenever grad mode is on and an input requires grad; called directly under
grad mode with such an input, `gated_linear_scan` raises rather than return
an output that autograd would silently cut off. Two variants, by an explicit
rule (`backward_variant`), each call counted once in `backward.launches`
and `backward.variant_launches`:

* ``mma``: bf16 operands that `mma_layout_error` accepts (dk <= 384, dk and
  dv multiples of 8, 16-byte rows; Mamba2's stride-0 q included) and at most
  `BWD_MMA_MAX_TILES` column tiles: the chunkwise gradient on the tensor
  cores. A block owns `backward_tile_columns` extended state columns and
  all of dk; the tiles of one (b, h) form a thread-block cluster that adds
  their dq and dk partials through distributed shared memory, so no partial
  reaches device memory. Two launches a call (the walks, then the fp64
  reverse sum of dlog_a).
* ``simt``: the rest (fp32, whose 1e-4 parity rests on exact FMA): the
  per-position walks on CUDA cores, their column tiles' partials summed by
  a second kernel. Three launches a call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

MAX_DK = 1024
MMA_MAX_DK = 384  # the tensor-core kernel keeps dk x 64 fp32 of the state in registers
STEP_MAX_S = 16  # the step kernel's positions
MMA_TILES = (16, 32, 64)  # state columns a block of the tensor-core kernel owns
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VARIANT_CODES = {"simt": 0, "mma": 1, "step": 2}
BWD_TILE = 32  # extended state columns a block of the backward's simt walk owns
BWD_MMA_TILES = (16, 32, 64)  # extended state columns a block of the backward's mma kernel owns
BWD_MMA_MAX_TILES = 8  # column tiles of one (b, h): one cluster of at most 8 blocks
BWD_VARIANT_CODES = {"simt": 0, "mma": 1}

#: Kernel launches made by this process (one per call of `gated_linear_scan`).
launches = 0
#: The same launches by variant.
variant_launches = {kind: 0 for kind in VARIANT_CODES}
#: Calls of `gated_linear_scan_backward` (two or three launches a call,
#: counted once), and the same calls by variant.
backward = build.LaunchCounter(tuple(BWD_VARIANT_CODES))


@functools.cache
def _entry():
    fn = build.load().gated_linear_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 15
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def mma_layout_error(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Optional[str]:
    """Why the tensor-core kernel's 16-byte row copies cannot take q, k, v
    (bf16 views of (B, H, S, d)), or None."""
    dk, dv = q.shape[-1], v.shape[-1]
    if dk > MMA_MAX_DK:
        return f"dk {dk} > {MMA_MAX_DK}"
    if dk % 8 or dv % 8:
        return f"dk {dk} or dv {dv} not a multiple of 8"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            return f"{name} rows are not 16-byte strided"
        if t.data_ptr() % 16:
            return f"{name} is not 16-byte aligned"
    return None


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel `gated_linear_scan` launches for these operands (see the
    module note): a rule on S, dtype and layout."""
    if q.shape[2] <= STEP_MAX_S:
        return "step"
    if q.dtype == torch.bfloat16 and mma_layout_error(q, k, v) is None:
        return "mma"
    return "simt"


def tile_columns(B: int, H: int, columns: int, sms: int) -> int:
    """State columns a block of the tensor-core kernel owns for `columns`
    extended columns (dv, plus one for the normaliser) on `sms`
    multiprocessors: the narrowest tile whose grid still fits one wave (a
    narrower tile gives each block less of the state to carry through the
    chunks), and the widest when none does (the fewest blocks)."""
    for tile in MMA_TILES:
        if B * H * -(-columns // tile) <= sms:
            return tile
    return MMA_TILES[-1]


def mma_smem_bytes(tile: int, dk: int) -> int:
    """Dynamic shared memory a block of the tensor-core kernel asks for with
    `tile` state columns at this dk, from the built library."""
    fn = build.load().gated_linear_scan_mma_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(tile, dk)


def gated_linear_scan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_a: torch.Tensor,
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
    normaliser: bool = False,
    initial_normaliser: Optional[torch.Tensor] = None,
):
    """q, k: (B, H, S, dk); v: (B, H, S, dv) (fp32 or bf16, one dtype);
    log_a: (B, H, S) fp32; initial_state: None or contiguous fp32
    (B, H, dk, dv). Returns (y (B, H, S, dv) in q's dtype, final state
    (B, H, dk, dv) fp32), on CUDA. With ``normaliser=True`` (and an optional
    contiguous fp32 `initial_normaliser` (B, H, dk, 1)) also the scan of
    v = ones: (y, state, nrm (B, H, S, 1) in q's dtype, n (B, H, dk, 1) fp32)."""
    build.refuse_grad("gated_linear_scan", q, k, v, log_a, initial_state, initial_normaliser,
                      remedy="its output would carry no gradient: call ops.gated_linear_scan "
                             "(GatedLinearScanFn), whose gradient is the backward kernel")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or log_a.dim() != 3:
        raise ValueError("gated_linear_scan: q, k, v must be (B, H, S, d), log_a (B, H, S)")
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if k.shape != q.shape or v.shape[:3] != (B, H, S) or log_a.shape != (B, H, S):
        raise ValueError(f"gated_linear_scan: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} log_a{tuple(log_a.shape)}")
    if min(B, H, S, dv) < 1 or not 1 <= dk <= MAX_DK:
        raise ValueError(f"gated_linear_scan: need B, H, S, dv >= 1 and 1 <= dk <= {MAX_DK}")
    if chunk < 1:
        raise ValueError(f"gated_linear_scan: chunk {chunk} < 1")
    if initial_normaliser is not None and not normaliser:
        raise ValueError("gated_linear_scan: initial_normaliser needs normaliser=True")
    tensors = [("q", q), ("k", k), ("v", v), ("log_a", log_a)]
    states = [("initial_state", initial_state, (B, H, dk, dv)),
              ("initial_normaliser", initial_normaliser, (B, H, dk, 1))]
    tensors += [(name, t) for name, t, _ in states if t is not None]
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"gated_linear_scan: {name} must be on q's CUDA device, "
                             f"got {t.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"gated_linear_scan: {name} dtype {t.dtype} != q's {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"gated_linear_scan: dtype {q.dtype}; need fp32 or bf16")
    if log_a.dtype != torch.float32:
        raise ValueError(f"gated_linear_scan: log_a dtype {log_a.dtype}; need fp32")
    for name, t, shape in states:
        if t is None:
            continue
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"gated_linear_scan: {name} must be fp32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"gated_linear_scan: {name} must be contiguous")
    kind = variant(q, k, v)
    tile = (tile_columns(B, H, dv + int(normaliser), build.sm_count(q.device))
            if kind == "mma" else 0)
    dev = q.device
    y = torch.empty((B, H, S, dv), dtype=q.dtype, device=dev)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=dev)
    nrm = torch.empty((B, H, S, 1), dtype=q.dtype, device=dev) if normaliser else None
    n = torch.empty((B, H, dk, 1), dtype=torch.float32, device=dev) if normaliser else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(), ptr(initial_state),
        ptr(initial_normaliser), y.data_ptr(), state.data_ptr(), ptr(nrm), ptr(n),
        B, H, S, dk, dv, *q.stride(), *k.stride(), *v.stride(), *log_a.stride(),
        _DTYPE_CODES[q.dtype], VARIANT_CODES[kind], tile,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, f"gated_linear_scan ({kind})")
    build.count_launch(__name__, kind)
    return (y, state, nrm, n) if normaliser else (y, state)


@functools.cache
def _backward_entry():
    fn = build.load().gated_linear_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 22
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def backward_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     normaliser: bool = False) -> str:
    """The kernel `gated_linear_scan_backward` launches for these operands
    (see the module note): ``mma`` for bf16 that `mma_layout_error` accepts
    with at most `BWD_MMA_MAX_TILES` tiles of the widest column tile, else
    ``simt``."""
    columns = v.shape[-1] + int(normaliser)
    if (q.dtype == torch.bfloat16 and mma_layout_error(q, k, v) is None
            and columns <= BWD_MMA_MAX_TILES * BWD_MMA_TILES[-1]):
        return "mma"
    return "simt"


def backward_tile_columns(B: int, H: int, columns: int, sms: int) -> int:
    """Extended state columns a block of the backward's mma kernel owns: as
    `tile_columns`, the narrowest tile whose grid fits one wave of `sms`
    multiprocessors, among those that cut `columns` into at most
    `BWD_MMA_MAX_TILES` tiles (one cluster), else the widest."""
    for tile in BWD_MMA_TILES:
        tiles = -(-columns // tile)
        if tiles <= BWD_MMA_MAX_TILES and B * H * tiles <= sms:
            return tile
    return BWD_MMA_TILES[-1]


def backward_mma_smem_bytes(tile: int, dk: int) -> int:
    """Dynamic shared memory a block of the backward's mma kernel asks for
    with `tile` extended columns at this dk, from the built library."""
    fn = build.load().gated_linear_scan_bwd_mma_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(tile, dk)


def backward_mma_max_clusters(tile: int, dk: int, columns: int) -> int:
    """Clusters of the backward's mma kernel (one walk of one (b, h), a block
    per `tile` of the `columns` extended columns) the card holds at once,
    from the built library (-1 if the query fails)."""
    fn = build.load().gated_linear_scan_bwd_mma_max_clusters
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(tile, dk, columns)


def backward_scratch_elements(B: int, H: int, S: int, dk: int, dv: int, normaliser: bool, *,
                              variant: str = "simt", tile: int = BWD_TILE) -> int:
    """fp32 scratch of `gated_linear_scan_backward`, as the C entry point
    requires. ``simt``: every 32-column tile's dq and dk partials (tiles, B,
    H, S, dk), the tiles' final-state dots (tiles, B, H) and dA (B, H, S).
    ``mma`` (`tile` columns a block): each tile's share of the two halves
    of dA, q . dq and k . dk (tiles, B, H, S) each, and the tiles'
    final-state dots; the dq and dk partials stay in the cluster's shared
    memory."""
    columns = dv + int(normaliser)
    if variant == "mma":
        tiles = -(-columns // tile)
        return 2 * tiles * B * H * S + tiles * B * H
    tiles = -(-columns // BWD_TILE)
    return 2 * tiles * B * H * S * dk + tiles * B * H + B * H * S


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """t itself when its rows are whole 16-byte copies (unit last stride,
    the others multiples of 8 elements, 16-byte aligned), else a dense copy."""
    if t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:-1]) and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def gated_linear_scan_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_a: torch.Tensor,
    dy: Optional[torch.Tensor],
    d_state: Optional[torch.Tensor],
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
    normaliser: bool = False,
    initial_normaliser: Optional[torch.Tensor] = None,
    dnrm: Optional[torch.Tensor] = None,
    dn: Optional[torch.Tensor] = None,
    variant: Optional[str] = None,
):
    """The gradient of `gated_linear_scan` called on the same q, k, v,
    log_a and initial states: dy (B, H, S, dv) in q's dtype, any strides,
    and d_state contiguous fp32 (B, H, dk, dv), the gradients of y and of
    the final state; with ``normaliser=True`` also dnrm (B, H, S, 1) and dn
    contiguous fp32 (B, H, dk, 1); any of them None (zeros). Returns (dq,
    dk (B, H, S, dk) and dv in q's dtype, dlog_a (B, H, S) fp32, d(initial
    state) fp32 or None, d(initial normaliser) fp32 or None: where they were
    given), on CUDA. `chunk` shapes the plain version only. `variant` (None:
    `backward_variant`'s) names the kernel, so that both can be timed on the
    same operands; one these operands cannot take raises."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or log_a.dim() != 3:
        raise ValueError("gated_linear_scan_backward: q, k, v must be (B, H, S, d), "
                         "log_a (B, H, S)")
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if k.shape != q.shape or v.shape[:3] != (B, H, S) or log_a.shape != (B, H, S):
        raise ValueError(f"gated_linear_scan_backward: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} log_a{tuple(log_a.shape)}")
    if min(B, H, S, dv) < 1 or not 1 <= dk <= MAX_DK:
        raise ValueError(f"gated_linear_scan_backward: need B, H, S, dv >= 1 and "
                         f"1 <= dk <= {MAX_DK}")
    if not normaliser and (initial_normaliser is not None or dnrm is not None or dn is not None):
        raise ValueError("gated_linear_scan_backward: initial_normaliser, dnrm and dn need "
                         "normaliser=True")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"gated_linear_scan_backward: dtype {q.dtype}; need fp32 or bf16")
    if log_a.dtype != torch.float32:
        raise ValueError(f"gated_linear_scan_backward: log_a dtype {log_a.dtype}; need fp32")
    kind = backward_variant(q, k, v, normaliser=normaliser)
    if variant is not None and variant != kind:
        if variant not in BWD_VARIANT_CODES:
            raise ValueError(f"gated_linear_scan_backward: variant {variant!r}; need one of "
                             f"{tuple(BWD_VARIANT_CODES)}")
        if variant == "mma":
            raise ValueError(f"gated_linear_scan_backward: the mma variant cannot take these "
                             f"operands ({q.dtype}, "
                             f"{mma_layout_error(q, k, v) or 'too many column tiles'})")
        kind = variant
    grads = [("dy", dy, (B, H, S, dv)), ("dnrm", dnrm, (B, H, S, 1))]
    states = [("initial_state", initial_state, (B, H, dk, dv)),
              ("initial_normaliser", initial_normaliser, (B, H, dk, 1)),
              ("d_state", d_state, (B, H, dk, dv)), ("dn", dn, (B, H, dk, 1))]
    for name, t in [("q", q), ("k", k), ("v", v), ("log_a", log_a)] + [
            (name, t) for name, t, _ in grads + states if t is not None]:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"gated_linear_scan_backward: {name} must be on q's CUDA device, "
                             f"got {t.device}")
    for name, t in [("k", k), ("v", v)] + [(name, t) for name, t, _ in grads if t is not None]:
        if t.dtype != q.dtype:
            raise ValueError(f"gated_linear_scan_backward: {name} dtype {t.dtype} != q's "
                             f"{q.dtype}")
    for name, t, shape in grads:
        if t is not None and t.shape != shape:
            raise ValueError(f"gated_linear_scan_backward: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t, shape in states:
        if t is None:
            continue
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"gated_linear_scan_backward: {name} must be fp32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"gated_linear_scan_backward: {name} must be contiguous")
    tile = (backward_tile_columns(B, H, dv + int(normaliser), build.sm_count(q.device))
            if kind == "mma" else BWD_TILE)
    if kind == "mma" and dy is not None:
        dy = _rows16(dy)
    dev = q.device
    dq = torch.empty((B, H, S, dk), dtype=q.dtype, device=dev)
    dk_ = torch.empty((B, H, S, dk), dtype=q.dtype, device=dev)
    dv_ = torch.empty((B, H, S, dv), dtype=q.dtype, device=dev)
    dla = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    d_init = (torch.empty((B, H, dk, dv), dtype=torch.float32, device=dev)
              if initial_state is not None else None)
    d_init_n = (torch.empty((B, H, dk, 1), dtype=torch.float32, device=dev)
                if initial_normaliser is not None else None)
    scratch = torch.empty(backward_scratch_elements(B, H, S, dk, dv, normaliser, variant=kind,
                                                    tile=tile),
                          dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    def strides(t, n):
        return t.stride()[:n] if t is not None else (0,) * n

    err = _backward_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(), ptr(initial_state),
        ptr(initial_normaliser), ptr(dy), ptr(d_state), ptr(dnrm), ptr(dn), dq.data_ptr(),
        dk_.data_ptr(), dv_.data_ptr(), dla.data_ptr(), ptr(d_init), ptr(d_init_n),
        scratch.data_ptr(), B, H, S, dk, dv, int(bool(normaliser)), *q.stride(), *k.stride(),
        *v.stride(), *log_a.stride(), *strides(dy, 4), *strides(dnrm, 3),
        _DTYPE_CODES[q.dtype], BWD_VARIANT_CODES[kind], tile,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, f"gated_linear_scan_backward ({kind})")
    build.count_launch(backward, kind)
    return dq, dk_, dv_, dla, d_init, d_init_n


class GatedLinearScanFn(torch.autograd.Function):
    """The scan with a gradient: ``forward(q, k, v, log_a, initial_state,
    initial_normaliser, fwd, bwd, kw)`` runs ``fwd(q, k, v, log_a,
    initial_state=, initial_normaliser=, **kw)`` (kw: ``chunk``,
    ``normaliser``) and saves its inputs; the backward runs ``bwd(q, k, v,
    log_a, dy, d_state, initial_state=, initial_normaliser=, dnrm=, dn=,
    **kw)`` with the outputs' gradients as autograd gives
    them (None for an output that reached no loss). On the card `fwd` and
    `bwd` are `gated_linear_scan` and `gated_linear_scan_backward`
    (`kernels/ops.py::gated_linear_scan`); a CPU test passes the plain
    versions. dq comes back dense (B, H, S, dk) whatever q's strides: for
    Mamba2's q, broadcast over the heads, autograd sums it back."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, initial_state, initial_normaliser, fwd, bwd, kw):
        outs = fwd(q, k, v, log_a, initial_state=initial_state,
                   initial_normaliser=initial_normaliser, **kw)
        ctx.save_for_backward(q, k, v, log_a, initial_state, initial_normaliser)
        ctx.bwd, ctx.kw = bwd, kw
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    def backward(ctx, dy, d_state, dnrm=None, dn=None):
        q, k, v, log_a, s0, n0 = ctx.saved_tensors

        def dense(t):
            return t.contiguous() if t is not None else None

        if ctx.kw.get("normaliser"):
            extra = dict(dnrm=dnrm, dn=dense(dn), initial_normaliser=n0)
        else:
            extra = {}
        dq, dk, dv, dla, ds0, dn0 = ctx.bwd(q, k, v, log_a, dy, dense(d_state),
                                            initial_state=s0, **extra, **ctx.kw)
        return dq, dk, dv, dla, ds0, dn0, None, None, None
