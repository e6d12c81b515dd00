"""Wrappers of the hand-written CUDA flash-attention kernels: the forward
(`csrc/flash_attention.cu`) and its gradient (`csrc/flash_attention_bwd.cu`).

The forward replaces the reference's Pallas TPU kernel
`repro/kernels/flash_attention.py::flash_attention`. The source holds two
variants, and `variant` picks one by an explicit rule (nothing is caught and
retried):

* ``wgmma``: bf16, head_dim 64 / 80 / 112 / 128 / 160 / 256, at most 64
  query heads per KV head, q, k, v 16-byte aligned: both products on the
  tensor cores, K/V tiles delivered by TMA; the query heads that share a KV
  head share each K/V tile. A consumer warpgroup's 64 rows hold 64 // G
  whole positions (48 rows for granite-20b's 48 heads a group, 60 for
  grok-1's 6; the rest are zero padding), and head dims that are not a
  multiple of 64 are padded to one in shared memory (80 and 112 to 128, 160
  to 192). Every bf16 prefill of the full-width configs takes it.
  `consumer_warpgroups` picks one or two consumer warpgroups a block by the
  grid's size.
* ``simt``: everything else (fp32, whose 2e-5 parity TF32 would break, such
  as `examples/train_100m_torch.py` at hd 80; head dims 16 and 32 of the
  REDUCED configs; more than 64 query heads per KV head): scalar fp32 FMA,
  32 query rows a block.

Head dims outside `SUPPORTED_HEAD_DIMS` raise: each is an instantiation of
the CUDA templates, and the build instantiates only these.

Both mask ragged Sq / Skv themselves, so any prompt length runs without
padding (the Pallas wrapper needs block multiples), and visit only the key
tiles a block's rows can attend to. See the source for the block layouts.
With ``return_lse=True`` either variant also writes each query row's
log-sum-exp (fp32, (B, H, Sq)), the backward's input.

The gradient, `flash_attention_backward`, stands for the gradient of that
Pallas kernel, which has no VJP (the reference trains through its oracle,
whose gradient this reproduces). `FlashAttentionFn` wires it into autograd;
`kernels/ops.py::attention` takes that Function on CUDA whenever grad mode
is on and an input requires grad; called directly under grad mode with such
an input, `flash_attention` raises rather than return an output that
autograd would silently cut off. `backward_variant` picks its variant by
the forward's rule:

* ``wgmma``: every product on the tensor cores (S and dP by `wgmma` from
  TMA-fed shared memory, dV, dK and dQ with P or dS as the bf16 A operand in
  registers), at the forward's head dims and group sizes; at gemma3-1b's
  training shape its bound is the tensor cores' rate, and it runs at about
  5x that bound (PERF.md, section 6). The dK/dV walk of one key tile over
  its query tiles may be split over several blocks (`backward_plan`, from
  the mask geometry and the card's SM count) whose fp32 partials a second
  pass adds in a fixed order; the wrapper allocates that scratch and the
  row stats' (`backward_scratch`).
* ``simt``: scalar fp32 FMA, tiles of 32 (fp32, which must stay exact for
  the REDUCED parity and the resume test; hd 16 and 32; more than 64 query
  heads per KV head).

Both are deterministic (no atomics) and both take rows with no key (the
reference's uniform average, no gradient to q or k).

The wrappers check device, dtype, shape and contiguity, allocate outputs
and scratch with `torch.empty`, launch on the current stream without
synchronising, and count their launches: the forward in `launches` and, by
variant, in `variant_launches`; the backward (one count a call, for its
three or four launches) in `backward.launches` and, by variant, in
`backward.variant_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

#: head dims of the repo's configs and examples: 16 and 32 (REDUCED), 80
#: (`examples/train_100m_torch.py`), 112 (zamba2-7b, kimi-k2), 160 (stablelm-12b),
#: 64, 128, 256
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 112, 128, 160, 256)
#: head dims the tensor-core variants take: tiles of whole 64-column boxes
WGMMA_HEAD_DIMS = (64, 80, 112, 128, 160, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"simt": 0, "wgmma": 1}
#: (position, query head) rows of one consumer warpgroup of the wgmma variant.
WGMMA_ROWS = 64

#: Kernel launches made by this process (one per call of `flash_attention`).
launches = 0
#: The same launches by variant.
variant_launches = {name: 0 for name in _VARIANT_CODES}
#: Calls of `flash_attention_backward`, and the same calls by variant.
backward = build.LaunchCounter(tuple(_VARIANT_CODES))
#: Keys of a dK/dV block's tile in the backward's wgmma variant.
WGMMA_KEYS = 64
#: A dK/dV block's fixed cost in query-tile visits: its K / V load, its
#: partial's fp32 write and the second pass's read of it.
SPLIT_OVERHEAD = 2


@functools.cache
def _entry():
    fn = build.load().flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_entry():
    fn = build.load().flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float] + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _tensor_core_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    hd, groups = q.shape[3], q.shape[2] // k.shape[2]
    return (q.dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS and groups <= WGMMA_ROWS
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel variant `flash_attention` launches for these operands (see
    the module note); a rule on dtype, head_dim, group size and alignment
    only."""
    return "wgmma" if _tensor_core_operands(q, k, v) else "simt"


def backward_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The variant `flash_attention_backward` launches for these operands:
    ``wgmma`` for bf16 at head_dim 64 / 80 / 112 / 128 / 160 / 256 with at
    most 64 query heads per KV head and q, k, v 16-byte aligned, ``simt``
    otherwise (fp32, hd 16 and 32, and groups over 64, among them). A rule
    on dtype, head_dim, group size and alignment only: both variants take
    every mask, rows with no key included."""
    return "wgmma" if _tensor_core_operands(q, k, v) else "simt"


def _query_tiles_seen(Sq: int, Skv: int, P: int, causal: bool, window: int, prefix_len: int,
                      q_offset: int) -> list:
    """For each key tile of `WGMMA_KEYS`, the query tiles [lo, hi) of P
    positions whose rows can see one of its keys: the host's copy of the
    kernel's `query_tiles` (which decides on the card), used to size the
    split."""
    has_empty_rows = window > 0 and q_offset + Sq - 1 >= Skv + window - 1
    ranges = []
    for k0 in range(0, Skv, WGMMA_KEYS):
        khi = min(k0 + WGMMA_KEYS - 1, Skv - 1)
        pos_lo = max(0, k0 - q_offset) if causal and not (0 < prefix_len and k0 < prefix_len) \
            else 0
        pos_hi = min(Sq, khi + window - q_offset) if window > 0 and not has_empty_rows else Sq
        lo = pos_lo // P
        ranges.append((lo, -(-pos_hi // P) if pos_hi > pos_lo else lo))
    return ranges


@functools.lru_cache(maxsize=256)
def _plan(B: int, Sq: int, Skv: int, KV: int, G: int, causal: bool, window: int,
          prefix_len: int, q_offset: int, sms: int):
    n_qt = -(-Sq // (WGMMA_ROWS // G))
    walks = [hi - lo for lo, hi in _query_tiles_seen(Sq, Skv, WGMMA_ROWS // G, causal, window,
                                                     prefix_len, q_offset)]
    longest = max(walks)
    if len(walks) * KV * B >= sms or longest <= 1:
        return n_qt, 1
    best_cost, chunk = None, longest
    for c in range(1, longest + 1):  # ties go to the larger chunk: fewer partials
        blocks = KV * B * sum(max(1, -(-n // c)) for n in walks)
        cost = -(-blocks // sms) * (c + SPLIT_OVERHEAD)
        if best_cost is None or cost <= best_cost:
            best_cost, chunk = cost, c
    if chunk >= longest:
        return n_qt, 1
    return chunk, -(-n_qt // chunk)


def backward_plan(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True, window: int = 0,
                  prefix_len: int = 0, q_offset: int = 0):
    """(chunk, splits) of the wgmma backward's dK/dV launch: a block walks at
    most `chunk` query tiles (64 packed rows each) of its key tile, and the
    grid has `splits` blocks a key tile (those past a walk's end exit). A key
    tile's walk is split only when the unsplit grid (key tiles x KV heads x
    batch) fills less than one wave of q's card's SMs, with the chunk that
    minimises waves x (chunk + `SPLIT_OVERHEAD`), the makespan in tile
    visits at one block an SM (ties to the larger chunk); otherwise (n_qt,
    1), no split."""
    B, Sq, H, _ = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    return _plan(B, Sq, Skv, KV, H // KV, bool(causal), int(window or 0), int(prefix_len),
                 int(q_offset), build.sm_count(q.device))


def backward_scratch(q: torch.Tensor, k: torch.Tensor, chunk: int, splits: int):
    """fp32 scratch of the wgmma backward, on q's device: (the row stats:
    each query tile's 64 lse and 64 D, padding rows included when the group
    does not divide 64, B * KV * n_qt * 128 floats; the
    partial dK / dV of split walks, (splits, B * KV, key tiles * 64, 2, hd),
    or None when no walk is split), as the C entry point requires."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    n_qt = -(-Sq // (WGMMA_ROWS // (H // KV)))
    if chunk < 1 or splits < 1 or splits * chunk < n_qt:
        raise ValueError(f"flash_attention_backward: chunk {chunk} x splits {splits} does not "
                         f"cover {n_qt} query tiles")
    stat = torch.empty(B * KV * n_qt * 2 * WGMMA_ROWS, dtype=torch.float32, device=q.device)
    partial = None
    if splits > 1:
        n_keys = -(-Skv // WGMMA_KEYS) * WGMMA_KEYS
        partial = torch.empty((splits, B * KV, n_keys, 2, hd), dtype=torch.float32,
                              device=q.device)
    return stat, partial


def consumer_warpgroups(q: torch.Tensor, k: torch.Tensor) -> int:
    """Consumer warpgroups a block of the wgmma variant: one when the grid of
    one-warpgroup blocks fits in one wave of q's card's multiprocessors
    (a single prompt: the chain of key tiles of the last rows sets the time,
    and a warpgroup with an SM's tensor cores to itself walks it faster), two
    otherwise (one warpgroup's softmax overlaps the other's products)."""
    B, Sq, H, _ = q.shape
    KV = k.shape[2]
    positions = WGMMA_ROWS // (H // KV)  # query positions a warpgroup holds
    blocks = -(-Sq // positions) * KV * B
    return 1 if blocks <= build.sm_count(q.device) else 2


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *extra) -> None:
    """The operands' shapes, device, dtype and layout; `extra` are (name,
    tensor) pairs that must match q's device, dtype and shape."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q, k, v must be 4-D (B, S, heads, head_dim)")
    B, Sq, H, hd = q.shape
    Bk, Skv, KV, hdk = k.shape
    if v.shape != k.shape or Bk != B or hdk != hd:
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"{what}: {H} query heads not a multiple of {KV} kv heads")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if Sq < 1 or Skv < 1:
        raise ValueError(f"{what}: empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)) + extra:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what}: {name} must be on q's CUDA device, got {t.device}")
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} dtype {t.dtype}; need one of fp32/bf16 for all")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)}, need q's {tuple(q.shape)}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    prefix_len: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd), on CUDA;
    with ``return_lse`` also each row's log-sum-exp, fp32 (B, H, Sq)."""
    build.refuse_grad("flash_attention", q, k, v, remedy=(
        "its output would carry no gradient: call ops.attention (FlashAttentionFn), whose "
        "gradient is the backward kernel"))
    _check("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (hd**0.5)
    kind = variant(q, k, v)
    consumers = consumer_warpgroups(q, k) if kind == "wgmma" else 0
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        B, Sq, Skv, H, KV, hd, _DTYPE_CODES[q.dtype], float(scale),
        int(bool(causal)), int(window or 0), int(prefix_len), int(q_offset),
        _VARIANT_CODES[kind], consumers, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, f"flash_attention ({kind})")
    build.count_launch(__name__, kind)
    return (out, lse) if return_lse else out


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    prefix_len: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
):
    """The gradient of `flash_attention` with the same masks and scale:
    q, out, d_out (B, Sq, H, hd); k, v (B, Skv, KV, hd); lse fp32 (B, H, Sq),
    the forward's. Returns (dq, dk, dv) in the inputs' dtype, on CUDA."""
    _check("flash_attention_backward", q, k, v, ("out", out), ("d_out", d_out))
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_backward: lse must be contiguous fp32 {(B, H, Sq)} "
                         f"on q's device, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if q_offset < 0:
        raise ValueError(f"flash_attention_backward: q_offset {q_offset} < 0")
    scale = scale if scale is not None else 1.0 / (hd**0.5)
    kind = backward_variant(q, k, v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if kind == "wgmma":
        for name, t in (("out", out), ("d_out", d_out)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention_backward: {name} must be 16-byte aligned "
                                 "for the wgmma variant")
        chunk, splits = backward_plan(q, k, causal=causal, window=window,
                                      prefix_len=prefix_len, q_offset=q_offset)
        delta, partial = backward_scratch(q, k, chunk, splits)
    else:
        chunk, splits, partial = 0, 0, None
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = _backward_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        B, Sq, Skv, H, KV, hd, _DTYPE_CODES[q.dtype], float(scale),
        int(bool(causal)), int(window or 0), int(prefix_len), int(q_offset),
        _VARIANT_CODES[kind], chunk, splits, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, f"flash_attention_backward ({kind})")
    build.count_launch(backward, kind)
    return dq, dk, dv


def flash_attention_with_lse(q, k, v, **kw):
    """`flash_attention(..., return_lse=True)`: (out, lse)."""
    return flash_attention(q, k, v, return_lse=True, **kw)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient: ``forward(q, k, v, fwd, bwd, kw)`` runs
    ``fwd(q, k, v, **kw) -> (out, lse)`` and saves q, k, v, out and lse; the
    backward runs ``bwd(q, k, v, out, lse, d_out, **kw) -> (dq, dk, dv)`` on
    a contiguous `d_out`. On the card `fwd` and `bwd` are
    `flash_attention_with_lse` and `flash_attention_backward`
    (`kernels/ops.py::attention`); a CPU test passes the plain versions,
    `ref.attention_with_lse` and `ref.attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, fwd, bwd, kw):
        out, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.bwd, ctx.kw = bwd, kw
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, out, lse, d_out.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None
