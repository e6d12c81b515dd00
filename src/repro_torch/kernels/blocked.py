"""Blocked (flash-style) attention and the sequential-chunk scan in plain
PyTorch: the twins of the reference's `repro/kernels/blocked.py`, picked on
the CPU route by ``cfg.attention_impl == "blocked"`` and ``cfg.ssd_impl ==
"sequential"`` (`kernels/ops.py`). On the card the CUDA kernels keep this
work, as the reference's Pallas kernels win over its blocked path.

* global (causal/full) layers — a loop over q chunks, an inner loop over kv
  chunks with the online-softmax (m, l, acc) carry;
* sliding-window layers — band attention: for each q chunk, the (window +
  q_chunk) key band of a left-padded copy; work is O(S·window), not O(S²).

Never more than one (q_chunk × kv_chunk) score block is live per step. The
per-q-chunk body runs under `torch.utils.checkpoint` (the reference's
`jax.checkpoint`), so the backward recomputes score blocks instead of
keeping them. Numerics: fp32 softmax, the oracle's large-negative masking.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target."""
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def _maybe_checkpoint(fn, *args):
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                       for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def attention_blocked(q, k, v, *, causal: bool = True, window: int = 0, prefix_len: int = 0,
                      q_offset: int = 0, scale: Optional[float] = None, q_chunk: int = 512,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd). Returns (B, Sq, H, hd) in
    q's dtype. `window` is a Python int."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    groups = H // KV
    scale = scale if scale is not None else 1.0 / (hd**0.5)
    qc = _pick_chunk(Sq, q_chunk)

    qg = (q.float() * scale).reshape(B, Sq, KV, groups, hd).permute(0, 2, 3, 1, 4)  # (B,KV,g,Sq,hd)
    kf = k.float().transpose(1, 2)  # (B, KV, Skv, hd)
    vf = v.float().transpose(1, 2)

    if window and int(window) > 0 and causal and prefix_len == 0:
        out = _banded(qg, kf, vf, int(window), qc, q_offset)
    else:
        out = _global(qg, kf, vf, causal, prefix_len, q_offset, qc, kv_chunk)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _softmax_block(s, vblk, m_prev, l_prev, acc_prev):
    """One online-softmax update. s: (B, KV, g, qc, kc); vblk: (B, KV, kc, hd)."""
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(dim=-1, keepdim=True)
    acc_new = acc_prev * alpha + torch.einsum("bkgqc,bkcd->bkgqd", p, vblk)
    return m_new, l_new, acc_new


def _global(qg, kf, vf, causal, prefix_len, q_offset, qc, kv_chunk):
    B, KV, g, Sq, hd = qg.shape
    Skv = kf.shape[2]
    kc = _pick_chunk(Skv, kv_chunk)
    dev = qg.device

    def q_body(qi, q0, kf, vf):
        q_pos = q_offset + q0 + torch.arange(qc, device=dev)[:, None]  # (qc, 1)
        m = torch.full((B, KV, g, qc, 1), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, g, qc, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, g, qc, hd), dtype=torch.float32, device=dev)
        for k0 in range(0, Skv, kc):
            kblk, vblk = kf[:, :, k0:k0 + kc], vf[:, :, k0:k0 + kc]
            s = torch.einsum("bkgqd,bkcd->bkgqc", qi, kblk)
            k_pos = k0 + torch.arange(kc, device=dev)[None, :]  # (1, kc)
            if causal:
                mask = k_pos <= q_pos
                if prefix_len > 0:
                    mask = mask | ((q_pos < prefix_len) & (k_pos < prefix_len))
                s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
            m, l, acc = _softmax_block(s, vblk, m, l, acc)
        return acc / torch.clamp_min(l, 1e-30)

    outs = [_maybe_checkpoint(q_body, qg[:, :, :, q0:q0 + qc], q0, kf, vf)
            for q0 in range(0, Sq, qc)]
    return torch.cat(outs, dim=3)


def _banded(qg, kf, vf, window, qc, q_offset):
    """Sliding-window band attention: per q chunk, one key band of length
    window + qc of a left-padded copy; padded slots are masked by position
    validity."""
    B, KV, g, Sq, hd = qg.shape
    band = window + qc
    dev = qg.device
    kp = torch.nn.functional.pad(kf, (0, 0, window, 0))
    vp = torch.nn.functional.pad(vf, (0, 0, window, 0))

    def q_body(qi, q0, kp, vp):
        # keys [q0 - window, q0 + qc) in original coords = [q0, q0 + band) padded
        kblk = kp[:, :, q0:q0 + band]
        vblk = vp[:, :, q0:q0 + band]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qi, kblk)
        q_pos = q_offset + q0 + torch.arange(qc, device=dev)[:, None]
        k_pos = q_offset + q0 - window + torch.arange(band, device=dev)[None, :]
        orig = q0 - window + torch.arange(band, device=dev)[None, :]
        mask = (k_pos <= q_pos) & (q_pos - k_pos < window) & (orig >= 0)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bkgqc,bkcd->bkgqd", p, vblk)
        return acc / torch.clamp_min(l, 1e-30)

    outs = [_maybe_checkpoint(q_body, qg[:, :, :, q0:q0 + qc], q0, kp, vp)
            for q0 in range(0, Sq, qc)]
    return torch.cat(outs, dim=3)


def gated_linear_scan_sequential(q, k, v, log_a, *, chunk: int = 128, initial_state=None):
    """Sequential-chunk SSD/mLSTM recurrence: the math of
    `ref.gated_linear_scan`, one chunk at a time, so only ONE chunk's (L, L)
    gate matrix is live (the vectorised plain version materialises all C of
    them). The chunk body runs under `torch.utils.checkpoint`: the backward
    recomputes gates chunk by chunk.

    q, k: (B, H, S, dk); v: (B, H, S, dv); log_a: (B, H, S).
    Returns (y: (B, H, S, dv) in q's dtype, final_state: (B, H, dk, dv) fp32)."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    assert S % chunk == 0, (S, chunk)
    L = chunk
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))

    def body(state, qf, kf, vf, la):
        qf, kf, vf = qf.float(), kf.float(), vf.float()
        A = torch.cumsum(la.float(), dim=-1)  # (B, H, L)
        A_tot = A[..., -1]
        # intra-chunk
        decay_ij = A[..., :, None] - A[..., None, :]
        gates = torch.where(tri, torch.exp(decay_ij), torch.zeros((), device=q.device))
        scores = torch.einsum("bhid,bhjd->bhij", qf, kf) * gates
        y_intra = torch.einsum("bhij,bhjv->bhiv", scores, vf)
        # inter-chunk from the carried state
        y_inter = torch.einsum("bhid,bhdv->bhiv", qf * torch.exp(A)[..., None], state)
        # state update
        k_scaled = kf * torch.exp(A_tot[..., None] - A)[..., None]
        chunk_state = torch.einsum("bhjd,bhjv->bhdv", k_scaled, vf)
        new_state = torch.exp(A_tot)[..., None, None] * state + chunk_state
        return new_state, (y_intra + y_inter).to(q.dtype)

    state = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
             if initial_state is None else initial_state.float())
    ys = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        state, y = _maybe_checkpoint(body, state, q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                     log_a[:, :, sl])
        ys.append(y)
    return torch.cat(ys, dim=2), state
