"""Plain PyTorch versions of the port's kernels: the semantics of record.

Each mirrors the reference's pure-jnp oracle of the same name
(`repro/kernels/ref.py`) line for line: `NEG_INF = -1e30` instead of -inf
(all-masked rows stay finite), softmax in fp32, inputs upcast to fp32. The
CPU path of every kernel wrapper is this code, and `chip_smoke.py` holds the
CUDA kernels against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: avoids NaN from all-masked rows


def _build_mask(
    q_len: int,
    kv_len: int,
    *,
    causal: bool,
    window: int,
    prefix_len: int,
    q_offset: int,
    device=None,
) -> torch.Tensor:
    """Boolean (q_len, kv_len) mask. True = attend.

    * causal: key_pos <= query_pos (query_pos = q_offset + i)
    * window > 0: additionally query_pos - key_pos < window
    * prefix_len > 0: positions < prefix_len attend bidirectionally within
      the prefix (prefix-LM)
    """
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask = k_pos <= q_pos
        if prefix_len > 0:
            mask = mask | ((q_pos < prefix_len) & (k_pos < prefix_len))
    if window is not None and window > 0:
        mask = mask & (q_pos - k_pos < window)
    return mask


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    prefix_len: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked multi-head attention with GQA.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0.
    Returns (B, Sq, H, hd) in q's dtype. Softmax in fp32.
    """
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if H % KV:
        raise ValueError(f"num heads {H} not a multiple of kv heads {KV}")
    groups = H // KV
    scale = scale if scale is not None else 1.0 / (hd**0.5)

    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    qg = qf.reshape(B, Sq, KV, groups, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kf)  # (B,KV,g,Sq,Skv)
    mask = _build_mask(
        Sq, Skv, causal=causal, window=window, prefix_len=prefix_len,
        q_offset=q_offset, device=q.device,
    )
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, vf)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _masked_decode(q, k_cache, v_cache, pos, *, window: int, scale: Optional[float]):
    """Single-token GQA decode: slot-validity masking (slot <= pos), plus an
    optional position-window mask (slot > pos - window)."""
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    groups = H // KV
    scale = scale if scale is not None else 1.0 / (hd**0.5)
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)

    qf = q.float().reshape(B, KV, groups, hd) * scale
    kf = k_cache.float()
    vf = v_cache.float()
    scores = torch.einsum("bkgd,bskd->bkgs", qf, kf)  # (B,KV,g,S)

    slot = torch.arange(S, device=q.device)[None, :]
    valid = slot <= pos[:, None]
    if window is not None and window > 0:
        valid = valid & (slot > pos[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, vf)
    return out.reshape(B, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0, scale: Optional[float] = None):
    """Single-token attention over a dense KV cache.

    q: (B, H, hd); k_cache, v_cache: (B, S, KV, hd); pos: scalar or (B,).
    Ring buffers are fully valid through the caller's `eff_pos` clamp, so
    validity is slots <= pos only. Returns (B, H, hd).
    """
    return _masked_decode(q, k_cache, v_cache, pos, window=0, scale=scale)


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    pos,
    *,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention over a paged (block-pool) KV cache.

    q: (B, H, hd); k_pool, v_pool: (P, page, KV, hd); page_table:
    (B, n_pages) int physical page per logical page; pos: scalar or (B,)
    last valid logical slot. `window` > 0 also masks logical slots older
    than ``pos - window``. Gathers each row's pages into a dense view and
    runs the dense decode body; padded null-page entries sit past `pos` and
    mask away. Returns (B, H, hd).
    """
    B = q.shape[0]
    _, page, KV, hd = k_pool.shape
    idx = page_table.long()
    k_eff = k_pool[idx].reshape(B, -1, KV, hd)
    v_eff = v_pool[idx].reshape(B, -1, KV, hd)
    return _masked_decode(q, k_eff, v_eff, pos, window=window, scale=scale)


def gated_linear_scan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_a: torch.Tensor,
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
):
    """Chunkwise gated linear recurrence (SSD / mLSTM matrix-memory core).

        S_t = a_t * S_{t-1} + k_t^T v_t          (state: (dk, dv))
        y_t = q_t @ S_t

    q, k: (B, H, S, dk); v: (B, H, S, dv); log_a: (B, H, S) per-step log
    decay (a_t = exp(log_a_t), log_a <= 0 for stability); initial_state:
    None (zeros) or (B, H, dk, dv). Returns (y (B, H, S, dv) in q's dtype,
    final state (B, H, dk, dv) fp32). As the reference, S must be a multiple
    of `chunk`; the decay is cumulated in log space in fp32 within a chunk and
    the state is carried across chunks in fp32.
    """
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if S % chunk:
        raise ValueError(f"seq {S} must be divisible by chunk {chunk}")
    C = S // chunk

    qf = q.float().reshape(B, H, C, chunk, dk)
    kf = k.float().reshape(B, H, C, chunk, dk)
    vf = v.float().reshape(B, H, C, chunk, dv)
    la = log_a.float().reshape(B, H, C, chunk)

    # within-chunk cumulative decay: A[i] = sum_{t<=i} log_a[t]
    A = torch.cumsum(la, dim=-1)  # (B,H,C,L)
    A_total = A[..., -1]  # (B,H,C)

    # intra-chunk: y_intra[i] = sum_{j<=i} exp(A_i - A_j) (q_i.k_j) v_j
    decay = A[..., :, None] - A[..., None, :]  # (B,H,C,L,L)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    gates = torch.where(tri, torch.exp(decay), torch.zeros((), device=q.device))
    scores = torch.einsum("bhcid,bhcjd->bhcij", qf, kf) * gates
    y_intra = torch.einsum("bhcij,bhcjv->bhciv", scores, vf)

    # per-chunk outer-product contribution to the carried state:
    #   S_chunk = sum_j exp(A_total - A_j) k_j^T v_j
    k_scaled = kf * torch.exp(A_total[..., None] - A)[..., None]
    chunk_states = torch.einsum("bhcjd,bhcjv->bhcdv", k_scaled, vf)  # (B,H,C,dk,dv)

    if initial_state is None:
        state = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    else:
        state = initial_state.float()
    prev = []  # the state each chunk starts from
    for c in range(C):
        prev.append(state)
        state = torch.exp(A_total[:, :, c])[..., None, None] * state + chunk_states[:, :, c]
    prev_states = torch.stack(prev, dim=2)  # (B,H,C,dk,dv)

    # inter-chunk: y_inter[i] = exp(A_i) q_i @ S_prev(chunk)
    q_scaled = qf * torch.exp(A)[..., None]
    y_inter = torch.einsum("bhcid,bhcdv->bhciv", q_scaled, prev_states)

    y = (y_intra + y_inter).reshape(B, H, S, dv)
    return y.to(q.dtype), state


def gated_linear_scan_normalised(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_a: torch.Tensor,
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
    initial_normaliser: Optional[torch.Tensor] = None,
):
    """The scan of v and, from the same q, k and log_a, of v = ones (the
    mLSTM's normaliser), as the reference's two calls (`repro/models/ssm.py`
    `mlstm_forward`). Returns (y, state, nrm (B, H, S, 1) in q's dtype,
    n (B, H, dk, 1) fp32); `initial_normaliser`: None (zeros) or
    (B, H, dk, 1)."""
    y, state = gated_linear_scan(q, k, v, log_a, chunk=chunk, initial_state=initial_state)
    ones = torch.ones((*q.shape[:3], 1), dtype=q.dtype, device=q.device)
    nrm, n = gated_linear_scan(q, k, ones, log_a, chunk=chunk, initial_state=initial_normaliser)
    return y, state, nrm, n


def gated_linear_step(q_t, k_t, v_t, log_a_t, state):
    """Single decode step of the gated linear recurrence.

    q_t, k_t: (B, H, dk); v_t: (B, H, dv); log_a_t: (B, H); state:
    (B, H, dk, dv). Returns (y_t (B, H, dv) in q_t's dtype, new state fp32).
    """
    a = torch.exp(log_a_t.float())[..., None, None]
    new_state = a * state.float() + torch.einsum("bhd,bhv->bhdv", k_t.float(), v_t.float())
    y = torch.einsum("bhd,bhdv->bhv", q_t.float(), new_state)
    return y.to(q_t.dtype), new_state
