"""Recurrent sequence-mixing blocks: xLSTM's mLSTM (matrix memory) and
sLSTM (scalar memory), and Mamba2 (SSD). Port of `repro/models/ssm.py`.

The mLSTM and Mamba2 cores are the scalar-gated linear recurrence

    S_t = a_t * S_{t-1} + k_t^T v_t ;  y_t = q_t @ S_t

served by `repro_torch.kernels.ops.gated_linear_scan` (the hand-written CUDA
kernel on the card, its plain version on the CPU). The reference calls it
twice per block, once for y and once for the normaliser with v = ones; here
one call with ``normaliser=True`` returns both (one kernel launch on the
card; on the CPU the plain version makes the reference's two calls).
Prefill and decode carry the block's states through the same call. The sLSTM
has cross-head recurrent connections and is sequential: the reference runs
it as a `lax.scan`, the port as a Python loop over positions.

Mamba2 maps onto one scan call a block: q = C broadcast over the heads (a
stride-0 view, no copy), k = B * dt, v = x and log_a = dt * A.

The reference's simplifications are kept (mLSTM: a sigmoid input gate folded
into k in place of the exponential gate and its stabiliser; sLSTM: a capped
exponential input gate; Mamba2: one group, B and C shared by the heads, no
extra normalisation branches).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops
from .common import ParamInit, rms_norm


def _chunk_for(S: int) -> int:
    """The reference's scan chunk for S positions: 128 halved until it
    divides S (the plain version needs ``S % chunk == 0``; the kernel takes
    any S and ignores it)."""
    c = min(128, S)
    while S % c:
        c //= 2
    return max(c, 1)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block)
# ---------------------------------------------------------------------------


def init_mlstm_block(pi: ParamInit, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    return {
        "norm": pi.zeros((d,), dtype=torch.float32),
        "w_qkv": pi.normal((d, 3 * di), fan_in=d),
        "w_gates": pi.normal((d, 2 * H), fan_in=d),
        "b_gates": pi.constant(1.0, (2 * H,)),
        "w_ogate": pi.normal((d, di), fan_in=d),
        "w_out": pi.normal((di, d), fan_in=di),
    }


def _mlstm_qkvg(cfg: ArchConfig, p, x: torch.Tensor):
    """x: (B,S,d) -> q, k, v (B,H,S,hd) head-split views of the projection
    (k scaled by 1/sqrt(hd) and the input gate) and log_a (B,H,S) fp32."""
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    hd = di // H
    cd = x.dtype
    qkv = x @ p["w_qkv"].to(cd)
    q, k, v = torch.split(qkv, di, dim=-1)
    q = q.reshape(B, S, H, hd).transpose(1, 2)  # (B,H,S,hd)
    k = k.reshape(B, S, H, hd).transpose(1, 2) / (hd**0.5)
    v = v.reshape(B, S, H, hd).transpose(1, 2)
    gates = x @ p["w_gates"].to(cd) + p["b_gates"].to(cd)
    f_logit, i_logit = torch.split(gates, H, dim=-1)  # (B,S,H) each
    log_a = F.logsigmoid(f_logit.float()).transpose(1, 2)  # (B,H,S)
    i_gate = torch.sigmoid(i_logit.float()).transpose(1, 2)  # (B,H,S)
    k = k * i_gate[..., None].to(cd)
    return q, k, v, log_a


def mlstm_forward(cfg: ArchConfig, p, x: torch.Tensor, state=None):
    """x: (B,S,d). Returns (x + out, new state {"S", "n"}); `state` None
    starts from zeros (the stateless forward)."""
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    cd = x.dtype
    h = rms_norm(x, p["norm"], eps=cfg.norm_eps)
    q, k, v, log_a = _mlstm_qkvg(cfg, p, h)
    chunk = _chunk_for(S)
    s0 = state["S"] if state is not None else None
    n0 = state["n"] if state is not None else None
    # y and the normaliser (the scan of v = ones) from one call
    y, S_f, nrm, n_f = ops.gated_linear_scan(q, k, v, log_a, chunk=chunk, initial_state=s0,
                                             normaliser=True, initial_normaliser=n0)
    y = y.float() / torch.clamp_min(torch.abs(nrm.float()), 1.0)
    y = y.to(cd).transpose(1, 2).reshape(B, S, di)
    ogate = F.silu(h @ p["w_ogate"].to(cd))
    out = (y * ogate) @ p["w_out"].to(cd)
    return x + out, {"S": S_f, "n": n_f}


def mlstm_init_state(cfg: ArchConfig, batch: int, *, device, dtype=torch.float32) -> dict:
    H = cfg.num_heads
    hd = cfg.ssm_expand * cfg.d_model // H
    return {
        "S": torch.zeros((batch, H, hd, hd), dtype=dtype, device=device),
        "n": torch.zeros((batch, H, hd, 1), dtype=dtype, device=device),
    }


def mlstm_decode_step(cfg: ArchConfig, p, x: torch.Tensor, state):
    """x: (B,1,d) -> (y (B,1,d), new state)."""
    return mlstm_forward(cfg, p, x, state=state)


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory block, sequential)
# ---------------------------------------------------------------------------


def init_slstm_block(pi: ParamInit, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "norm": pi.zeros((d,), dtype=torch.float32),
        "w_in": pi.normal((d, 4 * d), fan_in=d),
        "w_rec": pi.normal((d, 4 * d), fan_in=d, scale=0.5),
        "b": pi.zeros((4 * d,)),
        "w_out": pi.normal((d, d), fan_in=d),
    }


def _slstm_cell(cfg: ArchConfig, p, carry, z_t: torch.Tensor):
    """carry: (c, n, h) each (B, d); z_t: (B, 4d) pre-activation (input part)."""
    c, n, h = carry
    cd = z_t.dtype
    rec = h @ p["w_rec"].to(cd)
    zi, zf, zz, zo = torch.chunk((z_t + rec + p["b"].to(cd)).float(), 4, dim=-1)
    i_g = torch.exp(torch.clamp_max(zi, 8.0))  # capped exponential input gate
    f_g = torch.sigmoid(zf)
    z_v = torch.tanh(zz)
    o_g = torch.sigmoid(zo)
    c_new = f_g * c + i_g * z_v
    n_new = f_g * n + i_g
    h_new = (o_g * c_new / torch.clamp_min(n_new, 1.0)).to(cd)
    return (c_new, n_new, h_new), h_new


def slstm_forward(cfg: ArchConfig, p, x: torch.Tensor, state=None):
    """x: (B,S,d). Returns (x + out, new state {"c", "n", "h"}) after one
    cell step per position, in order."""
    B, S, d = x.shape
    cd = x.dtype
    h_in = rms_norm(x, p["norm"], eps=cfg.norm_eps)
    z = h_in @ p["w_in"].to(cd)  # (B,S,4d)
    if state is None:
        state = slstm_init_state(cfg, B, device=x.device)
    carry = (state["c"], state["n"], state["h"].to(cd))
    hs = []
    for t in range(S):
        carry, h_t = _slstm_cell(cfg, p, carry, z[:, t])
        hs.append(h_t)
    c, n, h_last = carry
    out = torch.stack(hs, dim=1) @ p["w_out"].to(cd)
    return x + out, {"c": c, "n": n, "h": h_last.float()}


def slstm_init_state(cfg: ArchConfig, batch: int, *, device) -> dict:
    d = cfg.d_model
    return {name: torch.zeros((batch, d), dtype=torch.float32, device=device)
            for name in ("c", "n", "h")}


def slstm_decode_step(cfg: ArchConfig, p, x: torch.Tensor, state):
    return slstm_forward(cfg, p, x, state=state)


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def init_mamba_block(pi: ParamInit, cfg: ArchConfig) -> dict:
    """One Mamba2 layer: three separate input projections (z, xBC, dt), the
    depthwise causal conv, the per-head decay (A_log, dt_bias) and skip (D),
    the gated output norm and the output projection. Norm weights, A_log and
    dt_bias are fp32 (read as fp32); the rest in `pi`'s dtype."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    conv_dim = di + 2 * cfg.ssm_state
    W = cfg.ssm_conv_width
    return {
        "norm": pi.zeros((d,), dtype=torch.float32),
        "w_z": pi.normal((d, di), fan_in=d),
        "w_xbc": pi.normal((d, conv_dim), fan_in=d),
        "w_dt": pi.normal((d, H), fan_in=d),
        "conv_w": pi.normal((W, conv_dim), fan_in=W),
        "conv_b": pi.zeros((conv_dim,)),
        "A_log": pi.zeros((H,), dtype=torch.float32),
        "dt_bias": pi.zeros((H,), dtype=torch.float32),
        "D": pi.constant(1.0, (H,)),
        "out_norm": pi.zeros((di,), dtype=torch.float32),
        "w_out": pi.normal((di, d), fan_in=di),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, state=None):
    """Depthwise causal conv. x: (B, S, Cd); w: (W, Cd); state: None (zeros)
    or (B, W-1, Cd), the trailing W-1 inputs of the positions before. Returns
    (y (B, S, Cd), new state (B, W-1, Cd), its own storage)."""
    B, S, Cd = x.shape
    W = w.shape[0]
    if state is None:
        state = torch.zeros((B, W - 1, Cd), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+W-1, Cd)
    y = torch.zeros((B, S, Cd), dtype=x.dtype, device=x.device)
    for i in range(W):  # W is tiny (4): unrolled taps, in the reference's order
        y = y + xp[:, i : i + S, :] * w[i][None, None, :]
    # a copy: a view would keep the whole padded input alive with the state
    new_state = xp[:, S:, :].clone()
    return y + b[None, None, :], new_state


def mamba_forward(cfg: ArchConfig, p, x: torch.Tensor, state=None):
    """x: (B, S, d). Returns (x + out, new state {"S", "conv"}); `state` None
    starts from zeros. One `gated_linear_scan` call (prefill: S positions,
    decode: one), carrying the state S (B, H, ssm_state, head_dim) fp32."""
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    hd = di // H
    st = cfg.ssm_state
    cd = x.dtype
    h = rms_norm(x, p["norm"], eps=cfg.norm_eps)
    z = h @ p["w_z"].to(cd)
    xBC = h @ p["w_xbc"].to(cd)
    dt = h @ p["w_dt"].to(cd)
    conv_state = state["conv"] if state is not None else None
    xBC, conv_state = _causal_conv(xBC, p["conv_w"].to(cd), p["conv_b"].to(cd), state=conv_state)
    xBC = F.silu(xBC)
    x_ssm, Bmat, Cmat = torch.split(xBC, [di, st, st], dim=-1)  # (B,S,di), (B,S,st) x 2

    dt = F.softplus(dt.float() + p["dt_bias"].float())  # (B,S,H)
    A = -torch.exp(p["A_log"].float())  # (H,), negative
    log_a = (dt * A[None, None, :]).transpose(1, 2)  # (B,H,S)

    # the gated linear scan: q = C, k = B * dt, v = x, per head
    q = Cmat[:, None, :, :].expand(B, H, S, st)
    k = (Bmat[:, None, :, :] * dt.transpose(1, 2)[..., None]).to(cd)
    v = x_ssm.reshape(B, S, H, hd).transpose(1, 2)
    s0 = state["S"] if state is not None else None
    y, S_f = ops.gated_linear_scan(q, k, v, log_a, chunk=_chunk_for(S), initial_state=s0)
    y = y + p["D"].to(cd)[None, :, None, None] * v  # skip connection
    y = y.transpose(1, 2).reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["out_norm"], eps=cfg.norm_eps)
    out = y @ p["w_out"].to(cd)
    return x + out, {"S": S_f, "conv": conv_state}


def mamba_init_state(cfg: ArchConfig, batch: int, *, device, dtype=torch.float32,
                     conv_dtype=None) -> dict:
    """Zero state of one Mamba2 layer: S (batch, H, ssm_state, head_dim) in
    `dtype` (fp32) and the conv window (batch, W-1, conv_dim) in
    `conv_dtype` (the compute dtype on the serving path)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    conv_dim = di + 2 * cfg.ssm_state
    return {
        "S": torch.zeros((batch, H, cfg.ssm_state, di // H), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=conv_dtype or dtype, device=device),
    }


def mamba_decode_step(cfg: ArchConfig, p, x: torch.Tensor, state):
    """x: (B, 1, d) -> (y (B, 1, d), new state)."""
    return mamba_forward(cfg, p, x, state=state)
