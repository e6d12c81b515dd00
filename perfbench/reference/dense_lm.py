"""A dense decoder-only LM as the port computes it, in plain float32 torch.

The architecture is the port's (`repro_torch/models/transformer.py`), which
departs from the published models in ways each config file lists under
`assumed`: pre-norm layers with RMSNorm scaled by (1 + w), split-half RoPE on
every head dimension, grouped-query attention with query head h reading KV
head h // (H / KV), a tanh-GELU MLP or a SiLU-gated one, no biases, an untied
LM head; the loss is the mean cross-entropy plus z_loss * logsumexp**2.

Weights come in as the benchmark made them (a path -> tensor dict, any
dtype) and are upcast one layer at a time, so a full-width model fits beside
its own weights. `precision="fp8"` is the control: each matrix product's
operands are rounded to float8 e4m3 (a scale per row of the activations and
per column of the weights) before an fp32 product, straight through for the
gradient.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

ATTN_CHUNK = 512  # query rows a block of the attention's score matrix
E4M3_MAX = 448.0


def strict_fp32() -> None:
    """Matrix products in true float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = E4M3_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x.detach())  # the rounded value forward, identity backward


def mm(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """a (..., k) @ w (k, n) in fp32, or with fp8-rounded operands."""
    if precision == "fp8":
        a, w = _fp8(a, -1), _fp8(w, 0)
    elif precision != "fp32":
        raise ValueError(f"precision {precision!r}: fp32 or fp8")
    return a @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd), pos (S,): split-half rotation by pos * theta^(-2i/hd)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd)
    ang = pos.float()[:, None] * inv[None, :]
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v) -> torch.Tensor:
    """Causal attention of one sequence. q (S, H, hd), k / v (S, KV, hd) ->
    (S, H, hd); blocks of ATTN_CHUNK query rows."""
    S, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    kh = k.permute(1, 0, 2).repeat_interleave(G, dim=0)  # (H, S, hd): head h reads h // G
    vh = v.permute(1, 0, 2).repeat_interleave(G, dim=0)
    qh = q.permute(1, 0, 2) * (1.0 / math.sqrt(hd))
    outs = []
    for s0 in range(0, S, ATTN_CHUNK):
        s1 = min(S, s0 + ATTN_CHUNK)
        scores = qh[:, s0:s1] @ kh[:, :s1].transpose(1, 2)  # (H, rows, s1)
        qpos = torch.arange(s0, s1, device=q.device)[:, None]
        kpos = torch.arange(s1, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, float("-inf"))
        outs.append(torch.softmax(scores, dim=-1) @ vh[:, :s1])
    return torch.cat(outs, dim=1).permute(1, 0, 2)


class Model:
    """The reference over a path -> tensor dict of weights. `arch` holds the
    port's config fields (d_model, num_heads, num_kv_heads, head_dim,
    d_ff, vocab_size, num_layers, act, rope_theta, norm_eps)."""

    def __init__(self, arch, weights: Dict[str, torch.Tensor], precision: str = "fp32"):
        self.a = arch
        self.w = weights
        self.precision = precision
        self.hd = arch.head_dim or arch.d_model // arch.num_heads

    def layer_weights(self, i: int) -> Dict[str, torch.Tensor]:
        p = f"layers.{i}."
        return {k[len(p):]: v.float() for k, v in self.w.items() if k.startswith(p)}

    def layer(self, lw, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One pre-norm layer over x (S, d) of one sequence."""
        a, pr = self.a, self.precision
        S, d = x.shape
        H, KV, hd = a.num_heads, a.num_kv_heads, self.hd
        h = rms_norm(x, lw["ln1"], a.norm_eps)
        q = mm(h, lw["attn.wq"].reshape(d, H * hd), pr).reshape(S, H, hd)
        k = mm(h, lw["attn.wk"].reshape(d, KV * hd), pr).reshape(S, KV, hd)
        v = mm(h, lw["attn.wv"].reshape(d, KV * hd), pr).reshape(S, KV, hd)
        q, k = rope(q, pos, a.rope_theta), rope(k, pos, a.rope_theta)
        o = attention(q, k, v).reshape(S, H * hd)
        x = x + mm(o, lw["attn.wo"].reshape(H * hd, d), pr)
        h = rms_norm(x, lw["ln2"], a.norm_eps)
        up = mm(h, lw["ffn.w_up"], pr)
        if a.act == "silu":
            act = F.silu(mm(h, lw["ffn.w_gate"], pr)) * up
        else:
            act = F.gelu(up, approximate="tanh")
        return x + mm(act, lw["ffn.w_down"], pr)

    def unembed(self) -> torch.Tensor:
        w = self.w.get("embed.unembed")
        return w.float() if w is not None else self.w["embed.embedding"].float().T

    # -- serving: logits of chosen rows, no gradient ------------------------
    @torch.no_grad()
    def logits_rows(self, seqs: Sequence[torch.Tensor], rows: Sequence[torch.Tensor]):
        """For each token sequence (S,), the fp32 logits (len(rows), V) at
        its positions `rows`. Layer by layer over every sequence."""
        emb = self.w["embed.embedding"]
        xs = [emb[s.long()].float() for s in seqs]
        poss = [torch.arange(s.shape[0], device=s.device) for s in seqs]
        for i in range(self.a.num_layers):
            lw = self.layer_weights(i)
            xs = [self.layer(lw, x, p) for x, p in zip(xs, poss)]
            del lw
        fn = self.w["final_norm"].float()
        head = self.unembed()
        out = [mm(rms_norm(x[r], fn, self.a.norm_eps), head, self.precision)
               for x, r in zip(xs, rows)]
        return out

    # -- training: the loss and its gradient ---------------------------------
    def loss(self, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
             labels: torch.Tensor, z_loss: float) -> torch.Tensor:
        """Mean loss of one sequence (S,) under `params` (path -> fp32
        leaf requiring grad), each layer recomputed in the backward."""
        self.w = params
        pos = torch.arange(tokens.shape[0], device=tokens.device)
        x = params["embed.embedding"][tokens.long()]
        for i in range(self.a.num_layers):
            p = f"layers.{i}."
            lw = {k[len(p):]: v for k, v in params.items() if k.startswith(p)}
            x = checkpoint.checkpoint(self.layer, lw, x, pos, use_reentrant=False)
        h = rms_norm(x, params["final_norm"], self.a.norm_eps)
        logits = mm(h, self.unembed(), self.precision)
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
        return torch.mean(logz - picked + z_loss * logz * logz)


def lr_at(opt: dict, count: int) -> float:
    """Linear warmup, then cosine decay to min_lr_ratio (the port's AdamW
    schedule, as the traffic file states its constants)."""
    warm = min(count / max(opt["warmup_steps"], 1), 1.0)
    span = max(opt["decay_steps"] - opt["warmup_steps"], 1)
    progress = min(max((count - opt["warmup_steps"]) / span, 0.0), 1.0)
    cosine = 0.5 * (1 + math.cos(math.pi * progress))
    decay = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * cosine
    return opt["learning_rate"] * warm * decay


def train_steps(model: Model, params: Dict[str, torch.Tensor], batches: Sequence[dict],
                opt: dict, z_loss: float, rows: Optional[Sequence[int]] = None) -> dict:
    """AdamW with global-norm clipping over `batches`, in fp32, updating
    `params` (path -> fp32 tensor) in place. `rows`: the batch rows the loss
    averages (all of them by default). Returns the loss of each step, each
    leaf's gradient norm at step 1 before and after clipping, and `params`
    after the last step."""
    for p in params.values():
        p.requires_grad_(True)
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, first_raw, first_clipped = [], None, None
    for step, batch in enumerate(batches, start=1):
        take = list(rows) if rows is not None else list(range(batch["tokens"].shape[0]))
        total = 0.0
        for r in take:
            loss = model.loss(params, batch["tokens"][r], batch["labels"][r], z_loss) / len(take)
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            grads = {k: p.grad for k, p in params.items()}
            norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
            scale = min(opt["clip_norm"] / max(norm, 1e-9), 1.0)
            if step == 1:
                first_raw = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
                first_clipped = {k: v * scale for k, v in first_raw.items()}
            lr = lr_at(opt, step)
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for k, p in params.items():
                g = grads[k] * scale
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
                upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps) + wd * p
                p.sub_(lr * upd)
                p.grad = None
    for p in params.values():
        p.requires_grad_(False)
    return {"losses": losses, "grad_norm_raw": first_raw, "grad_norm": first_clipped,
            "params": params}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep: Optional[List[str]] = None):
    """The worst leaf's gap between two norms, |prog - ref|, as a share of
    the larger of that leaf's reference norm and the median leaf's. Returns
    (gap, leaf)."""
    keys = keep if keep is not None else list(ref)
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    worst = max(keys, key=lambda k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med, 1e-30), worst
