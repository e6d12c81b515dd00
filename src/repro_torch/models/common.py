"""Common model building blocks: seeded parameter init, norms, RoPE,
embeddings, activations and the cross-entropy loss. Port of
`repro/models/common.py`; the numerics follow it exactly (fp32 RMSNorm
scaled by ``1 + w``, tanh GELU, split-half RoPE with fp32 angles, embedding
rows cast to the compute dtype, the loss in fp32 with its z-loss term)."""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.backends.torchdev import resolve_device as _backend_device
from repro_torch.sharding.ambient import constrain

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device=None) -> torch.device:
    """The device a constructor allocates on. None means the current CUDA
    device and raises where there is none (the CPU only when asked, with
    ``device="cpu"``); any other value is taken as given (``"meta"`` too)."""
    return _backend_device(None) if device is None else torch.device(device)


class ParamInit:
    """Creates parameters from one seeded `torch.Generator` on `device`, with
    the reference's distribution: normal with std ``scale / sqrt(fan_in)``,
    norm weights zero. The numbers differ from JAX's for the same seed (a
    test bridges the reference's weights instead). On the ``meta`` device
    nothing is drawn or allocated."""

    def __init__(self, seed: int, device, dtype: torch.dtype = torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen: Optional[torch.Generator] = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(seed)

    def normal(self, shape: Sequence[int], *, fan_in: int, scale: float = 1.0,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Drawn in fp32 and stored in `dtype` (default: the storage dtype)."""
        std = scale / math.sqrt(max(1, fan_in))
        if self.gen is None:
            return torch.empty(tuple(shape), dtype=dtype or self.dtype, device=self.device)
        x = torch.randn(tuple(shape), generator=self.gen, device=self.device, dtype=torch.float32)
        return (x * std).to(dtype or self.dtype)

    def stacked_normal(self, shape: Sequence[int], *, fan_in: int,
                       scale: float = 1.0) -> torch.Tensor:
        """`normal` for a stack of matrices (MoE experts: (E, d, f)), drawn one
        leading index at a time into a tensor of the storage dtype, so the
        fp32 transient is one matrix, not the stack (kimi-k2's `w_up` is 22.5
        GB in fp32). The same seed gives the same numbers every time."""
        out = torch.empty(tuple(shape), dtype=self.dtype, device=self.device)
        if self.gen is None:
            return out
        std = scale / math.sqrt(max(1, fan_in))
        for i in range(shape[0]):
            x = torch.randn(tuple(shape[1:]), generator=self.gen, device=self.device,
                            dtype=torch.float32)
            out[i] = x * std
        return out

    def zeros(self, shape: Sequence[int], *, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=dtype or self.dtype, device=self.device)

    def constant(self, value: float, shape: Sequence[int]) -> torch.Tensor:
        return torch.full(tuple(shape), value, dtype=self.dtype, device=self.device)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"gelu": _gelu_tanh, "silu": F.silu, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S). Split-half rotation."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)
    angles = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(pi: ParamInit, vocab: int, d_model: int, *, tie: bool):
    tree = {"embedding": pi.normal((vocab, d_model), fan_in=d_model)}
    if not tie:
        tree["unembed"] = pi.normal((d_model, vocab), fan_in=d_model)
    return tree


def embed(params, tokens: torch.Tensor, *, compute_dtype: torch.dtype) -> torch.Tensor:
    return params["embedding"][tokens.long()].to(compute_dtype)


def unembed(params, x: torch.Tensor, *, tie: bool) -> torch.Tensor:
    """Logits in the activation dtype."""
    if tie:
        return x @ params["embedding"].to(x.dtype).T
    return x @ params["unembed"].to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          z_loss: float = 0.0) -> torch.Tensor:
    """logits: (..., V); labels: (...) int. Returns the mean loss (fp32), with
    ``z_loss * logsumexp**2`` added per position when `z_loss` is set."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # under a mesh, logits split over the vocabulary gather to a partial
    # sum that DTensor cannot index: reduce it first (a no-op otherwise)
    picked = constrain(torch.gather(logits, -1, labels.long()[..., None]), ("pod", "data"))
    label_logits = picked[..., 0]
    loss = logz - label_logits
    if z_loss:
        loss = loss + z_loss * torch.square(logz)
    return torch.mean(loss)
