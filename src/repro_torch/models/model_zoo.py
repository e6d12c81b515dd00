"""Model zoo: one bundle of functions per architecture family, with the
batch protocol of the reference's `repro/models/model_zoo.py`:

    train batch:   {"tokens": (B,S), "labels": (B,S)[, "patches" | "frames"]}
    prefill batch: {"tokens": (B,S)[, "patches" | "frames"]}
    decode batch:  {"tokens": (B,1), "pos": scalar or (B,)[, "per_slot": True]}

Every family of the reference: the transformers (``dense`` and ``moe``),
the ``vlm`` (paligemma: a vision prefix), ``audio`` (whisper: an
encoder-decoder), the recurrent ``ssm`` (xlstm) and the ``hybrid`` (zamba2:
Mamba2 + a shared attention block). The slot decoder marks its steps
``per_slot`` (every row its own request; MoE layers then never drop, as the
reference's vmapped B=1 step). Every family's loss is ported, and
`make_batch` draws a batch of any kind with the extra inputs the VLM and the
encoder-decoder need (their token streams carry no patches or frames).

For planning without weights, `logical_axes(cfg, params)` gives the
parameter tree its logical sharding axes (the reference's vocabulary, its
stack axes dropped), and `ModelBundle.input_specs(shape)` /
`state_specs(shape)` make a batch and a decode state on the ``meta``
device (the reference's ``jax.ShapeDtypeStruct`` stand-ins)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from . import encdec, hybrid, transformer, vlm, xlstm_model
from .attention import paged_layout
from .common import dtype_of, resolve_device


@dataclasses.dataclass(frozen=True)
class PagedOps:
    """Paged KV-cache entry points (the serve path's block-pool cache).

    layout(max_slots=..., max_len=..., page_size=..., num_pages=None)
        -> PagedLayout (static cache geometry)
    init_pools(layout, device=...) -> per-layer block pools (no batch dim)
    commit_prefill(layout, pools, dense_state, full_row, ring_row) -> pools
        scatter one slot's B=1 dense prefill cache into its pages
    decode_step(layout, params, pools, full_table, tokens, pos, active)
        -> (logits (B,V), pools): one batched decode tick over the pool
    prefix_prefill(layout, params, pools, row, tokens, off)
        -> (logits (1,V), dense caches): prefill only a prompt's uncached
        tail against a shared prefix gathered from pool pages (a `shared`
        layout; the prefix-cache admission path)
    """

    layout: Callable
    init_pools: Callable
    commit_prefill: Callable
    decode_step: Callable
    prefix_prefill: Callable = None


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable  # (seed=0, device=None, dtype=None) -> params
    #: (params, {"tokens": (B,S), "labels": (B,S)}) -> (loss, metrics)
    loss: Callable
    #: (batch, max_len, device=None) -> per-layer decoder state
    init_state: Callable
    #: (max_len) -> prefill(params, batch) whose caches have headroom for
    #: `max_len` positions, made on the tokens' device
    make_prefill: Callable
    #: (params, state, {"tokens": (B,1), "pos": scalar or (B,)[, "per_slot"]})
    #: -> (logits (B,V), state): dense caches updated in place, recurrent
    #: states replaced
    decode_step: Callable
    #: (seed or torch.Generator, ShapeConfig, device=None) -> batch of the
    #: shape's kind (`make_batch` below)
    make_batch: Callable = None
    #: paged KV-cache ops, or None for families without a paged decode path
    #: (recurrent states are O(1); the VLM and the encoder-decoder need
    #: prefill inputs the scheduler does not carry, as in the reference)
    paged_ops: PagedOps = None

    def input_specs(self, shape: ShapeConfig) -> dict:
        """Every input of a batch of `shape`'s kind as a ``meta`` tensor of
        the reference's shape and dtype (`input_specs`): a decode batch's
        ``pos`` is 0-d, the VLM's text is the seq_len less its vision
        prefix."""
        return input_specs(self.cfg, shape)

    def state_specs(self, shape: ShapeConfig):
        """The decode state for `shape` (global_batch rows, seq_len deep) on
        the ``meta`` device: no allocation."""
        return self.init_state(shape.global_batch, shape.seq_len, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """`ModelBundle.input_specs`."""
    B, S = shape.global_batch, shape.seq_len
    cd = dtype_of(cfg.compute_dtype)
    meta = dict(device="meta")
    if cfg.family == "vlm" and shape.kind != "decode":
        S -= cfg.vision_tokens
    if shape.kind == "train":
        specs = {"tokens": torch.empty((B, S), dtype=torch.int32, **meta),
                 "labels": torch.empty((B, S), dtype=torch.int32, **meta)}
    elif shape.kind == "prefill":
        specs = {"tokens": torch.empty((B, S), dtype=torch.int32, **meta)}
    else:  # decode: one new token against a seq_len-deep state
        return {"tokens": torch.empty((B, 1), dtype=torch.int32, **meta),
                "pos": torch.empty((), dtype=torch.int32, **meta)}
    if cfg.family == "vlm":
        specs["patches"] = torch.empty((B, cfg.vision_tokens, cfg.vision_embed_dim), dtype=cd,
                                       **meta)
    if cfg.family == "audio":
        specs["frames"] = torch.empty((B, cfg.encoder_context, cfg.d_model), dtype=cd, **meta)
    return specs


#: logical axes by leaf name (the reference's `ParamBuilder` calls); the
#: names shared by several blocks are resolved in `_leaf_axes`
_AXES = {
    "embedding": ("vocab", "embed"), "unembed": ("embed", "vocab"),
    "enc_pos": ("norm", "embed"), "vision_proj": ("norm", "embed"),
    "wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed"),
    "router": ("embed", "expert"),
    "w_qkv": ("embed", "ssm_inner"), "w_gates": ("embed", "heads"), "b_gates": ("heads",),
    "w_ogate": ("embed", "ssm_inner"),
    "w_in": ("embed", "ssm_inner"), "w_rec": ("embed", "ssm_inner"), "b": ("ssm_inner",),
    "w_z": ("embed", "ssm_inner"), "w_xbc": ("embed", "ssm_inner"), "w_dt": ("embed", "heads"),
    "conv_w": ("conv", "ssm_inner"), "conv_b": ("ssm_inner",), "A_log": ("heads",),
    "dt_bias": ("heads",), "D": ("heads",), "out_norm": ("ssm_inner",),
}
_NORMS = frozenset({"ln1", "ln2", "ln_x", "norm", "final_norm", "enc_norm"})


def _leaf_axes(key: str, parent, siblings) -> tuple:
    if key in _NORMS:
        return ("norm",)
    if key in ("w_up", "w_gate"):
        return ("expert", "embed", "mlp") if parent == "moe" else ("embed", "mlp")
    if key == "w_down":
        return ("expert", "mlp", "embed") if parent == "moe" else ("mlp", "embed")
    if key == "w_out":  # the sLSTM's is square; the mLSTM's and Mamba2's project down
        return ("embed", "embed") if "w_rec" in siblings else ("ssm_inner", "embed")
    return _AXES[key]


def logical_axes(cfg: ArchConfig, params, *, stacked: bool = False):
    """The parameter tree's logical sharding axes: a tree of the same
    structure whose leaves are tuples of axis names, one a dim, from the
    reference's vocabulary (`repro/models/common.py::ParamBuilder`). The
    port keeps one dict a layer, so the reference's stack axes ("layers",
    "units") have no dim here and are dropped. ``stacked=True`` takes a tree
    in the reference's stacked layout (`bridge.stack_params`): each leading
    stack dim gets "layers", which no plan shards."""
    def walk(node, key=None, parent=None, siblings=()):
        if isinstance(node, dict):
            return {k: walk(v, k, key, node) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key, parent, siblings) for v in node]
        axes = _leaf_axes(key, parent, siblings)
        extra = node.dim() - len(axes)
        if extra < 0 or (extra and not stacked):
            raise ValueError(f"leaf {key!r}: {node.dim()} dims, logical axes {axes}")
        return ("layers",) * extra + axes

    return walk(params)


def _generator(key, device) -> torch.Generator:
    """`key` as a generator: a `torch.Generator` as given, an int as the
    seed of a new one on `device` (None: the current CUDA device)."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(key))
    return gen


def make_batch(cfg: ArchConfig, key, shape: ShapeConfig, *, device=None) -> dict:
    """A random batch of `shape`'s kind, as the reference's `make_batch`
    draws one (`repro/models/model_zoo.py`; torch's generator gives other
    numbers than JAX's): tokens and labels uniform over the vocabulary, or
    for decode one token and ``pos`` = seq_len - 1; the VLM's patches
    (B, vision_tokens, vision_embed_dim) standard normal, its text the
    seq_len less the vision prefix (train and prefill); the audio model's
    frames (B, encoder_context, d_model) standard normal x 0.02; both in the
    compute dtype. `key`: an int seed or a `torch.Generator`, whose device
    the batch lands on (an int seeds a generator on `device`; None: the
    current CUDA device)."""
    gen = _generator(key, device)
    dev = gen.device
    cd = dtype_of(cfg.compute_dtype)
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    if cfg.family == "vlm" and not decode:
        S -= cfg.vision_tokens

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (B, n), generator=gen, device=dev,
                             dtype=torch.int32)

    if shape.kind == "train":
        batch = {"tokens": tokens(S), "labels": tokens(S)}
    elif shape.kind == "prefill":
        batch = {"tokens": tokens(S)}
    else:
        batch = {"tokens": tokens(1), "pos": torch.tensor(S - 1, dtype=torch.int32, device=dev)}
    if not decode and cfg.family == "vlm":
        batch["patches"] = torch.randn((B, cfg.vision_tokens, cfg.vision_embed_dim),
                                       generator=gen, device=dev).to(cd)
    if not decode and cfg.family == "audio":
        batch["frames"] = torch.randn((B, cfg.encoder_context, cfg.d_model), generator=gen,
                                      device=dev).to(cd) * 0.02
    return batch


def param_count(params) -> int:
    """Elements in a parameter tree (nested dicts and lists of tensors)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()


def build(cfg: ArchConfig) -> ModelBundle:
    if cfg.family in ("dense", "moe"):
        return _build_transformer(cfg)
    if cfg.family == "vlm":
        return _build_vlm(cfg)
    if cfg.family == "audio":
        return _build_encdec(cfg)
    if cfg.family == "ssm":
        return _build_xlstm(cfg)
    if cfg.family == "hybrid":
        return _build_hybrid(cfg)
    raise KeyError(cfg.family)


def _build_transformer(cfg: ArchConfig) -> ModelBundle:
    def loss(params, batch):
        return transformer.lm_loss(cfg, params, batch["tokens"], batch["labels"])

    def make_prefill(max_len=None):
        def prefill(params, batch):
            tokens = batch["tokens"]
            B, S = tokens.shape
            caches = transformer.init_caches(cfg, B, max_len or S, device=tokens.device)
            return transformer.lm_prefill(cfg, params, tokens, caches)

        return prefill

    def decode_step(params, state, batch):
        return transformer.lm_decode_step(cfg, params, state, batch["tokens"], batch["pos"],
                                          dropless=batch.get("per_slot", False))

    return ModelBundle(
        cfg=cfg,
        init=functools.partial(transformer.init_lm, cfg),
        loss=loss,
        init_state=functools.partial(transformer.init_caches, cfg),
        make_prefill=make_prefill,
        decode_step=decode_step,
        make_batch=functools.partial(make_batch, cfg),
        paged_ops=PagedOps(
            layout=functools.partial(paged_layout, cfg),
            init_pools=functools.partial(transformer.init_paged_caches, cfg),
            commit_prefill=functools.partial(transformer.commit_prefill_paged, cfg),
            decode_step=functools.partial(transformer.lm_paged_decode_step, cfg),
            prefix_prefill=functools.partial(transformer.lm_prefix_prefill, cfg),
        ),
    )


def _build_vlm(cfg: ArchConfig) -> ModelBundle:
    P = cfg.vision_tokens

    def loss(params, batch):
        return vlm.lm_loss(cfg, params, batch["tokens"], batch["labels"], batch["patches"])

    def make_prefill(max_len=None):
        def prefill(params, batch):
            tokens = batch["tokens"]
            B, S_text = tokens.shape
            caches = vlm.init_states(cfg, B, max_len or (P + S_text), device=tokens.device)
            return vlm.lm_prefill(cfg, params, tokens, caches, batch["patches"])

        return prefill

    def decode_step(params, state, batch):
        return vlm.lm_decode_step(cfg, params, state, batch["tokens"], batch["pos"])

    return ModelBundle(
        cfg=cfg,
        init=functools.partial(vlm.init_lm, cfg),
        loss=loss,
        init_state=functools.partial(vlm.init_states, cfg),
        make_prefill=make_prefill,
        decode_step=decode_step,
        make_batch=functools.partial(make_batch, cfg),
    )


def _build_encdec(cfg: ArchConfig) -> ModelBundle:
    def loss(params, batch):
        return encdec.lm_loss(cfg, params, batch["tokens"], batch["labels"], batch["frames"])

    def make_prefill(max_len=None):
        def prefill(params, batch):
            tokens = batch["tokens"]
            B, S = tokens.shape
            states = encdec.init_states(cfg, B, max_len or S, device=tokens.device)
            return encdec.lm_prefill(cfg, params, tokens, states, batch["frames"])

        return prefill

    def decode_step(params, state, batch):
        return encdec.lm_decode_step(cfg, params, state, batch["tokens"], batch["pos"])

    return ModelBundle(
        cfg=cfg,
        init=functools.partial(encdec.init_lm, cfg),
        loss=loss,
        init_state=functools.partial(encdec.init_states, cfg),
        make_prefill=make_prefill,
        decode_step=decode_step,
        make_batch=functools.partial(make_batch, cfg),
    )


def _build_xlstm(cfg: ArchConfig) -> ModelBundle:
    def loss(params, batch):
        return xlstm_model.lm_loss(cfg, params, batch["tokens"], batch["labels"])

    def make_prefill(max_len=None):  # recurrent state is O(1): max_len unused
        def prefill(params, batch):
            tokens = batch["tokens"]
            states = xlstm_model.init_states(cfg, tokens.shape[0], device=tokens.device)
            return xlstm_model.lm_prefill(cfg, params, tokens, states)

        return prefill

    def decode_step(params, state, batch):
        return xlstm_model.lm_decode_step(cfg, params, state, batch["tokens"], batch["pos"])

    return ModelBundle(
        cfg=cfg,
        init=functools.partial(xlstm_model.init_lm, cfg),
        loss=loss,
        init_state=lambda batch, max_len, device=None: xlstm_model.init_states(
            cfg, batch, device=device),
        make_prefill=make_prefill,
        decode_step=decode_step,
        make_batch=functools.partial(make_batch, cfg),
    )


def _build_hybrid(cfg: ArchConfig) -> ModelBundle:
    def loss(params, batch):
        return hybrid.lm_loss(cfg, params, batch["tokens"], batch["labels"])

    def make_prefill(max_len=None):
        def prefill(params, batch):
            tokens = batch["tokens"]
            B, S = tokens.shape
            states = hybrid.init_states(cfg, B, max_len or S, device=tokens.device)
            return hybrid.lm_prefill(cfg, params, tokens, states)

        return prefill

    def decode_step(params, state, batch):
        return hybrid.lm_decode_step(cfg, params, state, batch["tokens"], batch["pos"])

    return ModelBundle(
        cfg=cfg,
        init=functools.partial(hybrid.init_lm, cfg),
        loss=loss,
        init_state=functools.partial(hybrid.init_states, cfg),
        make_prefill=make_prefill,
        decode_step=decode_step,
        make_batch=functools.partial(make_batch, cfg),
    )
