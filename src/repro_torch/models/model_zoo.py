"""Model zoo: one bundle of functions per architecture family, with the
serving protocol of the reference's `repro/models/model_zoo.py`. Ported: the
transformer family (dense, no MoE), the recurrent ``ssm`` family (xlstm)
and the ``hybrid`` family (zamba2: Mamba2 + a shared attention block)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from repro_torch.configs import ArchConfig
from . import hybrid, transformer, xlstm_model
from .attention import paged_layout


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
    #: (params, state, {"tokens": (B,1), "pos": scalar or (B,)})
    #: -> (logits (B,V), state): dense caches updated in place, recurrent
    #: states replaced
    decode_step: Callable
    #: paged KV-cache ops, or None for families without a paged decode path
    #: (recurrent states are O(1))
    paged_ops: PagedOps = None


def build(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == "dense" and not cfg.is_moe:
        return _build_transformer(cfg)
    if cfg.family == "ssm":
        return _build_xlstm(cfg)
    if cfg.family == "hybrid":
        return _build_hybrid(cfg)
    raise NotImplementedError(f"model family {cfg.family!r} is not ported yet")


def _build_transformer(cfg: ArchConfig) -> ModelBundle:
    def loss(params, batch):
        raise NotImplementedError("the transformer loss is not ported yet (training slice)")

    def make_prefill(max_len=None):
        def prefill(params, batch):
            tokens = batch["tokens"]
            B, S = tokens.shape
            caches = transformer.init_caches(cfg, B, max_len or S, device=tokens.device)
            return transformer.lm_prefill(cfg, params, tokens, caches)

        return prefill

    def decode_step(params, state, batch):
        return transformer.lm_decode_step(cfg, params, state, batch["tokens"], batch["pos"])

    return ModelBundle(
        cfg=cfg,
        init=functools.partial(transformer.init_lm, cfg),
        loss=loss,
        init_state=functools.partial(transformer.init_caches, cfg),
        make_prefill=make_prefill,
        decode_step=decode_step,
        paged_ops=PagedOps(
            layout=functools.partial(paged_layout, cfg),
            init_pools=functools.partial(transformer.init_paged_caches, cfg),
            commit_prefill=functools.partial(transformer.commit_prefill_paged, cfg),
            decode_step=functools.partial(transformer.lm_paged_decode_step, cfg),
            prefix_prefill=functools.partial(transformer.lm_prefix_prefill, cfg),
        ),
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
    )


def _build_hybrid(cfg: ArchConfig) -> ModelBundle:
    def loss(params, batch):
        raise NotImplementedError("the hybrid loss is not ported yet (training slice)")

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
    )
