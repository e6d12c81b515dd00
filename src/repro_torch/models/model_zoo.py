"""Model zoo: one bundle of functions per architecture family, with the
serving protocol of the reference's `repro/models/model_zoo.py`. Only the
transformer family (dense, no MoE) is ported."""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from repro_torch.configs import ArchConfig
from . import transformer
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
    """

    layout: Callable
    init_pools: Callable
    commit_prefill: Callable
    decode_step: Callable


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable  # (seed=0, device=None, dtype=None) -> params
    #: (batch, max_len, device=None) -> per-layer dense decoder state
    init_state: Callable
    #: (max_len) -> prefill(params, batch) whose caches have headroom for
    #: `max_len` positions, made on the tokens' device
    make_prefill: Callable
    #: (params, state, {"tokens": (B,1), "pos": scalar or (B,)})
    #: -> (logits (B,V), state), the dense caches updated in place
    decode_step: Callable
    paged_ops: PagedOps


def build(cfg: ArchConfig) -> ModelBundle:
    if cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError(f"model family {cfg.family!r} is not ported yet")
    return _build_transformer(cfg)


def _build_transformer(cfg: ArchConfig) -> ModelBundle:
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
        init_state=functools.partial(transformer.init_caches, cfg),
        make_prefill=make_prefill,
        decode_step=decode_step,
        paged_ops=PagedOps(
            layout=functools.partial(paged_layout, cfg),
            init_pools=functools.partial(transformer.init_paged_caches, cfg),
            commit_prefill=functools.partial(transformer.commit_prefill_paged, cfg),
            decode_step=functools.partial(transformer.lm_paged_decode_step, cfg),
        ),
    )
