"""The kernel entry points on DTensors: each call runs on the local shards
through `torch.distributed.tensor.experimental.local_map`, so a kernel
wrapper (or its plain version) only ever sees plain tensors.

Attention, decode attention and the gated linear scan are independent per
(batch row, head): the batch dim keeps its data-parallel placement, the
heads dim is sharded over the ``model`` mesh axis when the query heads
divide it, and every other dim is replicated (inputs are redistributed to
that first). With query heads sharded and KV heads replicated (GQA whose
KV heads do not divide ``model``), each rank's local query heads are paired
with their own KV heads by the global head index: the KV tensor is cut to
those groups, or gathered one KV head per local query head where a rank's
heads do not start on a group boundary. The gradient of a KV tensor used
that way is a partial sum over the ``model`` ranks (``Partial`` in
``in_grad_placements``).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a local shard's gradient
    leaves `local_map` as a DTensor shard, and DTensor's views (the
    projections' reshapes) need it dense."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _dense_grads(*xs):
    return tuple(_ContiguousGrad.apply(x) if x.requires_grad else x for x in xs)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _layout(x, heads: int, heads_dim: int, batch: int):
    """Per mesh dim: the placement of the batch (dim 0) and heads dims of a
    per-head op's operands, from `x`'s own placements: a data-parallel
    mesh dim keeps ``Shard(0)`` where `x` has it and it divides, ``model``
    shards `heads_dim` where `heads` divides it, the rest replicate.
    Returns (placements, model mesh dim or None, model size)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    out, model_dim, model_size = [], None, 1
    for i, name in enumerate(names):
        size = mesh.size(i)
        if name == "model":
            model_dim, model_size = i, size
            out.append(Shard(heads_dim) if size > 1 and heads % size == 0 else Replicate())
        elif x.placements[i] == Shard(0) and batch % size == 0:
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return out, model_dim, model_size


def _kv_layout(q_pl, model_dim, heads_dim: int, kv_heads: int, model_size: int):
    """(KV placements, KV grad placements, whether KV is replicated under
    sharded query heads)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    pl = list(q_pl)
    if model_dim is None or not isinstance(q_pl[model_dim], Shard):
        return pl, pl, False
    if kv_heads % model_size == 0:
        pl[model_dim] = Shard(heads_dim)
        return pl, pl, False
    pl[model_dim] = Replicate()
    grad = list(pl)
    grad[model_dim] = Partial()
    return pl, grad, True


def _local_kv(kl, vl, ql_heads: int, heads: int, kv_heads: int, rank: int, heads_dim: int):
    """The local query heads' KV heads, by global head index."""
    G = heads // kv_heads
    lo = rank * ql_heads
    if ql_heads % G == 0 and lo % G == 0:
        return (kl.narrow(heads_dim, lo // G, ql_heads // G),
                vl.narrow(heads_dim, lo // G, ql_heads // G))
    idx = torch.arange(lo, lo + ql_heads, device=kl.device) // G
    return kl.index_select(heads_dim, idx), vl.index_select(heads_dim, idx)


def attention(fn: Callable, q, k, v, **kw) -> torch.Tensor:
    """`fn(q, k, v, **kw)` (the plain-tensor `ops.attention`) on the local
    shards. q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd)."""
    from torch.distributed.tensor.experimental import local_map

    H, KV = q.shape[2], k.shape[2]
    q_pl, model_dim, model_size = _layout(q, H, 2, q.shape[0])
    kv_pl, kv_grad, expand = _kv_layout(q_pl, model_dim, 2, KV, model_size)
    mesh = q.device_mesh

    def local(ql, kl, vl):
        ql, kl, vl = _dense_grads(ql, kl, vl)
        if expand:
            rank = mesh.get_local_rank(model_dim)
            kl, vl = _local_kv(kl, vl, ql.shape[2], H, KV, rank, 2)
        return fn(ql, kl, vl, **kw)

    q = q.redistribute(mesh, q_pl)
    k, v = (t.redistribute(mesh, kv_pl) for t in (k, v))
    return local_map(local, out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=mesh)(q, k, v)


def decode_attention(fn: Callable, q, k_cache, v_cache, pos, **kw) -> torch.Tensor:
    """`fn(q, k_cache, v_cache, pos, **kw)` (the plain-tensor
    `ops.decode_attention`) on the local shards. q: (B, H, hd); caches:
    (B, S, KV, hd) in any placements (a cache split over its sequence is
    gathered on that axis); pos: (B,) or a scalar."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    H, KV = q.shape[1], k_cache.shape[2]
    q_pl, model_dim, model_size = _layout(q, H, 1, q.shape[0])
    mesh = q.device_mesh
    cache_pl, _, expand = _kv_layout(q_pl, model_dim, 2, KV, model_size)

    def local(ql, kl, vl, posl):
        if expand:
            rank = mesh.get_local_rank(model_dim)
            kl, vl = _local_kv(kl, vl, ql.shape[1], H, KV, rank, 2)
        return fn(ql, kl, vl, posl, **kw)

    args = [q.redistribute(mesh, q_pl), k_cache.redistribute(mesh, cache_pl),
            v_cache.redistribute(mesh, cache_pl), pos]
    pos_pl = None
    if is_dtensor(pos):
        pos_pl = ([p if p == Shard(0) else Replicate() for p in q_pl] if pos.dim()
                  else [Replicate()] * mesh.ndim)
        args[3] = pos.redistribute(mesh, pos_pl)
    return local_map(local, out_placements=q_pl, in_placements=(q_pl, cache_pl, cache_pl, pos_pl),
                     device_mesh=mesh)(*args)


def gated_linear_scan(fn: Callable, q, k, v, log_a, initial_state=None,
                      initial_normaliser=None, n_out: int = 2, **kw) -> Sequence[torch.Tensor]:
    """`fn(q, k, v, log_a, initial_state=..., initial_normaliser=..., **kw)`
    on the local shards: every operand and result is (B, H, ...), local
    over the batch and heads dims. `n_out` results."""
    from torch.distributed.tensor.experimental import local_map

    H = q.shape[1]
    pl, _, _ = _layout(q, H, 1, q.shape[0])
    mesh = q.device_mesh
    has_s0, has_n0 = initial_state is not None, initial_normaliser is not None

    def local(ql, kl, vl, la, *states):
        ql, kl, vl, la = _dense_grads(ql, kl, vl, la)
        states = _dense_grads(*states)
        it = iter(states)
        s0 = next(it) if has_s0 else None
        n0 = next(it) if has_n0 else None
        return tuple(fn(ql, kl, vl, la, initial_state=s0, initial_normaliser=n0, **kw))

    args = [q, k, v, log_a] + [s for s in (initial_state, initial_normaliser) if s is not None]
    args = [a.redistribute(mesh, pl) if is_dtensor(a) else a for a in args]
    in_pl = tuple(pl if is_dtensor(a) else None for a in args)
    return local_map(local, out_placements=tuple([pl] * n_out), in_placements=in_pl,
                     device_mesh=mesh)(*args)


def write_rows(cache, slot: torch.Tensor, val) -> None:
    """``cache[b, slot[b]] = val[b]`` for every row b, in place, on a
    DTensor cache (B, S, KV, hd) of any placements (a decode step's KV
    write): each rank writes the rows and positions its shard holds. `val`
    (B, KV, hd) is redistributed to the cache's batch and heads placements;
    `slot` (B,) holds global positions (a DTensor's are gathered whole)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = cache.device_mesh
    val_pl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2) else Replicate()
              for p in cache.placements]
    local, val_l = cache.to_local(), val.redistribute(mesh, val_pl).to_local()
    shape, offset = compute_local_shape_and_global_offset(tuple(cache.shape), mesh,
                                                          cache.placements)
    b0, s0 = offset[0], offset[1]
    if is_dtensor(slot):
        slot = slot.full_tensor()
    pos = slot[b0:b0 + shape[0]].to(local.device) - s0
    ok = ((pos >= 0) & (pos < shape[1]))[:, None, None]
    pos = pos.clamp(0, shape[1] - 1)
    rows = torch.arange(shape[0], device=local.device)
    # static shapes (a dry run's meta shards too): rows whose position lies
    # in another rank's shard write back what they read
    local[rows, pos] = torch.where(ok, val_l.to(local.dtype), local[rows, pos])


def elementwise(fn: Callable, x):
    """`fn` (an elementwise op) on a DTensor's local shards, for ops DTensor
    has no rule for (`F.logsigmoid`'s backward): exact on any placement but
    a partial sum, which is reduced first. A plain tensor takes `fn` as is."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(Replicate() if isinstance(p, Partial) else p for p in x.placements)
    x = x.redistribute(x.device_mesh, pl)
    return local_map(fn, out_placements=list(pl), in_placements=(list(pl),),
                     device_mesh=x.device_mesh)(x)
