"""Batched decode cores. Port of `repro/serve/batching.py`.

`SlotDecoder` owns `max_slots` per-slot decoder states: dense KV caches
sized for `max_len` positions, or a recurrent family's constant-size states.
Admission prefills one request at a time (B=1 prefill with cache headroom)
and copies its state into a free slot; every tick then runs ONE batched
decode step over all slots at each slot's own position, and copies the new
tokens to the host (one device round trip per tick, as the reference's
dense mode does).

`PagedSlotDecoder` is the paged, device-resident variant: the KV caches live
in a shared block pool (`serve/kv_pool.py`) addressed through the
scheduler's page table, and the decode loop is fused: `sync_interval`
decode+sample ticks run as ONE execution unit with tokens, positions and
done flags staying on the device throughout; the host sees a small
(slots, sync_interval + 2) summary once per interval instead of a device
round trip per token. With ``shared_prefix=True`` (the prefix cache) every
admission prefills only the prompt's uncached tail against prefix pages
gathered from the pool (`prefill_prefix`).

All computation is dispatched through the compute manager of a HiCR
`Runtime` (registry-built): prefill, the batched decode step, the slot pack,
the commit of a prefilled cache into pages and the fused interval are
execution units.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.runtime import Runtime
from repro_torch.models.model_zoo import ModelBundle

from .kv_pool import PagedKVPool

# control columns of the (slots, 6) device-resident table
TOK, POS, DONE, STEPS, EOS, CAP = range(6)

#: families whose decoder state is a set of KV caches (their deepest buffer
#: is the slot's position ceiling); the others' state is recurrent or mixed
#: (hybrid: `max_len`-deep caches beside O(1) recurrent states), and their
#: ceiling is `max_len`, as in the reference
KV_CACHE_FAMILIES = ("dense", "moe", "vlm")


def _leaves(tree):
    """The tensors of a state tree (lists, tuples and dicts), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [t for v in tree for t in _leaves(v)]


def _map_tree(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return type(tree)(_map_tree(fn, v) for v in tree)


class SlotDecoder:
    """Per-slot decode core (the reference's `SlotDecoder`).

    The slot states are the prefill's state tree with the batch axis widened
    to `max_slots`, allocated at the first admission from the prefill's
    shapes: for transformers one ``(max_slots, S_buf, KV, hd)`` tensor pair
    per layer (ring buffers of the window on local layers, `max_len` deep on
    global ones), written in place by each tick; for xlstm one dict of fp32
    recurrent states per block, replaced by each tick. The reference vmaps a
    B=1 decode over the slot axis; here the slot axis is the batch, with
    per-slot positions. Only MoE layers mix rows, through the experts'
    capacity: a batched step would let slots compete for it, where each of
    the reference's B=1 steps has a capacity of 8 >= k and never drops. The
    tick marks its batch ``per_slot``, and MoE layers then dispatch with no
    drop, the exact batched equivalent (`models/moe.py`). Tokens
    and positions live on the host (`last_tokens`, `pos`) and are uploaded
    every tick; values in slots without a live request are garbage that the
    caller ignores.
    """

    def __init__(
        self,
        model: ModelBundle,
        params,
        *,
        max_slots: int = 8,
        max_len: int = 256,
        runtime: Optional[Runtime] = None,
    ):
        self.model = model
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.rt = runtime or Runtime("torchdev")
        self.device: torch.device = self.rt.processing_unit.context
        emb = params["embed"]["embedding"]
        if emb.device != self.device:
            raise ValueError(f"params live on {emb.device}, the runtime on {self.device}")
        cm = self.rt.compute_manager
        prefill_fn = model.make_prefill(max_len)

        def prefill(p, b):
            # greedy pick fused into the unit: admission copies one int32 to
            # the host, not a logits row
            logits, state = prefill_fn(p, b)
            return torch.argmax(logits, dim=-1).to(torch.int32), state

        self._prefill_unit = cm.create_execution_unit(prefill, name="prefill")

        def batched_decode(p, states, tokens, pos):
            # states: per-layer slot states, batch axis max_slots; tokens and
            # pos (max_slots,): each slot decodes at its own position, as its
            # own request (per_slot: no MoE row competes with another slot's)
            logits, states = model.decode_step(
                p, states, {"tokens": tokens[:, None], "pos": pos, "per_slot": True})
            return torch.argmax(logits, dim=-1).to(torch.int32), states

        self._decode_unit = cm.create_execution_unit(batched_decode, name="batched_decode")

        def pack(bufs, state, slot):
            for buf, leaf in zip(_leaves(bufs), _leaves(state)):
                buf[slot] = leaf[0]
            return bufs

        self._pack_unit = cm.create_execution_unit(pack, name="pack_slot")

        self._states = None  # per-layer slot caches, sized from the first prefill
        self._cache_capacity: Optional[int] = None
        self.last_tokens = np.zeros((max_slots,), dtype=np.int32)
        self.pos = np.zeros((max_slots,), dtype=np.int32)

    @property
    def cache_capacity(self) -> int:
        """Cache positions a slot can actually hold, the scheduler's eviction
        ceiling: for KV caches the deepest allocated buffer (global layers;
        ring layers are shorter), for recurrent states `max_len`."""
        if self.model.cfg.family not in KV_CACHE_FAMILIES:
            return self.max_len
        if self._cache_capacity is None:
            if self._states is None:
                return self.max_len
            self._cache_capacity = max(k.shape[1] for k, _ in self._states)
        return self._cache_capacity

    # -- admission ----------------------------------------------------------
    def prefill(self, prompt: Sequence[int]):
        """B=1 prefill with max_len cache headroom. Returns (first greedy
        token, decoder state)."""
        tokens = torch.as_tensor(np.asarray(prompt, dtype=np.int32)[None, :], device=self.device)
        first, state = self.rt.run(self._prefill_unit, self.params, {"tokens": tokens})
        return int(first.cpu()[0]), state

    def load(self, slot: int, state, last_token: int, pos: int) -> None:
        """Copy a prefilled B=1 state into `slot` of the slot states."""
        if not 0 <= slot < self.max_slots:
            raise IndexError(f"slot {slot} out of range [0, {self.max_slots})")
        if self._states is None:
            self._states = _map_tree(
                lambda t: torch.zeros((self.max_slots,) + t.shape[1:], dtype=t.dtype,
                                      device=self.device), state)
        self._states = self.rt.run(self._pack_unit, self._states, state, slot)
        self.last_tokens[slot] = last_token
        self.pos[slot] = pos

    # -- one decode tick ----------------------------------------------------
    def step(self) -> np.ndarray:
        """Advance every slot one token. Returns the (max_slots,) array of
        new greedy tokens; values in slots without a live request are
        garbage and must be ignored by the caller."""
        if self._states is None:
            raise RuntimeError("no request was ever loaded into the decoder")
        new_tokens, self._states = self.rt.run(
            self._decode_unit, self.params, self._states,
            torch.as_tensor(self.last_tokens, device=self.device),
            torch.as_tensor(self.pos, device=self.device),
        )
        new_tokens = new_tokens.cpu().numpy()  # the tick's one device -> host copy
        self.last_tokens = new_tokens.copy()
        self.pos = self.pos + 1
        return new_tokens


class PagedSlotDecoder:
    """Paged, device-resident decode core.

    KV state lives in a shared block pool (one `(pages, page, KV, hd)`
    tensor pair per layer, allocated once and registered through the HiCR
    MemoryManager); each slot addresses its pages through the
    scheduler-owned page table. Decode control state — last tokens,
    positions, done flags, per-slot budgets, eos ids, position caps — stays
    on the device: `run_interval()` runs `sync_interval` fused decode+sample
    ticks as ONE execution unit and copies only the per-interval summary to
    the host. A slot that finishes mid-interval freezes in place (its writes
    go to the null page) and is harvested at the next sync point, so outputs
    are token-identical to a per-tick loop.
    """

    def __init__(
        self,
        model: ModelBundle,
        params,
        *,
        max_slots: int = 8,
        max_len: int = 256,
        page_size: int = 16,
        pool_pages: Optional[int] = None,
        sync_interval: int = 8,
        runtime: Optional[Runtime] = None,
        shared_prefix: bool = False,
    ):
        if model.paged_ops is None:
            raise ValueError(
                f"model family {model.cfg.family!r} has no paged KV-cache path; "
                "use kv_mode='dense'"
            )
        if sync_interval < 1:
            raise ValueError("sync_interval must be >= 1")
        if shared_prefix and model.paged_ops.prefix_prefill is None:
            raise ValueError(
                f"model family {model.cfg.family!r} has no prefix-prefill path; "
                "disable the prefix cache"
            )
        self.params = params
        self.max_slots = max_slots
        self.sync_interval = sync_interval
        self.shared_prefix = shared_prefix
        self.rt = runtime or Runtime("torchdev")
        #: device of the runtime's processing unit: pools, control table
        #: and every execution unit's tensors live here
        self.device: torch.device = self.rt.processing_unit.context
        emb = params["embed"]["embedding"]
        if emb.device != self.device:
            raise ValueError(f"params live on {emb.device}, the runtime on {self.device}")
        po = model.paged_ops
        self.layout = po.layout(
            max_slots=max_slots, max_len=max_len, page_size=page_size, num_pages=pool_pages,
            shared=shared_prefix,
        )
        self.kv = PagedKVPool(self.rt, model, self.layout, device=self.device)

        cm = self.rt.compute_manager
        layout = self.layout

        self._prefill_unit = None
        if not shared_prefix:  # shared admissions go through _prefix_unit
            prefill_fn = model.make_prefill(layout.cache_len)

            def paged_prefill(p, b):
                # greedy pick fused into the unit: admission copies one int32
                # to the host, not a logits row
                logits, state = prefill_fn(p, b)
                return torch.argmax(logits, dim=-1).to(torch.int32), state

            self._prefill_unit = cm.create_execution_unit(paged_prefill, name="paged_prefill")

        self._prefix_unit = None
        if shared_prefix:
            def prefix_prefill(p, pools, row, tokens, off):
                # greedy pick fused, as in paged_prefill
                logits, state = po.prefix_prefill(layout, p, pools, row, tokens, off)
                return torch.argmax(logits, dim=-1).to(torch.int32), state

            self._prefix_unit = cm.create_execution_unit(prefix_prefill, name="prefix_prefill")

        # per-slot ring rows are static: keep them on the device so an
        # admission never uploads them
        if layout.ring:
            ring_rows = layout.ring_table(device=self.device)
        else:
            ring_rows = torch.zeros((max_slots, 1), dtype=torch.int32, device=self.device)
        self._ring_rows = [ring_rows[s] for s in range(max_slots)]

        def commit_and_arm(pools, state, full_row, ring_row, ctl, slot, arm):
            """One dispatch per admission: scatter the prefilled dense cache
            into the slot's pages AND arm the slot's control row (in place).
            `arm` is [token, pos, 0, steps_left, eos, cap] — one upload."""
            pools = po.commit_prefill(layout, pools, state, full_row, ring_row)
            ctl[slot] = arm
            return pools, ctl

        self._commit_unit = cm.create_execution_unit(commit_and_arm, name="commit_and_arm")

        K = sync_interval

        def fused_ticks(p, pools, table, ctl):
            """K decode+sample ticks on the device, no host sync inside.
            Emits a (slots, K) buffer of sampled tokens (-1 where the slot
            was already done); freezes a slot the tick it hits eos, its
            budget or its position cap. Ticks after every slot finished run
            the model on frozen slots; their writes go to the null page and
            their tokens are masked, so the output is unchanged."""
            out = torch.full((ctl.shape[0], K), -1, dtype=torch.int32, device=ctl.device)
            for i in range(K):
                tokens, pos = ctl[:, TOK], ctl[:, POS]
                active = ctl[:, DONE] == 0
                logits, pools = po.decode_step(layout, p, pools, table, tokens, pos, active)
                new_tok = torch.argmax(logits, dim=-1).to(torch.int32)
                tok = torch.where(active, new_tok, tokens)
                out[:, i] = torch.where(active, tok, torch.full_like(tok, -1))
                live = active.to(torch.int32)
                steps_left = ctl[:, STEPS] - live
                pos = pos + live
                done = ~active | (
                    active & ((tok == ctl[:, EOS]) | (steps_left <= 0) | (pos >= ctl[:, CAP]))
                )
                ctl = torch.stack(
                    [tok, pos, done.to(torch.int32), steps_left, ctl[:, EOS], ctl[:, CAP]], dim=1,
                )
            # single host-transfer payload: [tokens x K | done | pos] per slot
            summary = torch.cat([out, ctl[:, [DONE, POS]]], dim=1)
            return pools, ctl, summary

        self._fused_unit = cm.create_execution_unit(fused_ticks, name=f"fused_decode_x{K}")

        # device-resident control table; DONE=1 everywhere: free slots never decode
        ctl0 = np.zeros((max_slots, 6), np.int32)
        ctl0[:, DONE] = 1
        ctl0[:, EOS] = -1  # -1: no eos (real tokens are >= 0)
        self.ctl = torch.as_tensor(ctl0, device=self.device)

    # -- admission ----------------------------------------------------------
    def prefill(self, prompt: Sequence[int]):
        """B=1 dense prefill with page-aligned cache headroom. Returns
        (first greedy token, dense decoder state to commit into pages)."""
        if self.shared_prefix:
            # the dense prefill shapes ring-local caches; a shared layout
            # commits full-depth caches: admissions must gather-prefill
            raise RuntimeError("shared-prefix decoder: use prefill_prefix()")
        tokens = torch.as_tensor(np.asarray(prompt, dtype=np.int32)[None, :], device=self.device)
        first, state = self.rt.run(self._prefill_unit, self.params, {"tokens": tokens})
        return int(first.cpu()[0]), state

    def prefill_prefix(self, tail: Sequence[int], gather_row: np.ndarray, offset: int):
        """Prefill only the uncached `tail` of a prompt against the shared
        prefix whose pages `gather_row` names (null-padded); `offset` is the
        matched prefix length in tokens (0 on a miss: the whole prompt is
        the tail). Returns (first greedy token, full-depth dense state ready
        to commit into pages)."""
        if self._prefix_unit is None:
            raise RuntimeError("decoder was built without shared_prefix=True")
        tokens = torch.as_tensor(np.asarray(tail, dtype=np.int32)[None, :], device=self.device)
        row = torch.as_tensor(np.asarray(gather_row, dtype=np.int32), device=self.device)
        first, state = self.rt.run(self._prefix_unit, self.params, self.kv.pools, row, tokens,
                                   int(offset))
        return int(first.cpu()[0]), state

    def load(
        self,
        slot: int,
        state,
        last_token: int,
        pos: int,
        *,
        steps_left: int,
        eos_id: Optional[int],
        capacity: int,
        full_row: np.ndarray,
    ) -> None:
        """Commit a prefilled dense state into `slot`'s pool pages and arm
        its device-side control row. `full_row` is the slot's page-table row
        (0-padded past the pages drawn so far); `capacity` is the position
        ceiling implied by the slot's page reservation."""
        if not 0 <= slot < self.max_slots:
            raise IndexError(f"slot {slot} out of range [0, {self.max_slots})")
        arm = np.asarray(
            [last_token, pos, 0, steps_left, eos_id if eos_id is not None else -1, capacity],
            dtype=np.int32,
        )
        self.kv.pools, self.ctl = self.rt.run(
            self._commit_unit, self.kv.pools, state,
            torch.as_tensor(np.asarray(full_row, np.int32), device=self.device),
            self._ring_rows[slot], self.ctl, slot, torch.as_tensor(arm, device=self.device),
        )

    # -- one fused interval --------------------------------------------------
    def run_interval(self, full_table: np.ndarray):
        """Run `sync_interval` fused ticks against the current page table.
        Returns (token_buffer (slots, K) with -1 for inactive ticks,
        done mask (slots,), positions (slots,)) as host arrays — the only
        device->host copy of the interval."""
        table = torch.as_tensor(np.asarray(full_table, np.int32), device=self.device)
        self.kv.pools, self.ctl, summary = self.rt.run(
            self._fused_unit, self.params, self.kv.pools, table, self.ctl,
        )
        summary = summary.cpu().numpy()
        K = self.sync_interval
        return summary[:, :K], summary[:, K].astype(bool), summary[:, K + 1]
