#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths -- full-width gemma3-1b served by the paged and by
the dense continuous-batching scheduler, by the serial engine and by the
paged scheduler with the prefix cache, the paper's Test Case 2
(heterogeneous inference), full-width xlstm-125m served by the dense
scheduler and the serial engine and through its forward/loss, full-width
zamba2-7b served by the dense scheduler and the serial engine, the dense
family (granite-20b, minitron-8b, stablelm-12b) at full width through the
paged scheduler, full-width gemma3-1b through the router/worker serving
fleet, the MoE family (grok-1-314b, kimi-k2-1t-a32b) at its published widths
with the depth cut through the paged and dense schedulers, and full-width
paligemma-3b and whisper-small through their model bundles, full-width
gemma3-1b and xlstm-125m trained through the launcher, and zamba2-7b (depth
cut), paligemma-3b and whisper-small trained through the train step, and
the port's examples through their own entry points (Test Case 2, the
channel serve demo at full-width gemma3-1b, the ~100M-parameter training
driver at its own widths) -- and fails (non-zero exit) if any phase fails. It imports
nothing of JAX or of the JAX package. Phases:

1. device: the card from `nvidia-smi` (name, power limit);
2. build: compile the CUDA kernels from `src/repro_torch/csrc` with nvcc for
   sm_90a (one nvcc per source, in parallel) and print the `-Xptxas -v`
   report (registers, shared memory, spills);
3. kernels: hold each CUDA kernel against its plain PyTorch version on the
   card at the paths' shapes and at ragged / edge shapes, and time kernel,
   plain version and the library call where one computes the same function
   (`F.scaled_dot_product_attention`, `torch.addmm`; none for the gated
   linear scan) with CUDA events, the profiler's device time (the library
   call's too) and, where a path finds its inputs cold, with the inputs
   cycled past the L2; each kernel's TFLOP/s on its device time. The
   kernels with variants (flash_attention: wgmma / tf32x3 / simt;
   fused_linear: wgmma / simt_small / simt_tiled / simt) must take the
   variant their rule names at every shape they cover (flash: the
   tensor-core wgmma at every bf16 shape it takes, tf32x3 at every aligned
   fp32 one: every supported head dim at groups of 1, 4, 6, 48 and 72, each
   mask, rows with no key, ragged S, its log-sum-exp within 1e-3 and the
   simt kernel held on the same operands; fused_linear: simt_small at Test
   Case 2's layers, timed beside simt on the same operands and addmm), the
   timed ones included; the two decode kernels
   (mma / simt) must take mma at their timed shape, are timed on one cache
   through both entry points (bitwise equal outputs), with the exact-FMA
   walk and with clusters of 16 for the record, and print their `-Xptxas
   -v` lines and cluster sizes; and the flash cases
   compared must cover both block layouts of the wgmma variant (one
   consumer warpgroup at a single prompt, two at the serial engine's
   8 x 512 prefill); fused_linear's fp32 products are also timed either
   side of the card's cut-over from simt to simt_tiled; the decode kernels
   are also held at 12 and 48 query heads per KV head (head groups); the
   scan (mma / step / simt) is held fused (y and the mLSTM normaliser in
   one launch) and unfused at every case, each case on the variant its rule
   names and the checked shapes covering the tensor-core variant's three
   tile widths, timed at every path shape against a bound built from the
   work itself, and its kernels' `-Xptxas -v` lines printed; zamba2-7b's
   shapes: flash at head_dim 112 (and 160, G=4; and 80,
   `examples/train_100m_torch.py`'s, in fp32 on tf32x3, bf16 on wgmma, and
   ragged) and the decode core at 32 heads of 112 (simt, mma beside it), both beside
   SDPA, the scan at
   Mamba2's tick and ragged prefill with the operands laid out as
   `mamba_forward` makes them; the paged kernel with window 512 through the
   full table (the prefix cache's local layers); the dense family's shapes:
   flash at granite-20b's prefill (48 query heads over 1, hd 128),
   minitron-8b's (32 over 8) and stablelm-12b's (hd 160), all wgmma, the
   decode core's mma walk at stablelm-12b's tick (hd 160, dense and paged)
   and the paged kernel at granite-20b's tick (six head groups: mma), the
   mma walk beside the simt walk on the same operands, each held against
   its plain version and timed warm and with its inputs cold in L2 (flash
   and the dense decode beside SDPA); the remaining families' shapes: flash
   at paligemma-3b's prefix-LM prefill (B=8, 256 + 32 positions, wgmma, SDPA
   with the same boolean mask), whisper-small's bidirectional encoder
   (1500 frames) and cross-attention (Sq = 16 and 1 against 1500 keys, a
   ragged last key tile), grok-1's prefill (48 over 8, hd 128) and kimi-k2's
   (64 over 8, hd 112), both wgmma; at zamba2's, stablelm's, granite's,
   grok's and kimi's prefills flash's simt kernel is timed too on the same
   operands (`_fwd_simt`), and wgmma must beat it; the decode core at
   grok's dense
   tick, paligemma's and whisper's ticks (mma) and the paged kernel at
   grok's and kimi's ticks (mma, beside simt on the same operands); the
   mma walk at hd 80 / 112 / 160, G = 1, 4 and 8, with and without a
   window, paged bitwise equal to dense on one cache; and rows that are not whole
   16-byte loads (fp32 hd 18, bf16 hd 36: element loads on the simt walk),
   dense and paged; the flash backward kernel (`flash_attention_bwd`)
   against `ref.attention_backward` at gemma3-1b's training shape (B=4,
   S=1024, 4 query heads over 1 at hd 256, bf16, a global and a local
   layer), a group of 4 at hd 128, hd 112 and 160, a prefix-LM mask, fp32
   at every head dim and rows with no key (max |d| / max |plain| within
   2e-2 bf16, 2e-5 fp32 on tf32x3, the same bits twice; the forward's
   log-sum-exp within 1e-3), each case on the variant `backward_variant`
   names (wgmma: bf16 at hd 64 / 80 / 112 / 128 / 160 / 256 with at most 64
   query heads per KV head; tf32x3: fp32; simt: the rest), with
   granite-20b's G = 48 and grok-1's G = 6 at B=1 x 1024, zamba2-7b's
   training shape (B=2 x 1024, 32 over 32, hd 112), whisper-small's
   encoder (1500 frames) and cross-attention (64 against 1500 keys) and
   bf16 rows with no key among them, and `examples/train_100m_torch.py`'s
   shape (B=4, S=256, 8 query heads over 2 at hd 80, fp32, a global and a
   local layer: `tf32x3`, forward and backward each timed twice beside
   `simt` on the same operands, SDPA (TF32 off) and cold, with the bound
   both ways; bf16 on wgmma, and ragged S = 257 too); at
   gemma3-1b's training shape, hd 112, hd 160 G=4, G=48, G=6 and zamba2-7b's
   training shape the wgmma variant timed warm (twice) and cold beside the
   simt variant on the same operands (which it must beat), its plain version
   and SDPA's backward, all in one call; the
   scan's backward kernel (`gated_linear_scan_bwd`) against
   `ref.gated_linear_scan_backward` (max |d| / max |plain| of dq, dk, dv,
   dlog_a and the initial states' gradients within 2e-2 bf16, 1e-4 fp32) at
   xlstm-125m's training shape (B=4, H=4, S=2048, dk=dv=384, bf16, the
   normaliser), Mamba2's at zamba2-7b's widths (B=2, H=32, S=1024, dk 64, dv
   224, q broadcast over the heads), carried states with final-state
   gradients at S = 777 and 45, chunk and tile edges (S = 33 and 2048 + 17
   at xlstm's widths, Mamba2 at dv 200) and fp32 (REDUCED and xlstm's
   widths), each case on the variant `backward_variant` names (mma: bf16
   with 16-byte rows, dk <= 384, at most 8 column tiles; simt: the rest),
   and at the two training shapes the mma variant timed warm and cold
   beside the simt variant on the same operands and the plain version;
4. reduced: REDUCED gemma3-1b in fp32 (TF32 off): prefill plus 16
   teacher-forced paged decode ticks on the card against the same functions
   on the CPU (here and in every REDUCED fp32 phase below, the card run's
   flash forward launches are logged by variant and must all be on
   `tf32x3`);
5. serve: full gemma3-1b (26 layers, d_model 1152, vocab 262144, bf16) serves
   16 synthetic requests (prompts 64-1024 tokens, 16-64 new tokens) on 8
   slots through `ContinuousBatchingScheduler.serve()` with the paged KV
   pool; the kernels' launch counts are read around that run and must be
   exactly what the path needs, every flash launch on the wgmma variant and
   every decode launch on mma (phases 7 and 8 likewise);
6. reduced-dense: REDUCED fp32 on the card against the CPU through the dense
   decode: 16 teacher-forced ticks (logits within 1e-4), a dense continuous
   serve and a serial `generate` (equal tokens);
7. serve-dense: the same 16 requests through the dense scheduler
   (``kv_mode="dense"``, `max_len` 1088), launch counts exact, tokens
   compared with phase 5's (reported, not required: bf16);
8. serial: `ServeEngine.generate` on 8 prompts of 512 tokens for 32 steps
   (its flash launches on the wgmma variant);
9. tc2: the paper's Test Case 2, all three rows (``numpy`` on the port's
   `hostcpu` backend, ``torch`` and ``fused_linear`` on the card): equal
   accuracy above 0.85, img-0 scores within 1e-4, `fused_linear` launched
   twice per batch, every launch on the fp32 `simt_small` variant;
10. reduced-xlstm: REDUCED xlstm-125m in fp32 on the card against the CPU:
   forward logits and loss, prefill plus 16 teacher-forced ticks carrying
   the recurrent states (within 1e-4), a dense continuous serve and a serial
   `generate` (equal tokens);
11. serve-xlstm: full xlstm-125m (12 blocks, 9 mLSTM + 3 sLSTM, d_model 768,
   vocab 50304, bf16) serves phase 5's 16 requests on 8 slots through the
   dense scheduler, then `ServeEngine.generate` on 8 prompts of 512 tokens
   for 32 steps; the scan kernel must launch exactly once per mLSTM block
   per prefill and per tick (y and the normaliser in one launch: prefills
   on its tensor-core variant, ticks on its step variant), and no other
   kernel;
12. loss-xlstm: full-width `ModelBundle.loss` on 4 x 2048 seeded tokens:
   finite, near ln(vocab) for random weights, exactly 9 scan launches (one
   per mLSTM block), all on the tensor-core variant;
13. reduced-prefix: REDUCED gemma3-1b in fp32 with the prefix cache
   (shared system prompts served one by one, a resumed conversation): the
   same tokens with the cache on and off and on the card and the CPU, equal
   cache stats, hits, every page back (used = cached after the drain, 0
   after `reset`);
14. serve-prefix: full gemma3-1b paged with the prefix cache (the shared
   layout: local layers through the full table, the window a mask):
   16 requests of `shared_prefix_requests` (a 512-token system prompt
   shared by 75 %) after a warm request pinning it, with the cache and
   without, then 4 conversations x 3 turns resumed with `resume_prompt`;
   tok/s, TTFT split by shared (-s) and unique (-u), token hit rate (> 0),
   pages back, agreement with the cache-off tokens (reported: bf16);
15. reduced-zamba2: REDUCED zamba2-7b in fp32 on the card against the CPU:
   prefill plus 16 teacher-forced ticks (within 1e-4), a dense serve and a
   serial `generate` (equal tokens);
16. serve-zamba2: full zamba2-7b (81 Mamba2 layers, the shared attention
   block after every 6, d_model 3584, 32 heads of 112, bf16, seeded) serves
   phase 5's 16 requests through the dense scheduler (max_len 1088), then
   the serial engine (8 x 512, 32 steps): flash on wgmma and the decode
   kernel on its simt walk (hd 112, one query head a KV head) once per
   group, the scan once per layer
   (prefills `mma`, ticks `step`), peak memory;
17. reduced-dense-family: granite-20b, minitron-8b and stablelm-12b REDUCED
   in fp32 on the card against the CPU: prefill plus 16 teacher-forced
   dense ticks (within 1e-4), a paged serve and a serial `generate` (equal
   tokens, every page back);
18. serve-dense-family: each of the three at full width (bf16, seeded,
   depth not cut; granite 20.3 G parameters) serves phase 5's 16 requests
   on 8 slots through the paged scheduler, stablelm also the serial engine
   on 4 of them; tok/s, TTFT, peak memory; flash and the decode kernels on
   the variants their rules name (flash wgmma for all three: granite's 48
   query heads a KV head in 48-row tiles, stablelm's hd 160 in 192-column
   tiles; paged decode mma in 6 head groups for granite, mma for minitron
   and at hd 160 for stablelm); each config's weights freed before the next;
19. conformance: the `torchdev` manager contracts on the card (execute's
   Future resolves and carries errors, memcpy Events land host to device,
   device to device and device to host, alloc / register / free);
20. reduced-fleet: REDUCED fp32 gemma3-1b through the router and two
   runtime-created worker instances (threads) on the card: the tokens of a
   single-instance scheduler on the card and on the CPU, also with a worker
   killed mid-stream (its requests requeued), every surviving pool back;
21. serve-fleet: full gemma3-1b through 2 workers x 4 slots (paged) on
   phase 5's requests: tok/s beside phase 5's, TTFT at the router, peak
   memory, both workers settle work, exact launch counts; then a
   kill-and-respawn on one worker, two runs in turns with two plain ones,
   must not raise the card's peak memory by a pool;
22. apps: the paper's Test Cases 3 and 4 (Fibonacci, Jacobi local and over
   2 localsim instances) on the machine's host against their oracles;
23. reduced-moe: grok-1 and kimi-k2 REDUCED in fp32 on the card against the
   CPU: prefill plus 16 teacher-forced dense ticks (within 1e-4), the dense
   and the paged serve and a serial `generate` (equal tokens);
24. serve-moe: grok-1 (8 of its 64 layers) and kimi-k2 (1 of 61) at their
   published widths (bf16, seeded; grok 28.1 G parameters, kimi 19.4 G: 384
   experts of d_ff 2048) serve phase 5's 16 requests on 8 slots through the
   paged scheduler, grok also through the dense one (whose ticks keep the
   reference's per-slot capacity: no row dropped); tok/s, TTFT, peak memory,
   rows dropped by capacity, exact launches on the variants the rules name
   (flash wgmma for both; paged mma for both, kimi's at hd 112);
25. reduced-vlm: REDUCED paligemma-3b in fp32 through its bundle on the card
   against the CPU: prefill logits within 1e-4, 16 greedy tokens equal;
26. generate-paligemma: the full 18-layer paligemma-3b (bf16, seeded), 8
   requests of 256 seeded patch embeddings (width 1152) and 32 prompt
   tokens, 64 greedy tokens each through the bundle: prefix-LM flash
   (wgmma), decode mma;
27. reduced-whisper: REDUCED whisper-small as phase 25, with frames;
28. generate-whisper: the full whisper-small (12 + 12 layers), 8 requests of
   1500 seeded frames (x 0.02) and 16 prompt tokens, 128 greedy tokens each:
   the bidirectional encoder and every cross-attention (Sq = 16, then 1 a
   step, against 1500 keys) on flash wgmma, self-attention decode on mma;
29. reduced-train: one AdamW step of REDUCED gemma3-1b in fp32 on the card
   against the CPU (metrics within rtol 1e-5, gradients rtol 1e-4 / atol
   1e-6, updated parameters rtol 1e-4 / atol 1e-5), every attention's
   forward and backward on the kernels (the forward twice: `remat_policy`
   "minimal" recomputes it in the backward; every backward on tf32x3);
30. train: full-width gemma3-1b (fp32 masters, bf16 compute, AdamW), B=4 x
   S=1024, 6 steps through `launch/train.py`: finite losses, every
   parameter's step-1 gradient finite and non-zero, the step-0 loss within
   1e-2 relative of the plain attention's, 52 flash forward (26 and their
   recompute) and 26 backward launches a step, all on wgmma; ms a step,
   training tok/s, peak memory; then one traced step (device time by kernel
   group, idle share, the backward's share);
31. train-resume: REDUCED gemma3-1b on the card through the launcher, 4
   steps against 2, a checkpoint and a resumed launch of 2 more (rtol 1e-6,
   atol 1e-7);
32. reduced-train-families: one AdamW step of every family REDUCED in fp32
   on the card against the CPU (29's tolerances; xlstm's and zamba2's
   gradients max |d| / max |cpu| <= 1e-4 per leaf), every attention and
   scan forward and backward on the kernels (flash's backward on tf32x3);
33. train-xlstm: full-width xlstm-125m, B=4 x S=2048, 6 steps through the
   launcher: 29's and 30's checks (the step-0 loss against the plain scan's),
   9 scan forward and 9 backward launches a step, all on `mma`; ms a step,
   training tok/s, peak memory, the sLSTM blocks' share of a step, one step
   traced on the device (idle share, top kernels, the scan backward's share);
34. train-zamba2: zamba2-7b at its published widths, depth cut to 13 layers
   (two groups of 6 and a tail layer), B=2 x S=1024, 4 steps: the same
   checks, flash `wgmma` forward and backward at hd 112 once per group (the
   forward twice under "minimal"), the scan per layer (forward and backward
   on `mma`); parameters and bytes, flash's and the scan backward's shares
   of a traced step;
35. train-bundles: full-width paligemma-3b (256 patch embeddings + 256
   tokens) and whisper-small (1500 frames x 0.02 + 448 tokens), B=2, 3 steps
   on `make_batch` batches: the same checks, every flash launch on wgmma;
36. spmd: an NCCL world of 1 from the environment (127.0.0.1, a free port;
   no fallback) and a (1, 1) ("data", "model") mesh on the card: the `spmd`
   communication manager's five collectives return their input exactly, as
   world size 1 implies; `reshard` Replicate -> Shard -> Replicate with its
   fence; `mesh_from_topology` over `torchdev`'s topology gives the same
   mesh;
37. train-spmd: full-width gemma3-1b, B=4 x S=1024, 3 steps through the
   launcher's SPMD route (`--mesh 1x1`: topology -> mesh -> spmd compute
   manager, DTensors placed by the sharding plan, the kernels reached
   through `local_map`): losses within 1e-3 relative of `train`'s, 30's
   flash forward and backward launches a step all on wgmma, ms a step beside
   `train`'s;
38. example-hetero: `examples/heterogeneous_inference_torch.py`'s three
   rows through its `run` on the card: phase 9's checks (equal accuracy
   above 0.85, img-0 scores within 1e-4, `fused_linear` twice a batch, on
   `simt_small`);
39. example-serve-demo: `examples/serve_demo_torch.py`'s two acts (two
   clients and a channel server over localsim; a router and two workers
   created at run time) at REDUCED fp32 on the card, token for token equal
   to the same functions on the CPU; then both acts at full-width
   gemma3-1b: every request completes with its token count, flash
   launches exact (a prefill a request a layer) on wgmma, decode launches
   exact (a tick a layer) on mma;
40. example-train-100m: `examples/train_100m_torch.py` at its own widths
   (75.2 M parameters, 8 query heads over 2 at hd 80, fp32) and CLI
   defaults (30 steps, B=4 x 256, a checkpoint at 25) through its `train`
   (the spmd compute manager over an NCCL world of one that it starts and
   destroys): finite, falling losses, `expected_train_launches` flash
   forward and backward launches a step (both tf32x3), ms a step, training
   tok/s, peak memory; a second run resumes at 25 and its step-30 loss
   equals the first's within 1e-5 relative (bit equality reported). The
   flash forward and backward at its shape are timed in phase 3 beside the
   plain version and SDPA.

The bound constants (peak rates, L2) come from
`src/repro_torch/backends/gpu_spec.py`.

Each path's launch counts are zeroed just before it runs and read just
after. The line before the last is one JSON object with every kernel's
numbers (its launches summed over the paths, and by path); the last line is
the device JSON. Needs one card; the first run on a fresh checkout builds the
kernels.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
import weakref

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate and the rate of
# each input type's arithmetic (bf16 on the tensor cores, fp32 on CUDA
# cores), and the L2 cache (inputs cycled past twice it are read cold). Set
# by `_load_spec` from `repro_torch/backends/gpu_spec.py`, their one source.
PEAK_BYTES_PER_S: float = 0.0
PEAK_FLOPS: dict = {}
L2_BYTES: int = 0
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
LINEAR_TOL = TOL  # tests/test_kernels.py::TestFusedLinear: 2e-5 fp32; 2e-2 bf16
PAGED_TOL = {"float32": dict(atol=1e-5, rtol=0.0), "bfloat16": dict(atol=5e-2, rtol=0.0)}
REDUCED_ATOL = 1e-4


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def run_phase(name: str, fn, *args):
    """Run one phase and log its wall time (the script has a time limit)."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] {name}: {time.perf_counter() - t0:.1f}s")
    return out


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device(torch) -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    require(out.returncode == 0, f"nvidia-smi failed: {out.stdout}")
    card = out.stdout.strip().splitlines()[0]
    log(card)  # name, power limit: as nvidia-smi gives them
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load(verbose=True)
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f}s")
    for line in build.build_log().splitlines():
        if line.strip():
            log(f"[build] {line}")


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one call of `fn`: the summed durations of the device
    activities (kernels, copies, fills) a `torch.profiler` trace of `iters`
    warmed-up calls records, over `iters`. Unlike `time_ms` it excludes the
    host's launch gaps, so it tells a host-bound timing from a device-bound
    one. A trace that recorded no device activity at all is taken again, at
    most five times in all: now and then a trace of calls that did run on
    the card comes back without its device records."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(5):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            return sum(spans) / 1e3 / iters
        log("[kernels] a profiler trace recorded no device activity; tracing again")
    raise PhaseError("the profiler recorded no device activity in five traces")


def cold_device_ms(torch, fn, inputs, nbytes: int) -> float:
    """Device time of `fn(*inputs)` with its inputs cold in L2, as a serving
    path finds a layer's cache after the other layers ran: the inputs are
    cloned until the copies hold more than twice the L2 and each call takes
    the next copy. `nbytes` is the bytes of one copy."""
    copies = [tuple(t.clone() for t in inputs) for _ in range(2 * L2_BYTES // nbytes + 2)]
    turn = iter(range(1 << 30))
    return device_ms(torch, lambda: fn(*copies[next(turn) % len(copies)]),
                     iters=2 * len(copies))


def launched_variant(module, fn):
    """Call `fn` and return the variant of `module`'s kernel it launched
    (exactly one launch)."""
    before = dict(module.variant_launches)
    fn()
    ran = [k for k, n in module.variant_launches.items() if n != before[k]]
    require(len(ran) == 1 and module.variant_launches[ran[0]] == before[ran[0]] + 1,
            f"expected one launch, variants moved: {ran}")
    return ran[0]


def require_variant(variants, kernel: str, want: str, n: int, what: str) -> None:
    """All `n` launches of `kernel` counted in `variants` (`ops.variant_counts`)
    took variant `want`."""
    got = variants[kernel]
    require(got[want] == n and sum(got.values()) == n,
            f"{what}: {kernel} launches by variant {got}, expected all {n} on {want}")


def require_fp32_flash(tag: str) -> None:
    """The flash forward launches counted since the counts were last zeroed
    (a REDUCED fp32 phase's run on the card): logged by variant, and every
    one required on `tf32x3`, the rule's variant for aligned fp32 operands."""
    from repro_torch.kernels import ops

    got = ops.variant_counts()["flash_attention"]
    if sum(got.values()):
        log(f"[{tag}] flash forward launches by variant {got}")
    require(got["tf32x3"] == sum(got.values()),
            f"{tag}: flash forward launches by variant {got}, expected all on tf32x3")


def _max_err_and_ok(torch, got, want, tol) -> tuple:
    got32, want32 = got.float(), want.float()
    diff = (got32 - want32).abs()
    ok = bool(torch.all(diff <= tol["atol"] + tol["rtol"] * want32.abs()).item())
    ok = ok and bool(torch.isfinite(got32).all().item())
    return float(diff.max().item()), ok


def _flash_case(torch, gen, *, Sq, Skv, H, KV, hd, dtype, B=1, causal=True, window=0,
                prefix_len=0, q_offset=0, unaligned_q=False):
    """Seeded q, k, v (q one element into a larger buffer with
    `unaligned_q`: off 16 bytes), the kernel's output and the plain one."""
    from repro_torch.kernels import flash_attention, ref

    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
    if unaligned_q:
        q = torch.cat([q.new_zeros(1), q.flatten()])[1:].view(q.shape)
    k = torch.randn((B, Skv, KV, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KV, hd), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len, q_offset=q_offset)
    got = flash_attention.flash_attention(q, k, v, **kw)
    want = ref.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    return (q, k, v, kw), got, want


def _flash_kind(dtype_name: str, case: dict) -> str:
    """The forward variant flash's rule gives a case's operands: `wgmma`
    (`_tensor_core_case`), `tf32x3` for fp32 (16-byte aligned, as fresh
    tensors are unless the case asks for an unaligned q), `simt` for the
    rest."""
    if _tensor_core_case(dtype_name, case):
        return "wgmma"
    return "tf32x3" if dtype_name == "float32" and not case.get("unaligned_q") else "simt"


#: masks of the tf32x3 forward's cases, in turn over the head dims and
#: groups: causal, a window, a prefix-LM, a q_offset (Skv > Sq), rows with no
#: key (a window past the last key), bidirectional with Skv < Sq
TF32X3_MASKS = (dict(B=2, Sq=77, Skv=77), dict(Sq=100, Skv=100, window=16),
                dict(Sq=90, Skv=90, prefix_len=30), dict(Sq=50, Skv=90, q_offset=40),
                dict(Sq=50, Skv=20, window=8), dict(Sq=60, Skv=41, causal=False))


def _tensor_core_case(dtype_name: str, case: dict) -> bool:
    """Whether flash's rule gives a case's operands the `wgmma` variants
    (forward and backward): bf16 at a head_dim of whole or padded 64-column
    tiles, at most 64 query heads a KV head, 16-byte aligned (as fresh
    tensors are, unless the case asks for an unaligned q)."""
    from repro_torch.kernels import flash_attention

    return (dtype_name == "bfloat16" and case["hd"] in flash_attention.WGMMA_HEAD_DIMS
            and case["H"] // case["KV"] <= flash_attention.WGMMA_ROWS
            and not case.get("unaligned_q"))


def check_flash(torch, gen) -> dict:
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.ref import _build_mask

    cases = []
    for Sq in (37, 300, 1024):
        for window in (0, 512):
            for dtype in (torch.float32, torch.bfloat16):
                cases.append(dict(Sq=Sq, Skv=Sq, H=4, KV=1, hd=256, dtype=dtype, window=window))
    cases += [
        dict(Sq=300, Skv=300, H=4, KV=1, hd=256, dtype=torch.bfloat16, prefix_len=100),
        dict(Sq=300, Skv=300, H=4, KV=1, hd=256, dtype=torch.float32, prefix_len=100, window=64),
        dict(Sq=64, Skv=300, H=4, KV=1, hd=256, dtype=torch.float32, q_offset=236),
        dict(Sq=64, Skv=300, H=4, KV=1, hd=256, dtype=torch.bfloat16, q_offset=236, window=100),
        dict(Sq=45, Skv=45, H=4, KV=1, hd=16, dtype=torch.float32, window=16),  # REDUCED widths
        dict(Sq=200, Skv=200, H=8, KV=2, hd=128, dtype=torch.bfloat16),  # GQA 4:1
        dict(Sq=77, Skv=130, H=4, KV=4, hd=64, dtype=torch.float32, causal=False),
        dict(Sq=50, Skv=20, H=2, KV=1, hd=32, dtype=torch.float32, window=8),  # rows with no key
    ]
    # the tensor-core variant at the other head dims and group sizes it takes
    for hd in (64, 128):
        cases += [dict(Sq=Sq, Skv=Sq, H=4, KV=1, hd=hd, dtype=torch.bfloat16, window=w)
                  for Sq, w in ((37, 0), (777, 512), (1024, 0))]
    cases += [
        dict(Sq=300, Skv=300, H=8, KV=2, hd=256, dtype=torch.bfloat16, window=64),  # GQA 8:2
        dict(Sq=130, Skv=77, H=4, KV=4, hd=128, dtype=torch.bfloat16, causal=False),
        dict(Sq=50, Skv=20, H=2, KV=1, hd=64, dtype=torch.bfloat16, window=8),  # rows with no key
        dict(Sq=64, Skv=300, H=4, KV=1, hd=128, dtype=torch.bfloat16, q_offset=236, prefix_len=250),
    ]
    # head dims between the powers of two (wgmma in bf16, tiles padded to
    # 128 / 192 columns; tf32x3 in fp32): zamba2-7b's shared block (32 heads
    # over 32, head_dim 112) at its prefill shape and ragged; stablelm-12b's
    # head_dim 160 with 4 query heads a KV head
    cases += [
        dict(Sq=1024, Skv=1024, H=32, KV=32, hd=112, dtype=torch.bfloat16),
        dict(Sq=777, Skv=777, H=32, KV=32, hd=112, dtype=torch.float32),
        dict(B=2, Sq=77, Skv=77, H=32, KV=32, hd=112, dtype=torch.bfloat16),
        dict(Sq=1024, Skv=1024, H=32, KV=8, hd=160, dtype=torch.bfloat16),
        dict(Sq=300, Skv=300, H=8, KV=2, hd=160, dtype=torch.float32, window=64),
    ]
    # the dense family's prefills: granite-20b's 48 query heads over 1 KV head
    # (hd 128, a group that does not divide 64: one position, 48 of a
    # warpgroup's 64 rows), minitron-8b's 32 over 8 (hd 128), stablelm-12b's
    # 32 over 8 at hd 160, at a full prompt and ragged; bf16 on wgmma
    cases += [
        dict(Sq=1024, Skv=1024, H=48, KV=1, hd=128, dtype=torch.bfloat16),
        dict(Sq=300, Skv=300, H=48, KV=1, hd=128, dtype=torch.float32),
        dict(B=2, Sq=77, Skv=77, H=48, KV=1, hd=128, dtype=torch.bfloat16),
        dict(Sq=1024, Skv=1024, H=32, KV=8, hd=128, dtype=torch.bfloat16),
        dict(Sq=777, Skv=777, H=32, KV=8, hd=128, dtype=torch.bfloat16),
        dict(Sq=777, Skv=777, H=32, KV=8, hd=160, dtype=torch.bfloat16),
    ]
    # the remaining families: paligemma-3b's prefix-LM prefill (8 over 1, hd
    # 256, 256 bidirectional vision positions before a causal prompt: wgmma),
    # whisper-small's bidirectional encoder over 1500 frames and its
    # cross-attention (Sq = 16 or 1 against Skv = 1500, not a whole number of
    # key tiles: the tail tile masked), 12 heads over 12 at hd 64 (wgmma);
    # grok-1's 48 over 8 at hd 128 (a group of 6: 10 positions, 60 rows) and
    # kimi-k2's 64 over 8 at hd 112 (wgmma in bf16); each ragged and in fp32
    # too
    cases += [
        dict(B=2, Sq=288, Skv=288, H=8, KV=1, hd=256, dtype=torch.bfloat16, prefix_len=256),
        dict(Sq=261, Skv=261, H=8, KV=1, hd=256, dtype=torch.float32, prefix_len=256),
        dict(B=2, Sq=1500, Skv=1500, H=12, KV=12, hd=64, dtype=torch.bfloat16, causal=False),
        dict(Sq=1500, Skv=1500, H=12, KV=12, hd=64, dtype=torch.float32, causal=False),
        dict(B=2, Sq=16, Skv=1500, H=12, KV=12, hd=64, dtype=torch.bfloat16, causal=False),
        dict(B=8, Sq=1, Skv=1500, H=12, KV=12, hd=64, dtype=torch.bfloat16, causal=False),
        dict(B=3, Sq=1, Skv=1500, H=12, KV=12, hd=64, dtype=torch.float32, causal=False),
        dict(Sq=300, Skv=300, H=48, KV=8, hd=128, dtype=torch.bfloat16),
        dict(Sq=300, Skv=300, H=48, KV=8, hd=128, dtype=torch.float32),
        dict(Sq=300, Skv=300, H=64, KV=8, hd=112, dtype=torch.bfloat16),
        dict(Sq=77, Skv=77, H=64, KV=8, hd=112, dtype=torch.float32),
    ]
    # examples/train_100m_torch.py's attention (8 query heads over 2 at head_dim
    # 80, fp32, B=4 x 256, causal; its local layers' window 256: tf32x3), in
    # bf16 (wgmma, tiles padded to 128 columns) and at a ragged length
    cases += [
        dict(B=4, Sq=256, Skv=256, H=8, KV=2, hd=80, dtype=torch.float32),
        dict(B=4, Sq=256, Skv=256, H=8, KV=2, hd=80, dtype=torch.float32, window=256),
        dict(B=4, Sq=256, Skv=256, H=8, KV=2, hd=80, dtype=torch.bfloat16),
        dict(B=2, Sq=257, Skv=257, H=8, KV=2, hd=80, dtype=torch.float32, window=64),
        dict(B=2, Sq=257, Skv=257, H=8, KV=2, hd=80, dtype=torch.bfloat16),
    ]
    # groups that do not divide 64 with padded head dims, rows with no key,
    # a prefix-LM mask over a q_offset, Skv < Sq bidirectional, and more
    # query heads a KV head than a warpgroup's 64 rows (simt)
    cases += [
        dict(B=2, Sq=257, Skv=257, H=6, KV=1, hd=80, dtype=torch.bfloat16),
        dict(Sq=130, Skv=77, H=6, KV=1, hd=112, dtype=torch.bfloat16, causal=False),
        dict(Sq=64, Skv=300, H=48, KV=8, hd=128, dtype=torch.bfloat16, q_offset=236,
             prefix_len=250),
        dict(Sq=50, Skv=20, H=6, KV=1, hd=160, dtype=torch.bfloat16, window=8),
        dict(B=8, Sq=512, Skv=512, H=48, KV=8, hd=128, dtype=torch.bfloat16),
        dict(B=3, Sq=100, Skv=100, H=96, KV=1, hd=128, dtype=torch.bfloat16),
    ]
    # fp32 on tf32x3 at every head dim and at groups of 1, 4, 6, 48 and 72
    # (more query heads a KV head than a block's 64 rows), the masks in turn
    for i, (hd, G) in enumerate((hd, G) for hd in flash_attention.SUPPORTED_HEAD_DIMS
                                for G in (1, 4, 6, 48, 72)):
        cases.append(dict(TF32X3_MASKS[i % len(TF32X3_MASKS)], H=G, KV=1, hd=hd,
                          dtype=torch.float32))
    cases += [dict(B=2, Sq=77, Skv=77, H=8, KV=2, hd=80, dtype=torch.float32, unaligned_q=True),
              dict(Sq=50, Skv=20, H=4, KV=1, hd=16, dtype=torch.float32, window=8,
                   unaligned_q=True)]
    # the serial engine's prefill, 8 prompts of 512 tokens: a grid over a wave,
    # so two consumer warpgroups a block
    serial = [dict(B=8, Sq=512, Skv=512, H=4, KV=1, hd=256, dtype=torch.bfloat16, window=w)
              for w in (0, 512)]
    worst, worst_tol = 0.0, None
    consumers_seen, kinds_seen = set(), set()
    for case in cases + serial:
        before = dict(flash_attention.variant_launches)
        (q, k, v, kw), got, want = _flash_case(torch, gen, **case)
        kind = [n for n, c in flash_attention.variant_launches.items() if c != before[n]]
        name = str(case["dtype"]).split(".")[-1]
        err, ok = _max_err_and_ok(torch, got, want, TOL[name])
        desc = ", ".join(f"{k}={v}" for k, v in case.items() if k != "dtype")
        want_kind = _flash_kind(name, case)
        kinds_seen.add(want_kind)
        layout = kind[0]
        if kind == ["wgmma"]:
            consumers = flash_attention.consumer_warpgroups(q, k)
            consumers_seen.add(consumers)
            layout = f"wgmma, {consumers} consumer warpgroup{'s' if consumers > 1 else ''}"
        extra = ""
        if want_kind == "tf32x3":
            # its log-sum-exp (rows with a key), and the simt kernel on the
            # same operands (the C entry point's code 0), as fp32 ran before
            _, lse = flash_attention.flash_attention_with_lse(q, k, v, **kw)
            _, lse_plain = ref.attention_with_lse(q, k, v, **kw)
            live = lse_plain > -1e29
            lse_err = float((lse - lse_plain)[live].abs().max()) if live.any() else 0.0
            simt_err, simt_ok = _max_err_and_ok(torch, _fwd_simt(torch, q, k, v, **kw), want,
                                                TOL[name])
            extra = f"; lse max err {lse_err:.3e}, simt on the same operands {simt_err:.3e}"
            ok = ok and lse_err <= LSE_ATOL and simt_ok
        log(f"[kernels] flash_attention {name} {desc} ({layout}): max_abs_err={err:.3e} "
            f"tol={TOL[name]}{extra} {'ok' if ok else 'FAIL'}")
        require(ok, f"flash_attention disagrees with its plain version ({desc}, {name})")
        require(kind == [want_kind], f"flash_attention ({desc}, {name}) ran {kind}")
        if case in serial:
            require(consumers == 2, f"flash_attention ({desc}) ran {consumers} consumer "
                    f"warpgroups a block, expected 2")
        if err > worst:
            worst, worst_tol = err, TOL[name]
    require(consumers_seen == {1, 2},
            f"the compared wgmma cases ran {sorted(consumers_seen)} consumer warpgroups a block")
    require(kinds_seen == {"wgmma", "tf32x3", "simt"}, f"the cases ran {sorted(kinds_seen)}")

    # timing at the serving path's heaviest prefill: a 1024-token prompt
    # through a global layer (causal, no window), bf16
    Sq, H, KV, hd = 1024, 4, 1, 256
    (q, k, v, kw), got, want = _flash_case(
        torch, gen, Sq=Sq, Skv=Sq, H=H, KV=KV, hd=hd, dtype=torch.bfloat16)
    kind = launched_variant(flash_attention,
                            lambda: flash_attention.flash_attention(q, k, v, **kw))
    require(kind == "wgmma" and flash_attention.consumer_warpgroups(q, k) == 1,
            f"the timed bf16 flash call ran the {kind} variant")
    t_kernel = time_ms(torch, lambda: flash_attention.flash_attention(q, k, v, **kw))
    t_plain = time_ms(torch, lambda: ref.attention(q, k, v, **kw))
    d_kernel = device_ms(torch, lambda: flash_attention.flash_attention(q, k, v, **kw))
    d_plain = device_ms(torch, lambda: ref.attention(q, k, v, **kw))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_lib = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    d_lib = device_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    lib_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    lib_err = float((lib_out.float() - want.float()).abs().max().item())
    # the local layers' shape too (window 512; under other_timings)
    (q2, k2, v2, kw2), _, _ = _flash_case(
        torch, gen, Sq=Sq, Skv=Sq, H=H, KV=KV, hd=hd, dtype=torch.bfloat16, window=512)
    t_kernel_w = time_ms(torch, lambda: flash_attention.flash_attention(q2, k2, v2, **kw2))
    d_kernel_w = device_ms(torch, lambda: flash_attention.flash_attention(q2, k2, v2, **kw2))
    # the serial engine's prefill, 8 prompts of 512 tokens: 128 blocks of two
    # consumer warpgroups; half of it, 4 prompts, fits a wave of 128 blocks of
    # one (the block layouts' trade-off: one B=8 call against two B=4 calls)
    q8, k8, v8 = (torch.randn((8, 512, n, hd), generator=gen, device="cuda").to(torch.bfloat16)
                  for n in (H, KV, KV))
    require(flash_attention.consumer_warpgroups(q8, k8) == 2
            and flash_attention.consumer_warpgroups(q8[:4], k8[:4]) == 1,
            "the serial-prefill timings do not take the layouts they name")
    d_serial = device_ms(torch, lambda: flash_attention.flash_attention(q8, k8, v8))
    d_half = device_ms(torch, lambda: flash_attention.flash_attention(q8[:4], k8[:4], v8[:4]))

    pairs = int(_build_mask(Sq, Sq, causal=True, window=0, prefix_len=0, q_offset=0,
                            device="cuda").sum().item())
    elem = q.element_size()
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * elem
    flops = 4 * hd * H * pairs
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    # the configs' other prefills (B=1, 1024 tokens), each beside SDPA, all on
    # wgmma: zamba2-7b (32 heads over 32, hd 112), stablelm-12b (32 over 8, hd
    # 160), granite-20b (48 over 1, hd 128), grok-1 (48 over 8) and kimi-k2
    # (64 over 8, hd 112) each also beside the simt kernel on the same
    # operands (`FLASH_SIMT_BESIDE`), and minitron-8b's 32 over 8 at hd 128
    shape_timings = [_flash_timing(torch, gen, label, want, **shape)
                     for label, want, shape in FLASH_TIMINGS]
    log(f"[kernels] flash_attention timing B=1 Sq=Skv={Sq} H={H} KV={KV} hd={hd} bf16 causal "
        f"({kind}): kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, sdpa {t_lib:.4f} ms "
        f"(sdpa max_abs_err vs plain {lib_err:.3e}); device time per call: kernel "
        f"{d_kernel:.4f} ms, plain {d_plain:.4f} ms, sdpa {d_lib:.4f} ms; window=512: kernel "
        f"{t_kernel_w:.4f} ms, {d_kernel_w:.4f} ms device; B=8 Sq=512 (serial prefill, two "
        f"consumer warpgroups a block): {d_serial:.4f} ms device, B=4 (one): {d_half:.4f}; bound "
        f"{max(b_bytes, b_ops) * 1e3:.2f} us ({n_bytes} B, {flops} FLOP); "
        f"{flops / (d_kernel * 1e-3) / 1e12:.2f} TFLOP/s on the device time")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:95",
        "launches": 0,
        "max_abs_err": worst,
        "tolerance": worst_tol,
        "ms": t_kernel,
        "plain_ms": t_plain,
        "device_ms": d_kernel,
        "plain_device_ms": d_plain,
        "bound_ms": max(b_bytes, b_ops),
        "bound_us": max(b_bytes, b_ops) * 1e3,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": t_lib,
        "library_device_ms": d_lib,
        "tflops": flops / (d_kernel * 1e-3) / 1e12,
        "variant": kind,
        "timed_shape": f"B=1 Sq=Skv={Sq} H={H} KV={KV} hd={hd} bf16 causal window=0",
        "other_timings": [
            {"shape": "B=1 Sq=Skv=1024 window=512", "ms": t_kernel_w, "device_ms": d_kernel_w},
            {"shape": "B=8 Sq=Skv=512 causal", "device_ms": d_serial},
            {"shape": "B=4 Sq=Skv=512 causal", "device_ms": d_half}] + shape_timings,
    }


#: (label, variant the rule names, shape) of the prefill shapes timed beside
#: gemma3-1b's: B=1, a 1024-token prompt, causal, bf16
FLASH_TIMINGS = (
    ("zamba2-7b prefill", "wgmma", dict(Sq=1024, H=32, KV=32, hd=112)),
    ("stablelm-12b prefill", "wgmma", dict(Sq=1024, H=32, KV=8, hd=160)),
    ("granite-20b prefill", "wgmma", dict(Sq=1024, H=48, KV=1, hd=128)),
    ("minitron-8b prefill", "wgmma", dict(Sq=1024, H=32, KV=8, hd=128)),
    ("grok-1-314b prefill", "wgmma", dict(Sq=1024, H=48, KV=8, hd=128)),
    ("kimi-k2-1t-a32b prefill", "wgmma", dict(Sq=1024, H=64, KV=8, hd=112)),
    # the two bundles' batches of 8 (phases generate-paligemma, -whisper)
    ("paligemma-3b prefill", "wgmma", dict(B=8, Sq=288, H=8, KV=1, hd=256, prefix_len=256)),
    ("whisper-small encoder", "wgmma", dict(B=8, Sq=1500, H=12, KV=12, hd=64, causal=False)),
    ("whisper-small decoder prefill", "wgmma", dict(B=8, Sq=16, H=12, KV=12, hd=64)),
    ("whisper-small cross-attention prefill", "wgmma",
     dict(B=8, Sq=16, Skv=1500, H=12, KV=12, hd=64, causal=False)),
    ("whisper-small cross-attention decode", "wgmma",
     dict(B=8, Sq=1, Skv=1500, H=12, KV=12, hd=64, causal=False)),
)


#: the prefill shapes whose tensor-core forward came with padded head dims and
#: rows (head_dim 112 / 160, groups of 48 and 6): timed beside the simt
#: kernel on the same operands, which they must beat
FLASH_SIMT_BESIDE = ("zamba2-7b prefill", "stablelm-12b prefill", "granite-20b prefill",
                     "grok-1-314b prefill", "kimi-k2-1t-a32b prefill")


def _fwd_simt(torch, q, k, v, **kw):
    """The `simt` forward at operands the rule gives to `wgmma` or `tf32x3`: its C entry
    point with the simt code, for the before-and-after timing only (no
    launch is counted: no path runs it); the twin of `_bwd_simt`."""
    from repro_torch.kernels import build, flash_attention

    B, Sq, H, hd = q.shape
    out = torch.empty_like(q)
    err = flash_attention._entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, B, Sq, k.shape[1], H,
        k.shape[2], hd, flash_attention._DTYPE_CODES[q.dtype], 1.0 / hd**0.5,
        int(kw["causal"]), kw["window"], kw["prefix_len"], kw["q_offset"],
        flash_attention._VARIANT_CODES["simt"], 0, torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention (simt, timing)")
    return out


def _flash_timing(torch, gen, label, want_kind, *, Sq, H, KV, hd, B=1, Skv=None, causal=True,
                  prefix_len=0) -> dict:
    """Device times of flash (bf16) at one shape, warm and with its inputs
    cold in L2, its plain version and SDPA (one call with the same mask: a
    boolean one for the prefix-LM), with the bound from the pairs the mask
    keeps; the launch must take variant `want_kind`. At `FLASH_SIMT_BESIDE`
    also the simt kernel on the same operands, held to the plain version and
    required slower than the kernel's variant."""
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.ref import _build_mask

    Skv = Skv or Sq
    (q, k, v, kw), got, want = _flash_case(torch, gen, B=B, Sq=Sq, Skv=Skv, H=H, KV=KV, hd=hd,
                                           dtype=torch.bfloat16, causal=causal,
                                           prefix_len=prefix_len)
    err, ok = _max_err_and_ok(torch, got, want, TOL["bfloat16"])
    require(ok, f"flash_attention ({label}) disagrees with its plain version: {err:.3e}")
    kind = launched_variant(flash_attention,
                            lambda: flash_attention.flash_attention(q, k, v, **kw))
    require(kind == want_kind, f"flash_attention ({label}) ran {kind}, expected {want_kind}")
    d_kernel = device_ms(torch, lambda: flash_attention.flash_attention(q, k, v, **kw))
    d_cold = cold_device_ms(torch, lambda q_, k_, v_: flash_attention.flash_attention(
        q_, k_, v_, **kw), (q, k, v), q.nbytes + k.nbytes + v.nbytes)
    d_plain = device_ms(torch, lambda: ref.attention(q, k, v, **kw), iters=5)
    d_simt = simt_err = None
    if label in FLASH_SIMT_BESIDE:
        simt_err, simt_ok = _max_err_and_ok(torch, _fwd_simt(torch, q, k, v, **kw), want,
                                            TOL["bfloat16"])
        require(simt_ok, f"flash_attention simt ({label}) disagrees with its plain version: "
                f"{simt_err:.3e}")
        d_simt = device_ms(torch, lambda: _fwd_simt(torch, q, k, v, **kw), iters=5)
        require(d_kernel < d_simt, f"flash_attention ({label}): {kind} {d_kernel:.4f} ms is not "
                f"faster than simt's {d_simt:.4f} ms on the same operands")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = _build_mask(Sq, Skv, causal=causal, window=0, prefix_len=prefix_len, q_offset=0,
                       device="cuda")
    if prefix_len:
        lib_kw = dict(attn_mask=mask)
    else:
        lib_kw = dict(is_causal=causal)
    d_lib = device_ms(torch, lambda: sdpa(qt, kt, vt, enable_gqa=True, **lib_kw))
    lib_err = float((sdpa(qt, kt, vt, enable_gqa=True, **lib_kw).transpose(1, 2).float()
                     - want.float()).abs().max())
    pairs = B * int(mask.sum().item())
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * hd * H * pairs
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    masks = ("causal" if causal else "bidirectional") + (
        f" prefix_len={prefix_len}" if prefix_len else "")
    shape = f"{label}: B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} hd={hd} bf16 {masks} ({kind})"
    beside = ("" if d_simt is None else
              f", simt on the same operands {d_simt:.4f} ms (max_abs_err {simt_err:.3e})")
    log(f"[kernels] flash_attention timing {shape}: max_abs_err={err:.3e}; device time per "
        f"call: kernel {d_kernel:.4f} ms ({d_cold:.4f} ms with the inputs cold in L2){beside}, "
        f"plain {d_plain:.4f} ms, sdpa {d_lib:.4f} ms (sdpa max_abs_err vs plain "
        f"{lib_err:.3e}); bound {max(b_bytes, b_ops) * 1e3:.2f} us ({n_bytes} B, {flops} FLOP); "
        f"{flops / (d_kernel * 1e-3) / 1e12:.2f} TFLOP/s on the device time")
    return dict(shape=shape, variant=kind, max_abs_err=err, device_ms=d_kernel,
                cold_device_ms=d_cold, simt_device_ms=d_simt, plain_device_ms=d_plain,
                library_device_ms=d_lib, bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                tflops=flops / (d_kernel * 1e-3) / 1e12)


#: flash_attention_bwd's tolerance: max |kernel - plain| / max |plain| for
#: each of dq, dk, dv (bf16: the reference's flash tolerance,
#: tests/test_kernels.py:26-27; fp32: sums of up to 1024 products in another
#: order); and the forward's log-sum-exp against the plain version's
#: (absolute: fp32 sums of the same bf16 products in another order)
BWD_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: the fp32 backward's `tf32x3` variant (three TF32 products a product) is
#: held to fp32's own tolerance (tests/test_kernels.py: 2e-5), and must give
#: the same bits on a second run
TF32X3_REL_TOL = 2e-5
LSE_ATOL = 1e-3

#: (label, shape) of the backward's checked cases: gemma3-1b's training shape
#: (a global and a local layer), a GQA group of 4 at hd 128, the padded head
#: dims 112 and 160, a prefix-LM mask (8 query heads over 1), fp32 at
#: REDUCED's hd 16, rows with no key (a window past the last key, q_offset)
#: in fp32 and in bf16, whisper-small's encoder (1500 frames: a ragged last
#: key tile) and cross-attention (64 queries against 1500 keys), hd 80
#: (train_100m's fp32 on simt, bf16 on wgmma), groups that do not divide 64
#: (granite-20b's 48 and grok-1's 6 at B=1 x 1024; ragged, and with rows with
#: no key), and zamba2-7b's training shape (B=2 x 1024, 32 over 32, hd 112)
BWD_CASES = (
    ("gemma3-1b train, global", dict(B=4, Sq=1024, H=4, KV=1, hd=256, dtype="bfloat16")),
    ("gemma3-1b train, local", dict(B=4, Sq=1024, H=4, KV=1, hd=256, dtype="bfloat16",
                                    window=512)),
    ("hd 128, G=4", dict(B=2, Sq=300, H=8, KV=2, hd=128, dtype="bfloat16")),
    ("hd 112", dict(B=1, Sq=400, H=32, KV=32, hd=112, dtype="bfloat16")),
    ("hd 160, G=4", dict(B=1, Sq=300, H=32, KV=8, hd=160, dtype="bfloat16", window=64)),
    ("prefix-LM 256", dict(B=2, Sq=288, H=8, KV=1, hd=256, dtype="bfloat16", prefix_len=256)),
    ("REDUCED fp32 hd 16", dict(B=4, Sq=45, H=4, KV=1, hd=16, dtype="float32", window=16)),
    ("fp32, empty rows", dict(B=1, Sq=40, Skv=50, H=4, KV=1, hd=32, dtype="float32",
                              q_offset=30, window=8)),
    ("bf16, empty rows", dict(B=1, Sq=40, Skv=50, H=4, KV=1, hd=64, dtype="bfloat16",
                              q_offset=30, window=8)),
    ("whisper-small encoder", dict(B=2, Sq=1500, H=12, KV=12, hd=64, dtype="bfloat16",
                                   causal=False)),
    ("whisper-small cross-attention", dict(B=2, Sq=64, Skv=1500, H=12, KV=12, hd=64,
                                           dtype="bfloat16", causal=False)),
    # examples/train_100m_torch.py: 8 query heads over 2 at hd 80, fp32, B=4 x
    # 256 (a global layer and a local one, window 256), in bf16 and ragged
    ("train_100m, global", dict(B=4, Sq=256, H=8, KV=2, hd=80, dtype="float32")),
    ("train_100m, local", dict(B=4, Sq=256, H=8, KV=2, hd=80, dtype="float32", window=256)),
    ("hd 80 bf16", dict(B=4, Sq=256, H=8, KV=2, hd=80, dtype="bfloat16")),
    ("hd 80 ragged", dict(B=2, Sq=257, H=8, KV=2, hd=80, dtype="float32", window=64)),
    ("hd 80 bf16 ragged", dict(B=2, Sq=257, H=8, KV=2, hd=80, dtype="bfloat16")),
    ("granite-20b, G=48", dict(B=1, Sq=1024, H=48, KV=1, hd=128, dtype="bfloat16")),
    ("grok-1, G=6", dict(B=1, Sq=1024, H=48, KV=8, hd=128, dtype="bfloat16")),
    ("G=6 hd 80 ragged", dict(B=2, Sq=77, H=6, KV=1, hd=80, dtype="bfloat16")),
    ("G=48 hd 160, empty rows", dict(B=1, Sq=40, Skv=50, H=48, KV=1, hd=160, dtype="bfloat16",
                                     q_offset=30, window=8)),
    ("zamba2-7b train", dict(B=2, Sq=1024, H=32, KV=32, hd=112, dtype="bfloat16")),
    # fp32 on tf32x3 at every other head dim it takes: REDUCED's hd 32, a
    # prefix-LM mask, 48 query heads a KV head, a window, a bidirectional
    # ragged Skv, hd 256 (16-row query tiles), rows with no key at hd 80
    ("REDUCED fp32 hd 32", dict(B=2, Sq=64, H=8, KV=2, hd=32, dtype="float32")),
    ("fp32 hd 64 prefix-LM", dict(B=2, Sq=200, H=4, KV=1, hd=64, dtype="float32",
                                  prefix_len=50)),
    ("fp32 hd 112 G=48", dict(B=1, Sq=100, H=48, KV=1, hd=112, dtype="float32")),
    ("fp32 hd 128 window", dict(B=1, Sq=300, H=8, KV=2, hd=128, dtype="float32", window=64)),
    ("fp32 hd 160 bidirectional", dict(B=1, Sq=100, Skv=77, H=4, KV=1, hd=160,
                                       dtype="float32", causal=False)),
    ("fp32 hd 256", dict(B=1, Sq=130, H=4, KV=1, hd=256, dtype="float32")),
    ("fp32 hd 80, empty rows", dict(B=1, Sq=40, Skv=50, H=8, KV=2, hd=80, dtype="float32",
                                    q_offset=30, window=8)),
    # what the rule leaves to simt, held at BWD_REL_TOL: bf16 at hd 32 and
    # with 72 query heads a KV head, fp32 with q off 16 bytes
    ("bf16 hd 32 (simt)", dict(B=2, Sq=64, H=8, KV=2, hd=32, dtype="bfloat16", window=16)),
    ("bf16 G=72 (simt)", dict(B=1, Sq=100, H=72, KV=1, hd=64, dtype="bfloat16")),
    ("fp32 unaligned q (simt)", dict(B=2, Sq=257, H=8, KV=2, hd=80, dtype="float32",
                                     window=64, unaligned_q=True)),
)
#: the cases timed (warm, cold, beside simt on the same operands, the plain
#: version and SDPA's backward): gemma3-1b's two layers, and the shapes
#: whose wgmma came with padded head dims and rows, which must beat simt
BWD_TIMED = ("gemma3-1b train, global", "gemma3-1b train, local", "hd 112", "hd 160, G=4",
             "granite-20b, G=48", "grok-1, G=6", "zamba2-7b train")


def _bwd_case(torch, gen, *, B, Sq, H, KV, hd, dtype, Skv=None, causal=True, window=0,
              prefix_len=0, q_offset=0, unaligned_q=False):
    """Seeded q (one element into a larger buffer with `unaligned_q`: off
    16 bytes), k, v, dO on the card, the forward with its log-sum-exp, and
    the masks' keywords."""
    from repro_torch.kernels import flash_attention

    dt = getattr(torch, dtype)
    Skv = Skv or Sq
    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dt)
    if unaligned_q:
        q = torch.cat([q.new_zeros(1), q.flatten()])[1:].view(q.shape)
    k = torch.randn((B, Skv, KV, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, Skv, KV, hd), generator=gen, device="cuda").to(dt)
    do = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len, q_offset=q_offset)
    out, lse = flash_attention.flash_attention_with_lse(q, k, v, **kw)
    return q, k, v, out, lse, do, kw


def _bwd_simt(torch, q, k, v, out, lse, do, **kw):
    """The `simt` backward at operands the rule gives to `wgmma`: its C entry
    point with the simt code, for the before-and-after timing only (no
    launch is counted: no path runs it)."""
    from repro_torch.kernels import build, flash_attention

    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = flash_attention._backward_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None,
        B, Sq, Skv, H, KV, hd, flash_attention._DTYPE_CODES[q.dtype], 1.0 / hd**0.5,
        int(kw["causal"]), kw["window"], kw["prefix_len"], kw["q_offset"],
        flash_attention._VARIANT_CODES["simt"], 0, 0, torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention_backward (simt, timing)")
    return dq, dk, dv


def _bwd_bound_ms(q, k, lse, kw) -> tuple:
    """(bound ms, bound_by, bytes, FLOP) of one backward call: q, k, v, o,
    dO and lse read once, dq, dk, dv written once; five products over the
    (query, key) pairs the masks keep, for every query head."""
    from repro_torch.kernels.ref import _build_mask

    B, Sq, H, hd = q.shape
    pairs = B * int(_build_mask(Sq, k.shape[1], device="cuda", **kw).sum().item())
    elem = q.element_size()
    n_bytes = (4 * q.numel() + 4 * k.numel()) * elem + lse.numel() * 4
    flops = 10 * hd * H * pairs
    b_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    b_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations"), n_bytes, flops


def check_flash_bwd(torch, gen) -> dict:
    """The backward kernel against `ref.attention_backward` at `BWD_CASES`
    (and the forward's log-sum-exp against the plain one), each case on the
    variant `backward_variant` names; then, at `BWD_TIMED` (gemma3-1b's
    training shape first), the `wgmma` variant (warm, twice, and cold), the
    `simt` variant on the same operands (which `wgmma` must beat), the plain
    version and SDPA's backward (one library call computing the same
    gradient: causal through ``is_causal``, K/V shared by the query heads
    through ``enable_gqa``; a window through that boolean mask), all in this
    call."""
    from repro_torch.kernels import flash_attention, ref

    tiling = []
    for hd in flash_attention.SUPPORTED_HEAD_DIMS:  # the host plan's copy of the tiling
        rows, per_sm, resident = flash_attention.tf32x3_tiling(hd)
        host = (flash_attention.tf32x3_walk_rows(hd), flash_attention.tf32x3_blocks_per_sm(hd))
        require((rows, per_sm) == host and resident >= per_sm,
                f"tf32x3 at hd {hd}: the kernels take {rows} query rows a visit and {per_sm} "
                f"blocks an SM ({resident} resident), the host plan {host}")
        tiling.append(f"hd {hd}: {rows} rows, {per_sm} blocks an SM ({resident} resident)")
    log("[kernels] flash_attention_bwd tf32x3 tiling as built, equal to the host plan's: "
        + "; ".join(tiling))
    worst_abs, worst_rel, worst_tol = 0.0, 0.0, None
    for label, case in BWD_CASES:
        q, k, v, out, lse, do, kw = _bwd_case(torch, gen, **case)
        _, lse_plain = ref.attention_with_lse(q, k, v, **kw)
        live = lse_plain > -1e29  # rows with a key
        lse_err = float((lse - lse_plain)[live].abs().max().item())
        kind = flash_attention.backward_variant(q, k, v)
        tc = _tensor_core_case(case["dtype"], case)
        want_kind = ("wgmma" if tc else "tf32x3" if case["dtype"] == "float32"
                     and not case.get("unaligned_q") else "simt")
        require(kind == want_kind, f"backward ({label}) takes {kind}, not {want_kind}")
        plan = ""
        if kind in ("wgmma", "tf32x3"):
            chunk, splits = (flash_attention.backward_plan if kind == "wgmma"
                             else flash_attention.tf32x3_plan)(q, k, **kw)
            plan = f", chunk {chunk}, splits {splits}"
        results = []
        ran = launched_variant(flash_attention.backward, lambda: results.append(
            flash_attention.flash_attention_backward(q, k, v, out, lse, do, **kw)))
        require(ran == kind, f"flash_attention_backward ({label}) launched {ran}, not {kind}")
        got = results[0]
        want = ref.attention_backward(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        if kind == "tf32x3":  # no atomics: a second run gives the same bits
            again = flash_attention.flash_attention_backward(q, k, v, out, lse, do, **kw)
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"flash_attention_backward ({label}, tf32x3) changed bits on a second run")
            plan += ", the same bits twice"
            del again
        rel = {}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            diff = float((a.float() - b.float()).abs().max().item())
            rel[name] = diff / max(float(b.float().abs().max().item()), 1e-30)
            require(bool(torch.isfinite(a).all().item()), f"{label}: {name} not finite")
            worst_abs = max(worst_abs, diff)
        tol = TF32X3_REL_TOL if kind == "tf32x3" else BWD_REL_TOL[case["dtype"]]
        ok = max(rel.values()) <= tol and lse_err <= LSE_ATOL
        desc = ", ".join(f"{n}={x}" for n, x in case.items() if n != "dtype")
        log(f"[kernels] flash_attention_bwd {case['dtype']} {label} ({desc}; {kind}{plan}): max "
            f"|d| / max |plain| " + ", ".join(f"{n} {x:.3e}" for n, x in rel.items())
            + f" (tol {tol}); forward lse max err {lse_err:.3e} (tol {LSE_ATOL}) "
            + ("ok" if ok else "FAIL"))
        require(ok, f"flash_attention_bwd disagrees with its plain version ({label})")
        if max(rel.values()) > worst_rel:
            worst_rel, worst_tol = max(rel.values()), tol
        del q, k, v, out, lse, do, got, want, results

    timings = {}
    cases = dict(BWD_CASES)
    for label in BWD_TIMED:
        case = cases[label]
        q, k, v, out, lse, do, kw = _bwd_case(torch, gen, **case)
        require(flash_attention.backward_variant(q, k, v) == "wgmma",
                f"the timed backward ({label}) does not take wgmma")
        call = lambda: flash_attention.flash_attention_backward(  # noqa: E731
            q, k, v, out, lse, do, **kw)
        simt = lambda: _bwd_simt(torch, q, k, v, out, lse, do, **kw)  # noqa: E731
        simt_dq = simt()[0]
        want_dq = ref.attention_backward(q, k, v, out, lse, do, **kw)[0]
        bound, bound_by, n_bytes, flops = _bwd_bound_ms(q, k, lse, kw)
        t = dict(ms=time_ms(torch, call, iters=10), device_ms=device_ms(torch, call, iters=10))
        t["simt_device_ms"] = device_ms(torch, simt, iters=5)
        t["plain_ms"] = time_ms(torch, lambda: ref.attention_backward(
            q, k, v, out, lse, do, **kw), iters=3, warmup=1)
        t["plain_device_ms"] = device_ms(torch, lambda: ref.attention_backward(
            q, k, v, out, lse, do, **kw), iters=3)
        # SDPA's backward: heads second, the same inputs and output gradient
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if kw["window"]:
            from repro_torch.kernels.ref import _build_mask

            lib_kw = dict(attn_mask=_build_mask(q.shape[1], k.shape[1], device="cuda",
                                                causal=True, window=kw["window"],
                                                prefix_len=0, q_offset=0))
        else:
            lib_kw = dict(is_causal=True)
        lib_out = sdpa(qt, kt, vt, enable_gqa=True, **lib_kw)
        lib_call = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,  # noqa: E731
                                               retain_graph=True)
        t["library_ms"] = time_ms(torch, lib_call, iters=10)
        t["library_device_ms"] = device_ms(torch, lib_call, iters=10)
        lib_dq = lib_call()[0].transpose(1, 2)
        t["library_dq_err"] = float((lib_dq.float() - want_dq.float()).abs().max().item())
        t["simt_dq_err"] = float((simt_dq.float() - want_dq.float()).abs().max().item())
        simt_rel = t["simt_dq_err"] / max(float(want_dq.float().abs().max().item()), 1e-30)
        require(simt_rel <= BWD_REL_TOL["bfloat16"],
                f"the simt backward's dq at {label} is off its plain version by {simt_rel:.3e}")
        # the wgmma variant again, after the others (kernel, simt, plain, library, kernel)
        t["device_ms_again"] = device_ms(torch, call, iters=10)
        require(max(t["device_ms"], t["device_ms_again"]) < t["simt_device_ms"],
                f"the wgmma backward at {label} ({t['device_ms']:.4f} / "
                f"{t['device_ms_again']:.4f} ms) is not faster than simt's "
                f"{t['simt_device_ms']:.4f} ms on the same operands")
        t["cold_device_ms"] = cold_device_ms(
            torch, lambda *xs: flash_attention.flash_attention_backward(*xs, **kw),
            (q, k, v, out, lse, do), sum(x.nbytes for x in (q, k, v, out, lse, do)))
        desc = ", ".join(f"{n}={x}" for n, x in case.items() if n != "dtype")
        t.update(bound_ms=bound, bound_by=bound_by, bytes=n_bytes, flops=flops,
                 tflops=flops / (t["device_ms"] * 1e-3) / 1e12,
                 plan=flash_attention.backward_plan(q, k, **kw), shape=f"{label}: {desc}")
        log(f"[kernels] flash_attention_bwd timing {label} ({desc}, bf16, causal): wgmma "
            f"{t['ms']:.4f} ms, "
            f"device {t['device_ms']:.4f} / {t['device_ms_again']:.4f} ms ({t['cold_device_ms']:.4f}"
            f" ms with the inputs cold in L2; chunk, splits {t['plan']}); simt device "
            f"{t['simt_device_ms']:.4f} ms (its dq max err vs plain {t['simt_dq_err']:.3e}); plain "
            f"{t['plain_ms']:.4f} ms, device {t['plain_device_ms']:.4f}; SDPA backward "
            f"{t['library_ms']:.4f} ms, device {t['library_device_ms']:.4f} (its dq max err vs "
            f"plain {t['library_dq_err']:.3e}); bound {bound * 1e3:.2f} us ({bound_by}: "
            f"{n_bytes} B, {flops} FLOP); {t['tflops']:.2f} TFLOP/s on the wgmma device time")
        timings[label] = t
        del q, k, v, out, lse, do, qt, kt, vt, lib_out
    g = timings[BWD_TIMED[0]]
    keys = ("shape", "ms", "device_ms", "device_ms_again", "cold_device_ms", "simt_device_ms",
            "plain_ms", "plain_device_ms", "library_ms", "library_device_ms", "bound_ms",
            "bound_by", "tflops")
    return {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        # the gradient of this Pallas kernel, which has no VJP of its own
        "replaces": "src/repro/kernels/flash_attention.py:95",
        "launches": 0,
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "tolerance": worst_tol,
        "ms": g["ms"],
        "plain_ms": g["plain_ms"],
        "device_ms": g["device_ms"],
        "device_ms_again": g["device_ms_again"],
        "cold_device_ms": g["cold_device_ms"],
        "simt_device_ms": g["simt_device_ms"],
        "plain_device_ms": g["plain_device_ms"],
        "bound_ms": g["bound_ms"],
        "bound_us": g["bound_ms"] * 1e3,
        "bound_by": g["bound_by"],
        "library_ms": g["library_ms"],
        "library_device_ms": g["library_device_ms"],
        "tflops": g["tflops"],
        "variant": "wgmma",
        "timed_shape": "B=4 Sq=Skv=1024 H=4 KV=1 hd=256 bf16 causal window=0 (gemma3-1b "
                       "training, a global layer)",
        "other_timings": [{n: timings[label][n] for n in keys} for label in BWD_TIMED[1:]],
    }


#: examples/train_100m_torch.py's attention: B=4 x 256, 8 query heads over 2
#: at head_dim 80 (fp32, causal; its local layers' window of 256 keys drops
#: no pair at 256 positions)
TRAIN_100M_ATTENTION = dict(B=4, Sq=256, H=8, KV=2, hd=80)


def time_flash_hd80(torch, gen) -> tuple:
    """The flash forward and backward (both `tf32x3`) at
    `TRAIN_100M_ATTENTION` in fp32, timed (CUDA events and the profiler's
    device time) beside the plain version and SDPA (TF32 off; its backward
    through autograd, the same output gradient), each also twice, cold, and
    beside the `simt` kernel on the same operands (the rule's old variant,
    through the C entry point), with the bound from the pairs the causal
    mask keeps, both ways: at the fp32 FMA peak, and as three products at
    the TF32 peak. Returns (forward row, backward row) for the two kernels'
    `other_timings`."""
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.ref import _build_mask

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, k, v, out, lse, do, kw = _bwd_case(torch, gen, dtype="float32", **TRAIN_100M_ATTENTION)
    B, Sq, H, hd = q.shape
    fwd = lambda: flash_attention.flash_attention(q, k, v, **kw)  # noqa: E731
    bwd = lambda: flash_attention.flash_attention_backward(  # noqa: E731
        q, k, v, out, lse, do, **kw)
    require(launched_variant(flash_attention, fwd) == "tf32x3"
            and launched_variant(flash_attention.backward, bwd) == "tf32x3",
            "flash at train_100m's shape did not run the tf32x3 forward and backward")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    lib_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_fwd = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
    lib_bwd = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,  # noqa: E731
                                          retain_graph=True)
    plain_bwd = lambda: ref.attention_backward(q, k, v, out, lse, do, **kw)  # noqa: E731
    want = ref.attention(q, k, v, **kw)
    want_dq = plain_bwd()[0]
    pairs = B * int(_build_mask(Sq, Sq, device="cuda", **kw).sum().item())
    f_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    f_flops = 4 * hd * H * pairs

    def both_ways(n_bytes, flops):
        """(bound, bound_by, at the fp32 FMA peak, as three TF32 products):
        the least time is the lower of the two ways to do the work, fp32 FMA
        or three TF32 products a product on the tensor cores (tf32x3's
        way), each the larger of its bytes and its operations."""
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        ways = [(max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
                for t_ops in (flops / PEAK_FLOPS["float32"] * 1e3,
                              3 * flops / PEAK_FLOPS["tfloat32"] * 1e3)]
        return (*min(ways), ways[0][0], ways[1][0])

    f_bound, f_by, f_fma, f_tf32 = both_ways(f_bytes, f_flops)
    _, _, b_bytes, b_flops = _bwd_bound_ms(q, k, lse, kw)
    b_bound, b_by, fma_bound, tf32_bound = both_ways(b_bytes, b_flops)
    shape = (f"train_100m: B={B} Sq=Skv={Sq} H={H} KV={k.shape[2]} hd={hd} fp32 causal "
             f"(forward and backward tf32x3)")
    simt_fwd = lambda: _fwd_simt(torch, q, k, v, **kw)  # noqa: E731
    with torch.no_grad():
        fwd_row = dict(
            shape=shape, variant="tf32x3", ms=time_ms(torch, fwd),
            device_ms=device_ms(torch, fwd), simt_device_ms=device_ms(torch, simt_fwd),
            plain_ms=time_ms(torch, lambda: ref.attention(q, k, v, **kw)),
            plain_device_ms=device_ms(torch, lambda: ref.attention(q, k, v, **kw), iters=5),
            library_ms=time_ms(torch, lib_fwd), library_device_ms=device_ms(torch, lib_fwd),
            library_err=float((lib_fwd().transpose(1, 2) - want).abs().max().item()),
            kernel_err=float((fwd() - want).abs().max().item()),
            simt_err=float((simt_fwd() - want).abs().max().item()),
            device_ms_again=device_ms(torch, fwd),
            cold_device_ms=cold_device_ms(
                torch, lambda *xs: flash_attention.flash_attention(*xs, **kw), (q, k, v),
                sum(x.nbytes for x in (q, k, v))),
            bound_ms=f_bound, bound_by=f_by, bytes=f_bytes, flops=f_flops,
            bound_tf32x3_ms=f_tf32, bound_fp32_fma_ms=f_fma)
    simt_bwd = lambda: _bwd_simt(torch, q, k, v, out, lse, do, **kw)  # noqa: E731
    bwd_row = dict(
        shape=shape, variant="tf32x3", ms=time_ms(torch, bwd, iters=10),
        device_ms=device_ms(torch, bwd, iters=10),
        simt_device_ms=device_ms(torch, simt_bwd, iters=5),
        plain_ms=time_ms(torch, plain_bwd, iters=3, warmup=1),
        plain_device_ms=device_ms(torch, plain_bwd, iters=3),
        library_ms=time_ms(torch, lib_bwd, iters=10),
        library_device_ms=device_ms(torch, lib_bwd, iters=10),
        library_dq_err=float((lib_bwd()[0].transpose(1, 2) - want_dq).abs().max().item()),
        simt_dq_err=float((simt_bwd()[0] - want_dq).abs().max().item()),
        kernel_dq_err=float((bwd()[0] - want_dq).abs().max().item()),
        device_ms_again=device_ms(torch, bwd, iters=10),
        cold_device_ms=cold_device_ms(
            torch, lambda *xs: flash_attention.flash_attention_backward(*xs, **kw),
            (q, k, v, out, lse, do), sum(x.nbytes for x in (q, k, v, out, lse, do))),
        plan=flash_attention.tf32x3_plan(q, k, **kw),
        bound_ms=b_bound, bound_by=b_by, bytes=b_bytes, flops=b_flops,
        bound_tf32x3_ms=tf32_bound, bound_fp32_fma_ms=fma_bound)
    for name, row in (("flash_attention", fwd_row), ("flash_attention_bwd", bwd_row)):
        row["tflops"] = row["flops"] / (row["device_ms"] * 1e-3) / 1e12
        log(f"[kernels] {name} timing {shape}: kernel {row['ms']:.4f} ms, device "
            f"{row['device_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms, device "
            f"{row['plain_device_ms']:.4f}; SDPA {row['library_ms']:.4f} ms, device "
            f"{row['library_device_ms']:.4f} (its max err vs plain "
            f"{row.get('library_err', row.get('library_dq_err')):.3e}); bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: {row['bytes']} B, "
            f"{row['flops']} FLOP); {row['tflops']:.3f} TFLOP/s on the device time")
    log(f"[kernels] flash_attention tf32x3 at train_100m: device {fwd_row['device_ms']:.4f} "
        f"/ again {fwd_row['device_ms_again']:.4f} ms, cold {fwd_row['cold_device_ms']:.4f} ms; "
        f"simt on the same operands {fwd_row['simt_device_ms']:.4f} ms; SDPA "
        f"{fwd_row['library_device_ms']:.4f} ms; max err vs plain: tf32x3 "
        f"{fwd_row['kernel_err']:.3e}, simt {fwd_row['simt_err']:.3e}, SDPA "
        f"{fwd_row['library_err']:.3e}; bound {f_bound * 1e3:.2f} us, the lower of "
        f"{f_tf32 * 1e3:.2f} us as three products at the TF32 peak and {f_fma * 1e3:.2f} us at "
        f"the fp32 FMA peak")
    log(f"[kernels] flash_attention_bwd tf32x3 at train_100m: device {bwd_row['device_ms']:.4f} "
        f"/ again {bwd_row['device_ms_again']:.4f} ms, cold {bwd_row['cold_device_ms']:.4f} ms "
        f"(chunk, splits {bwd_row['plan']}); simt on the same operands "
        f"{bwd_row['simt_device_ms']:.4f} ms; SDPA's backward {bwd_row['library_device_ms']:.4f}"
        f" ms; dq max err vs plain: tf32x3 {bwd_row['kernel_dq_err']:.3e}, simt "
        f"{bwd_row['simt_dq_err']:.3e}, SDPA {bwd_row['library_dq_err']:.3e}; bound "
        f"{b_bound * 1e3:.2f} us, the lower of {tf32_bound * 1e3:.2f} us as three products at "
        f"the TF32 peak and {fma_bound * 1e3:.2f} us at the fp32 FMA peak")
    dq_scale = max(float(want_dq.abs().max().item()), 1e-30)
    for kind_, key, tol in (("tf32x3", "kernel_dq_err", TF32X3_REL_TOL),
                            ("simt", "simt_dq_err", BWD_REL_TOL["float32"])):
        require(bwd_row[key] / dq_scale <= tol,
                f"the {kind_} backward's dq at train_100m is off its plain version by "
                f"{bwd_row[key] / dq_scale:.3e} (tol {tol})")
    for key in ("kernel_err", "simt_err"):  # the forward's, within fp32's tolerance
        require(fwd_row[key] <= TOL["float32"]["atol"] + TOL["float32"]["rtol"] * float(
            want.abs().max()), f"the forward's {key} at train_100m is {fwd_row[key]:.3e}")
    require(max(fwd_row["device_ms"], fwd_row["device_ms_again"]) < fwd_row["simt_device_ms"],
            f"the tf32x3 forward at train_100m ({fwd_row['device_ms']:.4f} ms) is not faster "
            f"than simt's {fwd_row['simt_device_ms']:.4f} ms on the same operands")
    require(max(bwd_row["device_ms"], bwd_row["device_ms_again"]) < bwd_row["simt_device_ms"],
            f"the tf32x3 backward at train_100m ({bwd_row['device_ms']:.4f} ms) is not faster "
            f"than simt's {bwd_row['simt_device_ms']:.4f} ms on the same operands")
    del q, k, v, out, lse, do, qt, kt, vt, lib_out
    return fwd_row, bwd_row


def decode_ptxas(rows: str, dtype, hd: int, groups: int, kind: str) -> str:
    """`-Xptxas -v` of the decode core's instantiation for these operands
    (`decode_mma_kernel<HDP, GMAX, rows>` or `decode_kernel<T, HDP, GMAX,
    rows>`, `csrc/decode_core.cuh`, by variant `kind`), from the verbose
    build of phase 2, with the dynamic shared memory the launch asks for,
    and the register range and any spills over every instantiation of that
    kernel for `rows`."""
    import re

    from repro_torch.kernels import build, decode_core

    bf16 = str(dtype).endswith("bfloat16")
    # the mma walk is instantiated at each of its head dims, simt's at buckets
    hdp = hd if kind == "mma" else next(b for b in (16, 32, 64, 128, 256) if hd <= b)
    gmax = next(b for b in (1, 2, 4, 8) if decode_core.block_group(groups) <= b)
    kernel = "decode_mma_kernel" if kind == "mma" else "decode_kernel"
    want = (f"{kernel}<{hdp}, {gmax}, {rows}>" if kind == "mma"
            else f"{kernel}<{str(dtype).split('.')[-1]}, {hdp}, {gmax}, {rows}>")
    found, regs, spills = None, [], []
    for entry in build.build_log().split("Compiling entry function '")[1:]:
        name = entry.split("'", 1)[0]
        if f"{len(kernel)}{kernel}I" not in name or rows not in name:
            continue
        used = re.search(r"Used (\d+) registers", entry)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", entry)
        require(used is not None and frame is not None, f"no ptxas report for {name}")
        regs.append(int(used.group(1)))
        if int(frame.group(2)) or int(frame.group(3)):
            spills.append(name)
        if f"Li{hdp}ELi{gmax}E" in name and (kind == "mma" or ("bfloat16" in name) == bf16):
            smem = re.search(r"(\d+) bytes smem", entry)
            found = (f"{used.group(1)} registers, {frame.group(1)} bytes stack frame, "
                     f"{frame.group(2)} bytes spill stores, {frame.group(3)} bytes spill loads, "
                     f"{smem.group(1) if smem else 0} bytes static smem, "
                     f"{decode_core.smem_bytes(dtype, groups, hd, kind)} bytes dynamic smem")
    require(found is not None, f"no ptxas report for {want} in the build log")
    return (f"{want}: {found}; "
            f"all {len(regs)} {kernel} {rows} instantiations: {min(regs)}-{max(regs)} registers, "
            f"spills in {spills or 'none'}")


def _paged_case(torch, gen, *, pos, dtype, window=0, B=8, H=4, KV=1, hd=256, page=16,
                n_pages=68, ring=False):
    """Pool + page tables as the serving path builds them: distinct pages
    per slot for positions [0, pos], null page 0 past them (poisoned)."""
    P = B * n_pages + 1
    k_pool = torch.randn((P, page, KV, hd), generator=gen, device="cuda").to(dtype)
    v_pool = torch.randn((P, page, KV, hd), generator=gen, device="cuda").to(dtype)
    k_pool[0] = 1e4
    v_pool[0] = 1e4
    perm = torch.randperm(P - 1, generator=gen, device="cuda").to(torch.int32) + 1
    table = torch.zeros((B, n_pages), dtype=torch.int32, device="cuda")
    for b in range(B):
        used = n_pages if ring else min(n_pages, pos[b] // page + 1)
        table[b, :used] = perm[b * n_pages : b * n_pages + used]
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dtype)
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    return q, k_pool, v_pool, table, pos_t


def check_paged(torch, gen) -> dict:
    from repro_torch.kernels import decode_core, paged_decode_attention, ref

    uneven = [0, 15, 16, 100, 511, 512, 777, 1087]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for window in (0, 512):
            cases.append(dict(pos=uneven, dtype=dtype, window=window))
        # ring layers: 32 identity-mapped ring pages, eff_pos clamped to 511
        cases.append(dict(pos=[0, 5, 200, 511, 511, 511, 300, 17], dtype=dtype, n_pages=32,
                          ring=True))
    cases.append(dict(pos=[3, 9, 30, 31], dtype=torch.float32, B=4, H=8, KV=2, hd=16, page=8,
                      n_pages=4, window=5))
    # a window shorter than one cluster block's share; 8 query heads a KV head
    # at hd 128 with fewer positions than the cluster has blocks
    cases.append(dict(pos=uneven, dtype=torch.bfloat16, window=5))
    cases.append(dict(pos=[0, 1, 2], dtype=torch.bfloat16, B=3, H=8, hd=128, window=512))
    # more query heads a KV head than a block holds (granite-20b: 48 over 1):
    # groups of at most 8 heads, each group's cluster re-reading the rows
    for dtype in (torch.float32, torch.bfloat16):
        for H in (12, 48):
            cases.append(dict(pos=uneven, dtype=dtype, H=H, hd=128, window=0))
    # the dense family's ticks: minitron-8b (32 over 8, hd 128) and
    # stablelm-12b (32 over 8, hd 160), both mma (fp32 hd 160: simt)
    for hd in (128, 160):
        cases.append(dict(pos=uneven, dtype=torch.bfloat16, H=32, KV=8, hd=hd))
    cases.append(dict(pos=uneven, dtype=torch.float32, H=32, KV=8, hd=160))
    # the mma walk at the dims between the powers of two (padded ring rows):
    # G = 1, 4 and 8, windows shorter and longer than a block's share
    cases += [dict(pos=uneven, dtype=torch.bfloat16, H=8, KV=8, hd=80, window=100),
              dict(pos=uneven, dtype=torch.bfloat16, H=8, KV=2, hd=80),
              dict(pos=uneven, dtype=torch.bfloat16, H=4, KV=4, hd=112, window=5),
              dict(pos=uneven, dtype=torch.bfloat16, H=32, KV=8, hd=160, window=300),
              dict(pos=uneven, dtype=torch.bfloat16, H=8, KV=1, hd=160, window=512)]
    # the MoE family's ticks: grok-1 (48 over 8, hd 128) and kimi-k2 (64 over
    # 8, hd 112), both mma; rows that are not whole 16-byte loads (fp32 hd
    # 18, bf16 hd 36: element loads on the simt walk)
    cases += [dict(pos=uneven, dtype=torch.bfloat16, H=48, KV=8, hd=128),
              dict(pos=uneven, dtype=torch.bfloat16, H=64, KV=8, hd=112),
              dict(pos=uneven, dtype=torch.float32, H=64, KV=8, hd=112),
              dict(pos=uneven, dtype=torch.float32, H=4, KV=2, hd=18),
              dict(pos=uneven, dtype=torch.float32, H=4, KV=2, hd=18, window=100),
              dict(pos=uneven, dtype=torch.bfloat16, H=12, KV=2, hd=36)]
    worst, worst_tol = 0.0, None
    for case in cases:
        q, kp, vp, tbl, pos = _paged_case(torch, gen, **case)
        w = case.get("window", 0)
        got = paged_decode_attention.paged_decode_attention(q, kp, vp, tbl, pos, window=w)
        want = ref.paged_decode_attention(q, kp, vp, tbl, pos, window=w)
        torch.cuda.synchronize()
        name = str(case["dtype"]).split(".")[-1]
        err, ok = _max_err_and_ok(torch, got, want, PAGED_TOL[name])
        desc = ", ".join(f"{k}={v}" for k, v in case.items() if k != "dtype")
        log(f"[kernels] paged_decode_attention {name} {desc} ({decode_core.variant(q, kp)}): "
            f"max_abs_err={err:.3e} tol={PAGED_TOL[name]} {'ok' if ok else 'FAIL'}")
        require(ok, f"paged_decode_attention disagrees with its plain version ({desc}, {name})")
        if err > worst:
            worst, worst_tol = err, PAGED_TOL[name]

    # timing at the serving path's global-layer shape: 8 slots, uneven
    # positions up to the 1088-position cache, bf16
    q, kp, vp, tbl, pos = _paged_case(torch, gen, pos=uneven, dtype=torch.bfloat16)
    t_kernel = time_ms(torch, lambda: paged_decode_attention.paged_decode_attention(
        q, kp, vp, tbl, pos), iters=100)
    t_plain = time_ms(torch, lambda: ref.paged_decode_attention(q, kp, vp, tbl, pos))
    d_kernel = device_ms(torch, lambda: paged_decode_attention.paged_decode_attention(
        q, kp, vp, tbl, pos))
    d_plain = device_ms(torch, lambda: ref.paged_decode_attention(q, kp, vp, tbl, pos))
    d_cold = cold_device_ms(
        torch, lambda k_, v_: paged_decode_attention.paged_decode_attention(q, k_, v_, tbl, pos),
        (kp, vp), kp.nbytes + vp.nbytes)
    B, H, hd = q.shape
    KV = kp.shape[2]
    n_valid = sum(p + 1 for p in uneven)
    elem = q.element_size()
    n_bytes = 2 * q.numel() * elem + 2 * n_valid * KV * hd * elem + tbl.numel() * 4 + B * 4
    flops = 4 * H * hd * n_valid
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    cluster, kind = decode_core.cluster_size(q, kp), decode_core.variant(q, kp)
    require(kind == "mma", f"paged_decode_attention timed on {kind}, expected mma")
    log(f"[kernels] paged_decode_attention timing B={B} H={H} KV={KV} hd={hd} page=16 "
        f"n_pages=68 pos={uneven} bf16: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms; "
        f"device time per call: kernel {d_kernel:.4f} ms, plain {d_plain:.4f} ms, kernel "
        f"with the pools cold in L2 {d_cold:.4f} ms; variant {kind}, cluster of {cluster} blocks "
        f"per (slot, KV head); bound {max(b_bytes, b_ops) * 1e3:.2f} us ({n_bytes} B, {flops} FLOP); "
        f"{flops / (d_kernel * 1e-3) / 1e12:.3f} TFLOP/s on the device time")
    # the prefix cache's shared layout: local layers page through the full
    # table with the window as a mask (22 of gemma3's 26 layers)
    d_window = device_ms(torch, lambda: paged_decode_attention.paged_decode_attention(
        q, kp, vp, tbl, pos, window=512))
    n_window = sum(min(p + 1, 512) for p in uneven)
    w_bytes = 2 * q.numel() * elem + 2 * n_window * KV * hd * elem + tbl.numel() * 4 + B * 4
    w_bound = max(w_bytes / PEAK_BYTES_PER_S, 4 * H * hd * n_window / PEAK_FLOPS["bfloat16"]) * 1e3
    log(f"[kernels] paged_decode_attention timing, window 512 through the full table (the "
        f"prefix cache's local layers; {n_window} positions in the windows): device "
        f"{d_window:.4f} ms; bound {w_bound * 1e3:.3f} us")
    # granite-20b's tick: 48 query heads over 1 KV head, hd 128, six head
    # groups of 8 (mma)
    granite = _paged_timing(torch, gen, uneven, "granite-20b decode", "mma", H=48, KV=1, hd=128)
    grok = _paged_timing(torch, gen, uneven, "grok-1-314b decode", "mma", H=48, KV=8, hd=128)
    kimi = _paged_timing(torch, gen, uneven, "kimi-k2-1t-a32b decode", "mma", H=64, KV=8,
                         hd=112)
    stablelm = _paged_timing(torch, gen, uneven, "stablelm-12b decode", "mma", H=32, KV=8,
                             hd=160)
    for k in ("mma", "simt"):
        log(f"[kernels] paged_decode_attention ptxas: "
            f"{decode_ptxas('PagedRows', q.dtype, hd, H // KV, k)}")
    for hd_, G_ in ((80, 4), (112, 8), (160, 4)):
        log(f"[kernels] paged_decode_attention ptxas: "
            f"{decode_ptxas('PagedRows', q.dtype, hd_, G_, 'mma')}")
    return {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_decode_attention.py:83",
        "launches": 0,
        "max_abs_err": worst,
        "tolerance": worst_tol,
        "ms": t_kernel,
        "plain_ms": t_plain,
        "device_ms": d_kernel,
        "plain_device_ms": d_plain,
        "cold_device_ms": d_cold,
        "bound_ms": max(b_bytes, b_ops),
        "bound_us": max(b_bytes, b_ops) * 1e3,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None,
        "library_device_ms": None,
        "tflops": flops / (d_kernel * 1e-3) / 1e12,
        "cluster": cluster,
        "variant": kind,
        "timed_shape": f"B={B} H={H} KV={KV} hd={hd} page=16 n_pages=68 bf16 window=0",
        "other_timings": [{"shape": "the same, window=512 through the full table",
                           "device_ms": d_window, "bound_ms": w_bound}, granite, grok, kimi,
                          stablelm],
    }


def _with_decode_rule(attr: str, value, call):
    """`call()` with the rule `attr` of `decode_core` swapped for `value`
    (restored after): operands timed on what the rule does not give them
    (no path runs it), for the record."""
    from repro_torch.kernels import decode_core

    saved = getattr(decode_core, attr)
    setattr(decode_core, attr, value)
    try:
        return call()
    finally:
        setattr(decode_core, attr, saved)


def _walk_beside(torch, call, walk: str) -> float:
    """Device ms of `call` with the decode core's walk rule swapped for
    `walk` on the same operands."""
    return _with_decode_rule("variant", lambda q_, k_: walk, lambda: device_ms(torch, call))


def _paged_timing(torch, gen, pos, label, want_kind, *, H, KV, hd) -> dict:
    """The paged kernel at one serving tick's shape (8 slots, 16-position
    pages, `pos` positions, bf16), warm and with the pools cold in L2,
    beside its plain version (and, on `mma`, the `simt` walk on the same
    operands), with the bound; no single PyTorch call computes the paged
    gather and attention together."""
    from repro_torch.kernels import decode_core, paged_decode_attention, ref

    q, kp, vp, tbl, pos_t = _paged_case(torch, gen, pos=pos, dtype=torch.bfloat16, H=H, KV=KV,
                                        hd=hd)
    kind = decode_core.variant(q, kp)
    require(kind == want_kind, f"paged_decode_attention ({label}) ran {kind}, expected {want_kind}")
    got = paged_decode_attention.paged_decode_attention(q, kp, vp, tbl, pos_t)
    err, ok = _max_err_and_ok(torch, got, ref.paged_decode_attention(q, kp, vp, tbl, pos_t),
                              PAGED_TOL["bfloat16"])
    require(ok, f"paged_decode_attention ({label}) disagrees with its plain version: {err:.3e}")
    d_kernel = device_ms(torch, lambda: paged_decode_attention.paged_decode_attention(
        q, kp, vp, tbl, pos_t))
    d_plain = device_ms(torch, lambda: ref.paged_decode_attention(q, kp, vp, tbl, pos_t))
    d_cold = cold_device_ms(
        torch, lambda k_, v_: paged_decode_attention.paged_decode_attention(q, k_, v_, tbl, pos_t),
        (kp, vp), kp.nbytes + vp.nbytes)
    d_simt = (_walk_beside(torch, lambda: paged_decode_attention.paged_decode_attention(
        q, kp, vp, tbl, pos_t), "simt") if kind == "mma" else None)
    B = q.shape[0]
    n_valid = sum(p + 1 for p in pos)
    elem = q.element_size()
    n_bytes = 2 * q.numel() * elem + 2 * n_valid * KV * hd * elem + tbl.numel() * 4 + B * 4
    flops = 4 * H * hd * n_valid
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    shape = (f"{label}: B={B} H={H} KV={KV} hd={hd} page=16 bf16, {n_valid} valid positions "
             f"({kind}, {decode_core.head_groups(H // KV)} head groups, cluster of "
             f"{decode_core.cluster_size(q, kp)})")
    log(f"[kernels] paged_decode_attention timing {shape}: max_abs_err={err:.3e}; device time "
        f"per call: kernel {d_kernel:.4f} ms ({d_cold:.4f} ms with the pools cold in L2), simt "
        f"walk on the same operands {d_simt if d_simt is None else f'{d_simt:.4f}'} ms, plain "
        f"{d_plain:.4f} ms; bound {max(b_bytes, b_ops) * 1e3:.3f} us ({n_bytes} B, {flops} FLOP)")
    return dict(shape=shape, variant=kind, max_abs_err=err, device_ms=d_kernel,
                cold_device_ms=d_cold, simt_device_ms=d_simt, plain_device_ms=d_plain,
                library_device_ms=None,
                bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations")


def _decode_case(torch, gen, *, pos, dtype, B=8, S=1088, H=4, KV=1, hd=256, poison=False):
    """Dense per-slot caches as the dense serving path holds them; with
    `poison`, every slot past pos holds 1e4 (must never reach the output)."""
    k = torch.randn((B, S, KV, hd), generator=gen, device="cuda")
    v = torch.randn((B, S, KV, hd), generator=gen, device="cuda")
    if poison:
        past = torch.arange(S, device="cuda")[None, :] > torch.as_tensor(pos, device="cuda")[:, None]
        k[past] = 1e4
        v[past] = 1e4
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dtype)
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    return q, k.to(dtype), v.to(dtype), pos_t


def check_decode(torch, gen) -> dict:
    from repro_torch.kernels import decode_attention, decode_core, paged_decode_attention, ref

    uneven = [0, 15, 16, 100, 511, 512, 777, 1087]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [
            dict(pos=uneven, dtype=dtype),  # global layers: max_len 1088, ragged S
            # local layers: a ring of 512, eff_pos clamped to 511
            dict(pos=[0, 5, 200, 511, 511, 511, 300, 17], dtype=dtype, S=512),
            dict(pos=[299, 0, 64, 150], dtype=dtype, B=4, S=300, H=8, KV=2, hd=128),  # GQA
            dict(pos=uneven, dtype=dtype, poison=True),
            dict(pos=[5, 15], dtype=dtype, B=2, S=16, hd=16),  # REDUCED widths
            # a long cache: each cluster block walks many batches of rows
            dict(pos=[8191, 0, 1, 2, 4095, 5000, 7777, 300], dtype=dtype, S=8192),
            # 12 and 48 query heads a KV head: head groups of 6 and 8
            dict(pos=uneven, dtype=dtype, H=12, hd=128),
            dict(pos=uneven, dtype=dtype, H=48, hd=128),
            # zamba2-7b's shared block: 32 heads over 32, head_dim 112 (224-byte
            # bf16 rows, 14 loads of 16 B; one head a KV head: simt)
            dict(pos=uneven, dtype=dtype, H=32, KV=32, hd=112),
            # the dense family: stablelm-12b (32 over 8, hd 160: 20 loads of 16
            # B a bf16 row) and minitron-8b (32 over 8, hd 128)
            dict(pos=uneven, dtype=dtype, H=32, KV=8, hd=160),
            dict(pos=uneven, dtype=dtype, H=32, KV=8, hd=128),
            # hd 80 (train_100m's widths), G = 4; hd 112 at G = 8 (kimi-k2's)
            dict(pos=uneven, dtype=dtype, H=8, KV=2, hd=80, poison=True),
            dict(pos=[299, 0, 150, 77], dtype=dtype, B=4, S=300, H=64, KV=8, hd=112),
            # the remaining families' ticks: grok-1's dense serve (48 over 8,
            # hd 128), paligemma-3b (8 over 1, hd 256, 352-deep caches),
            # whisper-small (12 over 12, hd 64, 144-deep)
            dict(pos=uneven, dtype=dtype, H=48, KV=8, hd=128),
            dict(pos=[320] * 8, dtype=dtype, S=352, H=8, KV=1, hd=256),
            dict(pos=[80, 80, 80, 80, 143, 0, 16, 17], dtype=dtype, S=144, H=12, KV=12, hd=64),
        ]
    # rows that are not whole 16-byte loads: element loads on the simt walk
    cases += [dict(pos=[299, 0, 150, 77], dtype=torch.float32, B=4, S=300, H=4, KV=2, hd=18,
                   poison=True),
              dict(pos=uneven, dtype=torch.float32, H=4, KV=2, hd=18),
              dict(pos=uneven, dtype=torch.bfloat16, H=12, KV=2, hd=36, poison=True),
              dict(pos=[5, 15], dtype=torch.bfloat16, B=2, S=16, H=6, KV=1, hd=36)]
    worst, worst_tol = 0.0, None
    for case in cases:
        q, k, v, pos = _decode_case(torch, gen, **case)
        got = decode_attention.decode_attention(q, k, v, pos)
        want = ref.decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        name = str(case["dtype"]).split(".")[-1]
        err, ok = _max_err_and_ok(torch, got, want, TOL[name])
        desc = ", ".join(f"{k_}={v_}" for k_, v_ in case.items() if k_ != "dtype")
        log(f"[kernels] decode_attention {name} {desc} ({decode_core.variant(q, k)}): "
            f"max_abs_err={err:.3e} tol={TOL[name]} {'ok' if ok else 'FAIL'}")
        require(ok, f"decode_attention disagrees with its plain version ({desc}, {name})")
        if err > worst:
            worst, worst_tol = err, TOL[name]

    # timing at the dense serving path's global-layer shape: 8 slots, uneven
    # positions in the 1088-deep cache, bf16
    q, k, v, pos = _decode_case(torch, gen, pos=uneven, dtype=torch.bfloat16)
    t_kernel = time_ms(torch, lambda: decode_attention.decode_attention(q, k, v, pos), iters=100)
    t_plain = time_ms(torch, lambda: ref.decode_attention(q, k, v, pos))
    d_kernel = device_ms(torch, lambda: decode_attention.decode_attention(q, k, v, pos))
    d_plain = device_ms(torch, lambda: ref.decode_attention(q, k, v, pos))
    d_cold = cold_device_ms(
        torch, lambda k_, v_: decode_attention.decode_attention(q, k_, v_, pos), (k, v),
        k.nbytes + v.nbytes)
    d_plain_cold = cold_device_ms(torch, lambda k_, v_: ref.decode_attention(q, k_, v_, pos),
                                  (k, v), k.nbytes + v.nbytes)
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    # the library yardstick: one SDPA call with a boolean validity mask
    qt, kt, vt = q[:, :, None, :], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_lib = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=100)
    d_lib = device_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    lib_out = sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)[:, :, 0]
    lib_err = float((lib_out.float() - ref.decode_attention(q, k, v, pos).float()).abs().max())
    # the paged kernel on the same cache and positions: a pool of 16-position
    # pages (the serving layout) and one page per slot; the one core gives
    # bitwise the dense kernel's output either way
    n_pages = S // 16
    pool_k, pool_v = k.view(B * n_pages, 16, KV, hd), v.view(B * n_pages, 16, KV, hd)
    tbl16 = torch.arange(B * n_pages, dtype=torch.int32, device="cuda").view(B, n_pages)
    tbl1 = torch.arange(B, dtype=torch.int32, device="cuda").view(B, 1)
    dense_out = decode_attention.decode_attention(q, k, v, pos)
    for name, args in (("page 16", (pool_k, pool_v, tbl16)), ("page S", (k, v, tbl1))):
        paged_out = paged_decode_attention.paged_decode_attention(q, *args, pos)
        require(torch.equal(paged_out, dense_out),
                f"paged kernel ({name}) not bitwise equal to the dense kernel on one cache")
    # the same at the mma walk's padded ring rows (hd 80, 112, 160; G = 4, 2, 8)
    for H_, KV_, hd_ in ((8, 2, 80), (8, 4, 112), (64, 8, 112), (32, 8, 160)):
        q_, k_, v_, pos_ = _decode_case(torch, gen, pos=uneven, dtype=torch.bfloat16, H=H_,
                                        KV=KV_, hd=hd_)
        require(decode_core.variant(q_, k_) == "mma", f"hd {hd_} does not take mma")
        pk, pv = (x.view(B * n_pages, 16, KV_, hd_) for x in (k_, v_))
        require(torch.equal(paged_decode_attention.paged_decode_attention(q_, pk, pv, tbl16, pos_),
                            decode_attention.decode_attention(q_, k_, v_, pos_)),
                f"paged kernel at hd {hd_}, {H_} over {KV_} not bitwise equal to the dense one")
        del q_, k_, v_, pk, pv
    d_paged = device_ms(torch, lambda: paged_decode_attention.paged_decode_attention(
        q, pool_k, pool_v, tbl16, pos))
    cluster, kind = decode_core.cluster_size(q, k), decode_core.variant(q, k)
    require(kind == "mma", f"decode_attention timed on {kind}, expected mma")

    def timed_with(attr, value):
        # the same two calls with a rule of `decode_core` swapped, for the
        # record: clusters of 16 (the non-portable size) in place of the cap
        # of 8, or the exact-FMA walk in place of the tensor cores
        return _with_decode_rule(attr, value, lambda: (
            device_ms(torch, lambda: decode_attention.decode_attention(q, k, v, pos)),
            device_ms(torch, lambda: paged_decode_attention.paged_decode_attention(
                q, pool_k, pool_v, tbl16, pos))))

    d16, d16_paged = timed_with("MAX_CLUSTER", 16)
    d_simt, d_simt_paged = timed_with("variant", lambda q_, k_: "simt")
    zamba2 = _decode_timing(torch, gen, uneven, "zamba2-7b decode", H=32, KV=32, hd=112)
    stablelm = _decode_timing(torch, gen, uneven, "stablelm-12b decode", H=32, KV=8, hd=160,
                              want_kind="mma")
    grok = _decode_timing(torch, gen, uneven, "grok-1-314b dense decode", H=48, KV=8, hd=128,
                          want_kind="mma")
    paligemma = _decode_timing(torch, gen, [320] * 8, "paligemma-3b decode", H=8, KV=1, hd=256,
                               S=352, want_kind="mma")
    whisper = _decode_timing(torch, gen, [80] * 8, "whisper-small decode", H=12, KV=12, hd=64,
                             S=144, want_kind="mma")
    ragged = [_decode_timing(torch, gen, uneven, f"hd {hd} {dt} (rows not whole 16-byte loads)",
                             H=4, KV=2, hd=hd, dtype=getattr(torch, dt))
              for hd, dt in ((18, "float32"), (36, "bfloat16"))]
    n_valid = sum(p + 1 for p in uneven)
    elem = q.element_size()
    n_bytes = 2 * q.numel() * elem + 2 * n_valid * KV * hd * elem + B * 4
    flops = 4 * H * hd * n_valid
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    log(f"[kernels] decode_attention timing B={B} S={S} H={H} KV={KV} hd={hd} pos={uneven} "
        f"bf16: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, sdpa {t_lib:.4f} ms (sdpa "
        f"max_abs_err vs plain {lib_err:.3e}); device time per call: kernel {d_kernel:.4f} ms "
        f"(one launch), plain {d_plain:.4f} ms, sdpa {d_lib:.4f} ms; with the caches "
        f"cold in L2: kernel "
        f"{d_cold:.4f} ms, plain {d_plain_cold:.4f} ms; variant {kind}, cluster of {cluster} "
        f"blocks per (slot, KV head); bound {max(b_bytes, b_ops) * 1e3:.3f} us "
        f"({n_bytes} B, {flops} FLOP); {flops / (d_kernel * 1e-3) / 1e12:.3f} TFLOP/s on the "
        f"device time")
    log(f"[kernels] decode_attention vs paged_decode_attention at the same {n_valid} valid "
        f"positions (one cache, 16-position pages, outputs bitwise equal): device {d_kernel:.4f} "
        f"ms dense, {d_paged:.4f} ms paged ({d_paged / d_kernel:.3f}x); with clusters of "
        f"16: {d16:.4f} ms dense, {d16_paged:.4f} ms paged; on the simt walk: {d_simt:.4f} ms "
        f"dense, {d_simt_paged:.4f} ms paged")
    for k_ in ("mma", "simt"):
        log(f"[kernels] decode_attention ptxas: "
            f"{decode_ptxas('DenseRows', q.dtype, hd, H // KV, k_)}")
    for hd_, G_ in ((80, 4), (112, 1), (160, 4)):
        log(f"[kernels] decode_attention ptxas: "
            f"{decode_ptxas('DenseRows', q.dtype, hd_, G_, 'mma')}")
    return {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:70",
        "launches": 0,
        "max_abs_err": worst,
        "tolerance": worst_tol,
        "ms": t_kernel,
        "plain_ms": t_plain,
        "device_ms": d_kernel,
        "plain_device_ms": d_plain,
        "cold_device_ms": d_cold,
        "plain_cold_device_ms": d_plain_cold,
        "bound_ms": max(b_bytes, b_ops),
        "bound_us": max(b_bytes, b_ops) * 1e3,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": t_lib,
        "library_device_ms": d_lib,
        "tflops": flops / (d_kernel * 1e-3) / 1e12,
        "cluster": cluster,
        "variant": kind,
        "paged_same_positions_device_ms": d_paged,
        "timed_shape": f"B={B} S={S} H={H} KV={KV} hd={hd} bf16, {n_valid} valid positions",
        "other_timings": [zamba2, stablelm, grok, paligemma, whisper] + ragged,
    }


def _decode_timing(torch, gen, pos, label, *, H, KV, hd, S=1088, want_kind="simt",
                   dtype=None) -> dict:
    """The dense kernel at a decode tick's shape (8 slots, `S`-deep caches,
    bf16 unless `dtype`) on the walk `want_kind`, beside its plain version
    and SDPA and, where the operands could take both walks (bf16 at the
    `mma` head dims), the other walk on the same operands, with the bound."""
    from repro_torch.kernels import decode_attention, decode_core, ref

    dtype = dtype or torch.bfloat16
    name = str(dtype).split(".")[-1]
    q, k, v, pos_t = _decode_case(torch, gen, pos=pos, dtype=dtype, S=S, H=H, KV=KV, hd=hd)
    kind = decode_core.variant(q, k)
    require(kind == want_kind, f"decode_attention ({label}) ran {kind}, expected {want_kind}")
    err, ok = _max_err_and_ok(torch, decode_attention.decode_attention(q, k, v, pos_t),
                              ref.decode_attention(q, k, v, pos_t), TOL[name])
    require(ok, f"decode_attention ({label}) disagrees with its plain version: {err:.3e}")
    d_kernel = device_ms(torch, lambda: decode_attention.decode_attention(q, k, v, pos_t))
    d_plain = device_ms(torch, lambda: ref.decode_attention(q, k, v, pos_t))
    d_cold = cold_device_ms(
        torch, lambda k_, v_: decode_attention.decode_attention(q, k_, v_, pos_t), (k, v),
        k.nbytes + v.nbytes)
    other = {"mma": "simt", "simt": "mma"}[kind]
    both = dtype == torch.bfloat16 and hd in decode_core.MMA_HEAD_DIMS
    d_other = (_walk_beside(torch, lambda: decode_attention.decode_attention(q, k, v, pos_t),
                            other) if both else None)
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qt, kt, vt = q[:, :, None, :], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :] <= pos_t[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    d_lib = device_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    n_valid = sum(p + 1 for p in pos)
    elem = q.element_size()
    n_bytes = 2 * q.numel() * elem + 2 * n_valid * KV * hd * elem + B * 4
    flops = 4 * H * hd * n_valid
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[name] * 1e3
    shape = (f"{label}: B={B} S={S} H={H} KV={KV} hd={hd} {name}, {n_valid} valid "
             f"positions ({kind}, cluster of {decode_core.cluster_size(q, k)})")
    log(f"[kernels] decode_attention timing {shape}: max_abs_err={err:.3e}; device time per call: kernel "
        f"{d_kernel:.4f} ms, {other} walk on the same operands "
        f"{d_other if d_other is None else f'{d_other:.4f}'} ms, plain {d_plain:.4f} ms, sdpa "
        f"{d_lib:.4f} ms; kernel with the caches cold in L2 {d_cold:.4f} ms; bound "
        f"{max(b_bytes, b_ops) * 1e3:.3f} us ({n_bytes} B, {flops} FLOP)")
    return dict(shape=shape, variant=kind, max_abs_err=err, device_ms=d_kernel,
                **{f"{other}_device_ms": d_other}, plain_device_ms=d_plain,
                cold_device_ms=d_cold, library_device_ms=d_lib,
                bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations")


def _linear_bound_ms(M, K, N, elem, dtype_name) -> tuple:
    n_bytes = (M * K + K * N + N + M * N) * elem
    flops = 2 * M * N * K
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations"), n_bytes, flops


#: the variant fused_linear's rule names for each checked (dtype, M, K, N)
#: on a card of 132 SMs: simt_small where W and 16 rows of x fit 48 KB and
#: the product is under a wave of 64 x 64 tiles (Test Case 2's layers,
#: ragged and tiny products; bf16 where TMA's alignment fails), wgmma for
#: bf16 with K, N multiples of 8, simt for the rest of fp32's small products
LINEAR_KINDS = {
    **{("float32", M, K, N): "simt_small" for M, K, N in ((256, 64, 32), (256, 32, 10),
                                                         (77, 50, 10))},
    ("float32", 128, 128, 128): "simt", ("float32", 256, 384, 128): "simt",
    **{("bfloat16", M, K, N): "wgmma" for M, K, N in ((256, 64, 32), (128, 128, 128),
                                                     (256, 384, 128), (1000, 520, 264),
                                                     (300, 72, 8), (1536, 1024, 1280))},
    ("bfloat16", 256, 32, 10): "simt_small", ("bfloat16", 77, 50, 10): "simt_small",
}


def _linear_simt(torch, x, w, b, act):
    """The `simt` fused_linear at operands the rule gives to `simt_small`:
    its C entry point with the simt code, for the before-and-after timing
    only (no launch is counted: no path runs it); the twin of `_fwd_simt`."""
    from repro_torch.kernels import build, fused_linear

    y = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype, device=x.device)
    err = fused_linear._entry()(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), x.shape[0], w.shape[1],
        x.shape[1], fused_linear._DTYPE_CODES[x.dtype], fused_linear.ACTS[act],
        fused_linear._VARIANT_CODES["simt"], torch.cuda.current_stream().cuda_stream)
    build.check(err, "fused_linear (simt, timing)")
    return y


def check_fused_linear(torch, gen) -> dict:
    from repro_torch.kernels import build, fused_linear

    torch.backends.cuda.matmul.allow_tf32 = False  # plain and library products in full fp32
    shapes = [(256, 64, 32), (256, 32, 10), (128, 128, 128), (256, 384, 128), (77, 50, 10)]
    # ragged tiles on the tensor cores, and a product over 1024^3
    bf16_shapes = [(1000, 520, 264), (300, 72, 8), (1536, 1024, 1280)]
    worst, worst_tol = 0.0, None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for M, K, N in shapes + (bf16_shapes if dtype == torch.bfloat16 else []):
            x, w, b = (0.3 * torch.randn(sh, generator=gen, device="cuda")
                       for sh in ((M, K), (K, N), (N,)))
            x, w, b = (t.to(dtype) for t in (x, w, b))
            for act in ("none", "relu", "gelu"):
                out = []
                kind = launched_variant(fused_linear, lambda: out.append(
                    fused_linear.fused_linear(x, w, b, act=act)))
                got = out[0]
                want = fused_linear.fused_linear_ref(x, w, b, act=act)
                torch.cuda.synchronize()
                err, ok = _max_err_and_ok(torch, got, want, LINEAR_TOL[name])
                ok = ok and got.dtype == dtype
                log(f"[kernels] fused_linear {name} M={M} K={K} N={N} act={act} ({kind}): "
                    f"max_abs_err={err:.3e} tol={LINEAR_TOL[name]} {'ok' if ok else 'FAIL'}")
                require(ok, f"fused_linear disagrees with its plain version "
                        f"(M={M} K={K} N={N} act={act}, {name})")
                want_kind = LINEAR_KINDS[name, M, K, N]
                require(kind == want_kind, f"fused_linear {name} M={M} K={K} N={N} ran {kind}, "
                        f"expected {want_kind}")
                if err > worst:
                    worst, worst_tol = err, LINEAR_TOL[name]

    def timings(M, K, N, dtype, act, iters):
        x, w, b = (0.3 * torch.randn(sh, generator=gen, device="cuda")
                   for sh in ((M, K), (K, N), (N,)))
        x, w, b = (t.to(dtype) for t in (x, w, b))
        kind = launched_variant(fused_linear, lambda: fused_linear.fused_linear(x, w, b, act=act))
        beside = {}
        if kind == "simt_small":  # the simt kernel on the same operands, as before
            simt_err, simt_ok = _max_err_and_ok(
                torch, _linear_simt(torch, x, w, b, act),
                fused_linear.fused_linear_ref(x, w, b, act=act), LINEAR_TOL["float32"])
            require(simt_ok, f"fused_linear simt M={M} K={K} N={N} disagrees: {simt_err:.3e}")
            beside = dict(simt_device_ms=device_ms(
                torch, lambda: _linear_simt(torch, x, w, b, act), iters=iters), simt_err=simt_err)
        t_kernel = time_ms(torch, lambda: fused_linear.fused_linear(x, w, b, act=act), iters=iters)
        t_plain = time_ms(torch, lambda: fused_linear.fused_linear_ref(x, w, b, act=act),
                          iters=iters)
        t_lib = time_ms(torch, lambda: torch.addmm(b, x, w), iters=iters)
        d_kernel = device_ms(torch, lambda: fused_linear.fused_linear(x, w, b, act=act),
                             iters=iters)
        d_plain = device_ms(torch, lambda: fused_linear.fused_linear_ref(x, w, b, act=act),
                            iters=iters)
        d_lib = device_ms(torch, lambda: torch.addmm(b, x, w), iters=iters)
        name = str(dtype).split(".")[-1]
        bound, by, n_bytes, flops = _linear_bound_ms(M, K, N, x.element_size(), name)
        err = float((fused_linear.fused_linear(x, w, b, act=act).float()
                     - fused_linear.fused_linear_ref(x, w, b, act=act).float()).abs().max())
        if beside:
            beside["device_ms_again"] = device_ms(
                torch, lambda: fused_linear.fused_linear(x, w, b, act=act), iters=iters)
        log(f"[kernels] fused_linear timing M={M} K={K} N={N} {name} act={act} ({kind}): kernel "
            f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, addmm {t_lib:.4f} ms (bias only; the "
            f"activation would be one more launch); device time per call: kernel "
            f"{d_kernel:.4f} ms, plain {d_plain:.4f} ms, addmm {d_lib:.4f} ms"
            + (f", simt on the same operands {beside['simt_device_ms']:.4f} ms (max_abs_err "
               f"{beside['simt_err']:.3e}), {kind} again {beside['device_ms_again']:.4f} ms"
               if beside else "")
            + f"; max_abs_err vs plain {err:.3e}; bound "
            f"{bound * 1e3:.3f} us by {by} ({n_bytes} B, {flops} FLOP); "
            f"{flops / (d_kernel * 1e-3) / 1e12:.2f} TFLOP/s on the device time")
        return dict(shape=f"M={M} K={K} N={N} {name} act={act}", variant=kind, ms=t_kernel,
                    plain_ms=t_plain, device_ms=d_kernel, plain_device_ms=d_plain,
                    library_ms=t_lib, library_device_ms=d_lib, bound_ms=bound, bound_by=by,
                    max_abs_err=err, tflops=flops / (d_kernel * 1e-3) / 1e12, **beside)

    # the Test Case 2 path: layer 1 (256 x 64 @ 64 x 32, relu) and layer 2
    # (256 x 32 @ 32 x 10, none), fp32, each beside simt on the same operands
    main = timings(256, 64, 32, torch.float32, "relu", iters=100)
    layer2 = timings(256, 32, 10, torch.float32, "none", iters=100)
    large = [timings(*LARGE_GEMM, torch.float32, "none", iters=5),
             timings(*LARGE_GEMM, torch.bfloat16, "none", iters=5)]
    require([main["variant"], layer2["variant"], large[0]["variant"], large[1]["variant"]]
            == ["simt_small", "simt_small", "simt_tiled", "wgmma"],
            f"timed fused_linear variants {main['variant']}, {layer2['variant']}, "
            f"{large[0]['variant']}, {large[1]['variant']}; expected simt_small, simt_small, "
            f"simt_tiled, wgmma")
    # either side of the fp32 cut-over at a wave of 128 x 128 tiles: n x n
    # tiles just under the card's SM count (simt), (n + 1) x (n + 1) over it
    n = math.isqrt(build.sm_count(torch.device("cuda")) - 1)
    cut = [timings(128 * side, 1024, 128 * side, torch.float32, "none", iters=20)
           for side in (n, n + 1)]
    require([t["variant"] for t in cut] == ["simt", "simt_tiled"],
            f"fused_linear around the cut-over ran {[t['variant'] for t in cut]}")
    return {
        "name": "fused_linear",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_linear.cu",
        "replaces": "src/repro/kernels/fused_linear.py:44",
        "launches": 0,
        "max_abs_err": worst,
        "tolerance": worst_tol,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "device_ms": main["device_ms"],
        "plain_device_ms": main["plain_device_ms"],
        "bound_ms": main["bound_ms"],
        "bound_us": main["bound_ms"] * 1e3,
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_device_ms": main["library_device_ms"],
        "tflops": main["tflops"],
        "variant": main["variant"],
        "timed_shape": main["shape"],
        "variants": {"simt_small": main["device_ms"], "simt": main["simt_device_ms"],
                     "simt_tiled": large[0]["device_ms"], "wgmma": large[1]["device_ms"]},
        "other_timings": [layer2] + large + cut,
    }


def scan_check_chunk(S: int) -> int:
    """Chunk of the plain version the scan kernels are held against: at most
    16 positions. The plain version cumulates the log decay in fp32 over a
    chunk, and at xlstm's dk = 384 a chunk of 128 leaves rounding in the gates
    that alone exceeds the fp32 tolerance against a float64 recurrence; at 16
    positions it does not. The kernels ignore the chunk (fp64 decay)."""
    return math.gcd(S, 16)


def _scan_case(torch, gen, *, B, H, S, dk, dv, dtype, init=False, shared_qk=False,
               norm=False, mamba=False, **_):
    """Scan inputs laid out as the model paths hand them over: q, k, v are
    head-split views of (B, S, H, d) projections and log_a a view of a
    (B, S, H) gate (the mLSTM), or q and k one (B, S, dk) tensor broadcast
    over the heads (`shared_qk`), or, with `mamba`, exactly as
    `models/ssm.py::mamba_forward` makes them: q the C slice of an xBC
    projection broadcast over the heads (stride 0), k = B * dt per head, v
    the x slice split into heads, log_a = dt * A transposed. Scales follow
    `tests/test_kernels.py::TestGatedLinearScan`. `init`: False, True (a
    random carried state) or "zeros" (the zero state a prefill carries).
    Returns (q, k, v, log_a, keyword arguments of the call: initial states,
    the normaliser)."""
    if mamba:
        xbc = 0.5 * torch.randn((B, S, H * dv + 2 * dk), generator=gen, device="cuda")
        x_ssm, b_mat, c_mat = torch.split(xbc.to(dtype), [H * dv, dk, dk], dim=-1)
        dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device="cuda"))
        a = -torch.rand((H,), generator=gen, device="cuda") - 0.5
        q = c_mat[:, None].expand(B, H, S, dk)
        k = (b_mat[:, None] * dt.transpose(1, 2)[..., None]).to(dtype)
        v = x_ssm.reshape(B, S, H, dv).transpose(1, 2)
        log_a = (dt * a).transpose(1, 2)
    kw = {}
    if init:
        kw["initial_state"] = (torch.zeros((B, H, dk, dv), device="cuda") if init == "zeros"
                               else 0.5 * torch.randn((B, H, dk, dv), generator=gen,
                                                      device="cuda"))
    if mamba:
        return q, k, v, log_a, kw

    def heads(d, shared=False):
        if shared:
            x = 0.5 * torch.randn((B, 1, S, d), generator=gen, device="cuda")
            return x.to(dtype).expand(B, H, S, d)
        x = 0.5 * torch.randn((B, S, H, d), generator=gen, device="cuda")
        return x.to(dtype).transpose(1, 2)

    q, k, v = heads(dk, shared_qk), heads(dk, shared_qk), heads(dv)
    log_a = -torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda")).transpose(1, 2)
    if norm:
        kw["normaliser"] = True
        if init:
            kw["initial_normaliser"] = torch.randn((B, H, dk, 1), generator=gen, device="cuda")
    return q, k, v, log_a, kw


def _scan_plain(ref, q, k, v, log_a, chunk, kw):
    """The plain version of the call `kw` describes (with the normaliser:
    the reference's two scans)."""
    if kw.get("normaliser"):
        return ref.gated_linear_scan_normalised(
            q, k, v, log_a, chunk=chunk, initial_state=kw.get("initial_state"),
            initial_normaliser=kw.get("initial_normaliser"))
    return ref.gated_linear_scan(q, k, v, log_a, chunk=chunk,
                                 initial_state=kw.get("initial_state"))


def _scan_bound_ms(B, H, S, dk, dv, elem, dtype_name, init, norm) -> tuple:
    """The least time of the work itself, whatever a kernel's chunk. Bytes:
    q, k, v, log_a and the initial states read once, y, nrm and the final
    states written once. Operations: the two state products of the
    recurrence, 4 S dk dv per (b, h) (the read q_t S_t and the update
    k_t^T v_t, 2 S dk dv each), and the normaliser's 4 S dk."""
    cols = dv + (1 if norm else 0)
    n_bytes = (B * H * S * (2 * dk + 2 * cols) * elem + B * H * S * 4
               + B * H * dk * cols * 4 * (2 if init else 1))
    flops = B * H * 4 * S * dk * cols
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations"), n_bytes, flops


def scan_rounding_errors(torch, q, k, v, log_a, L: int = 32) -> dict:
    """Max |y - y_exact| that each way of feeding the fp32 operands of the
    tensor-core scan to bf16 products would leave on these inputs: the plain
    chunked algorithm (chunks of L, fp64 decay) with P, the state read by
    q (S_prev) and Vsc = v exp(a_tot - A) rounded as each choice rounds them
    (q, k and v are exact in bf16), against the same algorithm unrounded.
    Choices: "bf16" (one bf16 operand), "tf32" (10-bit mantissa, what TF32
    m16n8k8 reads), "bf16 hi+lo" (the kernel's: two bf16 products)."""
    B, H, S, dk = q.shape
    C = S // L
    qf, kf, vf = (t.float().reshape(B, H, C, L, -1) for t in (q, k, v))
    A = torch.cumsum(log_a.double().reshape(B, H, C, L), -1)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    gates = torch.where(tri, torch.exp(A[..., :, None] - A[..., None, :]), 0.0).float()
    P = torch.einsum("bhcid,bhcjd->bhcij", qf, kf) * gates
    Vsc = vf * torch.exp(A[..., -1:] - A).float()[..., None]
    eA, e_tot = torch.exp(A).float(), torch.exp(A[..., -1]).float()

    def bf(x):
        return x.bfloat16().float()

    rounds = {"exact": lambda x: x, "bf16": bf,
              "tf32": lambda x: (x.view(torch.int32) & ~0x1FFF).view(torch.float32),
              "bf16 hi+lo": lambda x: bf(x) + bf(x - bf(x))}
    ys = {}
    for name, rnd in rounds.items():
        chunk_states = torch.einsum("bhcjd,bhcjv->bhcdv", kf, rnd(Vsc))
        state = torch.zeros((B, H, dk, v.shape[-1]), device=q.device)
        y = torch.empty_like(vf)
        for c in range(C):
            y[:, :, c] = (torch.einsum("bhid,bhdv->bhiv", qf[:, :, c], rnd(state))
                          * eA[:, :, c, :, None]
                          + torch.einsum("bhij,bhjv->bhiv", rnd(P[:, :, c]), vf[:, :, c]))
            state = e_tot[:, :, c, None, None] * state + chunk_states[:, :, c]
        ys[name] = y
    return {name: float((y - ys["exact"]).abs().max()) for name, y in ys.items() if name != "exact"}


def check_scan(torch, gen) -> dict:
    from repro_torch.kernels import build, linear_scan, ref
    from repro_torch.models.ssm import _chunk_for

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    bf16, fp32 = torch.bfloat16, torch.float32
    xl = dict(H=4, dk=384, dv=384)  # xlstm-125m's mLSTM: 4 heads of 384
    mamba2 = dict(H=32, S=1024, dk=64, dv=224, shared_qk=True)
    cases = [
        # the paths' shapes: the mLSTM's one call (y and normaliser) and its
        # parts alone, Mamba2's single call
        dict(xl, tag="loss", B=4, S=2048, dtype=bf16, norm=True, want="mma"),
        dict(xl, tag="loss-y-only", B=4, S=2048, dtype=bf16, want="mma"),
        dict(xl, tag="loss-normaliser-alone", B=4, S=2048, dtype=bf16, dv=1, want="simt"),
        dict(xl, tag="prefill-777", B=1, S=777, dtype=bf16, norm=True, want="mma"),
        dict(xl, tag="prefill-777-state", B=1, S=777, dtype=bf16, init=True, norm=True,
             want="mma"),
        dict(xl, tag="prefill-300-b2", B=2, S=300, dtype=bf16, norm=True, want="mma"),
        dict(xl, tag="serial-prefill", B=8, S=512, dtype=bf16, norm=True, want="mma"),
        dict(xl, tag="decode", B=8, S=1, dtype=bf16, init=True, norm=True, want="step"),
        dict(xl, tag="decode-y-only", B=8, S=1, dtype=bf16, init=True, want="step"),
        dict(xl, tag="decode-normaliser-alone", B=8, S=1, dtype=bf16, dv=1, init=True,
             want="step"),
        dict(xl, tag="step-16", B=2, S=16, dtype=bf16, init=True, norm=True, want="step"),
        dict(xl, tag="mma-17", B=2, S=17, dtype=bf16, init=True, norm=True, want="mma"),
        dict(mamba2, tag="mamba2", B=1, dtype=bf16, want="mma"),
        # zamba2-7b's Mamba2 layers, operands laid out as `mamba_forward`
        # makes them: a decode tick of 8 slots carrying the state, and a
        # ragged prefill from the zero state
        dict(mamba2, tag="mamba2-tick", B=8, S=1, dtype=bf16, init=True, mamba=True,
             want="step"),
        dict(mamba2, tag="mamba2-prefill-777", B=1, S=777, dtype=bf16, init="zeros",
             mamba=True, want="mma"),
        dict(mamba2, tag="mamba2-prefill-45-state", B=2, S=45, dtype=bf16, init=True,
             mamba=True, want="mma"),
        dict(mamba2, tag="fp32-mamba2-tick", B=8, S=1, dtype=fp32, init=True, mamba=True,
             want="step"),
        dict(xl, tag="fp32-512", B=2, S=512, dtype=fp32, norm=True, want="simt"),
        dict(xl, tag="fp32-777-state", B=1, S=777, dtype=fp32, init=True, norm=True,
             want="simt"),
        dict(xl, tag="fp32-decode", B=8, S=1, dtype=fp32, init=True, norm=True, want="step"),
        dict(mamba2, tag="fp32-mamba2", B=1, dtype=fp32, want="simt"),
        dict(tag="fp32-reduced", B=2, H=4, S=45, dk=32, dv=32, dtype=fp32, init=True, norm=True,
             want="simt"),
        dict(tag="fp32-reduced-tick", B=3, H=4, S=1, dk=32, dv=32, dtype=fp32, init=True,
             norm=True, want="step"),
        dict(tag="bf16-reduced", B=2, H=4, S=45, dk=32, dv=32, dtype=bf16, init=True, norm=True,
             want="mma"),
        # the reference's SCAN_SHAPES (tests/test_kernels.py)
        *[dict(tag=f"ref-{B}x{H}x{S}x{dk}x{dv}", B=B, H=H, S=S, dk=dk, dv=dv, dtype=dt,
               want="simt" if dt == fp32 else "mma")
          for B, H, S, dk, dv in [(1, 1, 128, 32, 32), (2, 4, 256, 64, 64), (1, 2, 256, 16, 64),
                                  (2, 2, 512, 32, 16)] for dt in (fp32, bf16)],
    ]
    worst, worst_tol, tiles = 0.0, None, set()
    for case in cases:
        q, k, v, log_a, kw = _scan_case(torch, gen, **case)
        chunk = scan_check_chunk(case["S"])
        kind = linear_scan.variant(q, k, v)
        before = dict(linear_scan.variant_launches)
        got = linear_scan.gated_linear_scan(q, k, v, log_a, chunk=chunk, **kw)
        want = _scan_plain(ref, q, k, v, log_a, chunk, kw)
        torch.cuda.synchronize()
        moved = {n: c - before[n] for n, c in linear_scan.variant_launches.items()
                 if c != before[n]}
        name = str(case["dtype"]).split(".")[-1]
        errs, ok = [], kind == case["want"] and moved == {kind: 1}
        for x, ref_x, out_dtype in zip(got, want, (case["dtype"], fp32) * 2):
            err, ok_x = _max_err_and_ok(torch, x, ref_x, TOL[name])
            errs.append(err)
            ok = ok and ok_x and x.dtype == out_dtype and x.shape == ref_x.shape
        tile = ""
        if kind == "mma":
            t = linear_scan.tile_columns(case["B"], case["H"], case["dv"] + int(bool(case.get(
                "norm"))), build.sm_count(q.device))
            tiles.add(t)
            tile = f", tile {t} columns"
        desc = ", ".join(f"{k_}={v_}" for k_, v_ in case.items() if k_ not in ("dtype", "want"))
        log(f"[kernels] gated_linear_scan {name} {desc} ({kind}{tile}): max_abs_err "
            f"{'/'.join(f'{e:.3e}' for e in errs)} (y/state{'/nrm/n' if len(errs) > 2 else ''}) "
            f"tol={TOL[name]} {'ok' if ok else 'FAIL'}")
        require(ok, f"gated_linear_scan disagrees with its plain version or took another "
                    f"variant than {case['want']} ({desc}, {name}: {kind}, launches {moved})")
        if max(errs) > worst:
            worst, worst_tol = max(errs), TOL[name]
    require(tiles == set(linear_scan.MMA_TILES),
            f"the checked shapes took tiles {sorted(tiles)}, not all of {linear_scan.MMA_TILES}")

    def timings(case, iters):
        q, k, v, log_a, kw = _scan_case(torch, gen, **case)
        chunk = _chunk_for(case["S"])
        kern = lambda q_, k_, v_, la_: linear_scan.gated_linear_scan(  # noqa: E731
            q_, k_, v_, la_, chunk=chunk, **kw)
        plain = lambda: _scan_plain(ref, q, k, v, log_a, chunk, kw)  # noqa: E731
        t_kernel = time_ms(torch, lambda: kern(q, k, v, log_a), iters=iters)
        t_plain = time_ms(torch, plain, iters=iters)
        d_kernel = device_ms(torch, lambda: kern(q, k, v, log_a), iters=iters)
        d_plain = device_ms(torch, plain, iters=iters)
        ins = (q, k, v, log_a)
        nbytes = sum(t.untyped_storage().nbytes() for t in ins)
        # (a clone of a broadcast or strided view is contiguous: Mamba2's
        # cold copies hold q per head, a few more bytes than the path reads)
        d_cold = cold_device_ms(torch, kern, ins, nbytes)
        name = str(case["dtype"]).split(".")[-1]
        B, H, S, dk, dv = (case[x] for x in ("B", "H", "S", "dk", "dv"))
        init, norm = "initial_state" in kw, bool(kw.get("normaliser"))
        bound, by, n_bytes, flops = _scan_bound_ms(B, H, S, dk, dv, q.element_size(), name,
                                                   init, norm)
        kind = linear_scan.variant(q, k, v)
        shape = (f"{case['tag']}: B={B} H={H} S={S} dk={dk} dv={dv} {name}"
                 f"{' with initial_state' if init else ''}{' + normaliser' if norm else ''}"
                 f" ({kind})")
        log(f"[kernels] gated_linear_scan timing {shape}: kernel {t_kernel:.4f} ms, plain "
            f"{t_plain:.4f} ms; device time per call: kernel {d_kernel:.4f} ms, plain "
            f"{d_plain:.4f} ms, kernel with the inputs cold in L2 {d_cold:.4f} ms; bound "
            f"{bound * 1e3:.3f} us by {by} ({n_bytes} B, {flops} FLOP; kernel at "
            f"{d_kernel / bound:.1f}x the bound); {flops / (d_kernel * 1e-3) / 1e12:.2f} "
            f"TFLOP/s on the device time")
        return dict(shape=shape, ms=t_kernel, plain_ms=t_plain, device_ms=d_kernel,
                    plain_device_ms=d_plain, cold_device_ms=d_cold, bound_ms=bound, bound_by=by,
                    tflops=flops / (d_kernel * 1e-3) / 1e12)

    # what each way of rounding the fp32 operands to bf16 products would
    # leave at the loss shape (y only; the kernel's own error is above)
    by_tag = {case["tag"]: case for case in cases}
    q, k, v, log_a, _ = _scan_case(torch, gen, **by_tag["loss-y-only"])
    rounding = scan_rounding_errors(torch, q, k, v, log_a)
    log(f"[kernels] gated_linear_scan at the loss shape: max |y - y exact| of the chunked "
        f"algorithm with P, S_prev and Vsc rounded as each choice rounds them: "
        f"{', '.join(f'{n} {e:.3e}' for n, e in rounding.items())}")
    del q, k, v, log_a

    # every xlstm shape of the paths, Mamba2's, and two fp32 shapes
    main = timings(by_tag["loss"], iters=10)
    other = [timings(by_tag[tag], iters) for tag, iters in (
        ("loss-y-only", 10), ("prefill-777", 10), ("prefill-777-state", 10),
        ("serial-prefill", 10), ("decode", 50), ("mamba2", 20), ("mamba2-tick", 50),
        ("mamba2-prefill-777", 20), ("fp32-512", 10), ("fp32-decode", 50))]
    log("[kernels] gated_linear_scan ptxas: " + scan_ptxas())
    return {
        "name": "gated_linear_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan.py:76",
        "launches": 0,
        "max_abs_err": worst,
        "tolerance": worst_tol,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "device_ms": main["device_ms"],
        "plain_device_ms": main["plain_device_ms"],
        "cold_device_ms": main["cold_device_ms"],
        "bound_ms": main["bound_ms"],
        "bound_us": main["bound_ms"] * 1e3,
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a gated linear scan
        "library_device_ms": None,
        "tflops": main["tflops"],
        "timed_shape": main["shape"],
        "other_timings": other,
        "rounding_max_abs_err": rounding,
    }


def scan_ptxas() -> str:
    """`-Xptxas -v` of every scan kernel instantiation, from the verbose
    build of phase 2: registers, stack frame, spills, static shared memory."""
    import re

    from repro_torch.kernels import build

    out = []
    for entry in build.build_log().split("Compiling entry function '")[1:]:
        name = entry.split("'", 1)[0]
        kernel = re.search(r"scan_(mma|step|simt)_kernel(?:I(\w+?)E)?", name)
        if kernel is None:
            continue
        used = re.search(r"Used (\d+) registers", entry)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        require(used is not None and frame is not None, f"no ptxas report for {name}")
        out.append(f"{name}: {used.group(1)} registers, {frame.group(1)} B stack, "
                   f"{frame.group(2)}/{frame.group(3)} B spill stores/loads, "
                   f"{smem.group(1) if smem else 0} B static smem")
    require(out, "no scan kernel in the ptxas report")
    from repro_torch.kernels import linear_scan

    dyn = ", ".join(f"tile {t}: {linear_scan.mma_smem_bytes(t, 384)} B"
                    for t in linear_scan.MMA_TILES)
    return "; ".join(out) + f"; scan_mma_kernel dynamic smem at dk = 384: {dyn}"


SCAN_BWD_CASES = (
    # xlstm-125m's training shape: the mLSTM's call (y and normaliser; the
    # final states reach no loss), operands as `mlstm_forward` makes them
    dict(tag="xlstm-train", B=4, H=4, S=2048, dk=384, dv=384, dtype="bfloat16", norm=True),
    # zamba2-7b's Mamba2 at its published widths: q = C broadcast over 32 heads
    dict(tag="mamba2-train", B=2, H=32, S=1024, dk=64, dv=224, dtype="bfloat16", mamba=True),
    # a carried state with a final-state gradient, S not a multiple of 64
    dict(tag="xlstm-777-state", B=1, H=4, S=777, dk=384, dv=384, dtype="bfloat16", norm=True,
         init=True, d_state=True),
    dict(tag="mamba2-45-state", B=2, H=32, S=45, dk=64, dv=224, dtype="bfloat16", mamba=True,
         init=True, d_state=True),
    # the mma kernel's chunk and tile edges: S = 33 (two chunks, the second
    # of one position) and 2048 + 17 at xlstm's widths; Mamba2 at dv 200
    # (three tiles of 64 and one of 8 columns)
    dict(tag="xlstm-33-state", B=1, H=4, S=33, dk=384, dv=384, dtype="bfloat16", norm=True,
         init=True, d_state=True),
    dict(tag="xlstm-2065", B=1, H=4, S=2048 + 17, dk=384, dv=384, dtype="bfloat16", norm=True),
    dict(tag="mamba2-dv200-state", B=2, H=8, S=100, dk=64, dv=200, dtype="bfloat16",
         mamba=True, init=True, d_state=True),
    # fp32: REDUCED xlstm (ragged), REDUCED Mamba2, xlstm's widths
    dict(tag="fp32-reduced", B=2, H=4, S=45, dk=32, dv=32, dtype="float32", norm=True,
         init=True, d_state=True),
    dict(tag="fp32-reduced-mamba2", B=2, H=4, S=64, dk=16, dv=32, dtype="float32",
         mamba=True),
    dict(tag="fp32-512-state", B=2, H=4, S=512, dk=384, dv=384, dtype="float32", norm=True,
         init=True, d_state=True),
)


def _scan_bwd_case(torch, gen, *, B, H, S, dk, dv, dtype, norm=False, mamba=False,
                   init=False, d_state=False, **_):
    """(q, k, v, log_a, dy, d_state, keyword arguments of the backward):
    the forward operands as `_scan_case` lays them out and the gradients of
    y (and nrm) in their dtype, of the final states in fp32."""
    dt = getattr(torch, dtype)
    q, k, v, log_a, kw = _scan_case(torch, gen, B=B, H=H, S=S, dk=dk, dv=dv, dtype=dt,
                                    init=init, norm=norm, mamba=mamba, shared_qk=mamba)
    kw.pop("normaliser", None)
    dy = torch.randn((B, H, S, dv), generator=gen, device="cuda").to(dt)
    ds = torch.randn((B, H, dk, dv), generator=gen, device="cuda") if d_state else None
    if norm:
        kw.update(normaliser=True, dnrm=torch.randn((B, H, S, 1), generator=gen,
                                                   device="cuda").to(dt))
        if d_state:
            kw["dn"] = torch.randn((B, H, dk, 1), generator=gen, device="cuda")
    return q, k, v, log_a, dy, ds, kw


def _distinct_bytes(t) -> int:
    """Bytes of the distinct elements of a view (a stride-0 axis counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def _scan_bwd_bound_ms(q, k, v, log_a, dy, ds, kw, dtype_name) -> tuple:
    """The least time of the gradient's work. Bytes: q, k, v, log_a, dy
    (dnrm), the initial states and the final states' gradients read once;
    dq, dk, dv, dlog_a and the initial states' gradients written once.
    Operations: 8 S dk (dv + normaliser) per (b, h): the reverse state's
    q_t^T dy_t, dq_t, dk_t and dv_t, 2 S dk dv' each."""
    B, H, S, dk = q.shape
    cols = v.shape[-1] + (1 if kw.get("normaliser") else 0)
    reads = [q, k, v, log_a, dy, ds, kw.get("initial_state"), kw.get("initial_normaliser"),
             kw.get("dnrm"), kw.get("dn")]
    n_bytes = sum(_distinct_bytes(t) for t in reads if t is not None)
    n_bytes += (2 * B * H * S * dk + B * H * S * v.shape[-1]) * q.element_size() + B * H * S * 4
    n_bytes += sum(t.numel() * 4 for t in (kw.get("initial_state"), kw.get("initial_normaliser"))
                   if t is not None)
    flops = 8 * B * H * S * dk * cols
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations"), n_bytes, flops


def check_scan_bwd(torch, gen) -> dict:
    """The scan's backward kernel against `ref.gated_linear_scan_backward`
    (autograd through the plain chunked scan, at a chunk of at most 16 as
    `check_scan` holds the forward) at `SCAN_BWD_CASES`: max |d| / max
    |plain| of dq, dk, dv, dlog_a and the initial states' gradients within
    2e-2 (bf16) and 1e-4 (fp32), finite, each case on the variant
    `backward_variant` names, which must be `mma` for bf16 and `simt` for
    fp32. Then, at xlstm's and Mamba2's training shapes, the mma kernel warm
    and with its inputs cold in L2, the simt kernel on the same operands,
    and the plain version at the models' chunk; no single PyTorch call
    computes this gradient. Both kernels run for milliseconds a call, so
    back-to-back calls keep the card busy and CUDA events time the device
    (`device_ms` here); a profiler trace late in a long run was seen to
    record only part of these kernels' device time (0.41 and 0.33 of the
    events' at xlstm's shape), so its reading is kept apart
    (`profiler_device_ms`)."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import linear_scan, ref
    from repro_torch.models.ssm import _chunk_for

    names = ("dq", "dk", "dv", "dlog_a", "d_initial_state", "d_initial_normaliser")
    worst_abs, worst_rel, worst_tol, timings = 0.0, 0.0, None, {}
    for case in SCAN_BWD_CASES:
        q, k, v, log_a, dy, ds, kw = _scan_bwd_case(torch, gen, **case)
        norm = bool(kw.get("normaliser"))
        want_kind = "mma" if case["dtype"] == "bfloat16" else "simt"
        rule = linear_scan.backward_variant(q, k, v, normaliser=norm)
        results = []
        ran = launched_variant(linear_scan.backward, lambda: results.append(
            linear_scan.gated_linear_scan_backward(q, k, v, log_a, dy, ds, **kw)))
        want = ref.gated_linear_scan_backward(q, k, v, log_a, dy, ds,
                                              chunk=scan_check_chunk(case["S"]), **kw)
        torch.cuda.synchronize()
        tol = BWD_REL_TOL[case["dtype"]]
        rel = {}
        for name, a, b in zip(names, results[0], want):
            require((a is None) == (b is None), f"{case['tag']}: {name} given by one side only")
            if b is None:
                continue
            require(a.dtype == b.dtype and a.shape == b.shape, f"{case['tag']}: {name} layout")
            require(bool(torch.isfinite(a).all().item()), f"{case['tag']}: {name} not finite")
            diff = float((a.float() - b.float()).abs().max().item())
            rel[name] = diff / max(float(b.float().abs().max().item()), 1e-30)
            worst_abs = max(worst_abs, diff)
            if rel[name] > worst_rel:
                worst_rel, worst_tol = rel[name], tol
        ok = ran == rule == want_kind and max(rel.values()) <= tol
        desc = ", ".join(f"{k_}={v_}" for k_, v_ in case.items() if k_ != "tag")
        log(f"[kernels] gated_linear_scan_bwd {case['tag']} ({desc}; {ran}, the rule's "
            f"{rule}): max |d| / max |plain| " + ", ".join(f"{n} {e:.3e}" for n, e in rel.items())
            + f" (tol {tol}) {'ok' if ok else 'FAIL'}")
        require(ok, f"gated_linear_scan_bwd disagrees with its plain version or ran {ran} "
                    f"({case['tag']})")
        del results, want
        if case["tag"] in ("xlstm-train", "mamba2-train"):
            chunk = _chunk_for(case["S"])
            B, H, S, dk = q.shape
            cols = v.shape[-1] + int(norm)
            tile = linear_scan.backward_tile_columns(B, H, cols, kbuild.sm_count(q.device))
            kern = lambda q_, k_, v_, la_, dy_: linear_scan.gated_linear_scan_backward(  # noqa
                q_, k_, v_, la_, dy_, ds, **kw)
            simt = lambda: linear_scan.gated_linear_scan_backward(  # noqa: E731
                q, k, v, log_a, dy, ds, variant="simt", **kw)
            plain = lambda: ref.gated_linear_scan_backward(  # noqa: E731
                q, k, v, log_a, dy, ds, chunk=chunk, **kw)
            ins = (q, k, v, log_a, dy)
            copies = [tuple(x.clone() for x in ins) for _ in range(2 * L2_BYTES // sum(
                x.untyped_storage().nbytes() for x in ins) + 2)]
            turn = iter(range(1 << 30))
            t = dict(ms=time_ms(torch, lambda: kern(*ins), iters=5, warmup=1),
                     simt_ms=time_ms(torch, simt, iters=3, warmup=1),
                     plain_ms=time_ms(torch, plain, iters=3, warmup=1),
                     plain_device_ms=device_ms(torch, plain, iters=3),
                     profiler_device_ms=device_ms(torch, lambda: kern(*ins), iters=5),
                     cold_device_ms=time_ms(
                         torch, lambda: kern(*copies[next(turn) % len(copies)]),
                         iters=2 * len(copies), warmup=1))
            del copies
            t.update(device_ms=t["ms"], simt_device_ms=t["simt_ms"])
            bound, by, n_bytes, flops = _scan_bwd_bound_ms(q, k, v, log_a, dy, ds, kw,
                                                           case["dtype"])
            t.update(bound_ms=bound, bound_by=by, tflops=flops / (t["device_ms"] * 1e-3) / 1e12,
                     simt_tflops=flops / (t["simt_device_ms"] * 1e-3) / 1e12, tile=tile,
                     tiles=-(-cols // tile),
                     smem_bytes=linear_scan.backward_mma_smem_bytes(tile, dk),
                     max_clusters=linear_scan.backward_mma_max_clusters(tile, dk, cols),
                     shape=f"{case['tag']}: {desc}")
            log(f"[kernels] gated_linear_scan_bwd timing {case['tag']} ({desc}): mma kernel "
                f"{t['ms']:.4f} ms a call back to back ({t['cold_device_ms']:.4f} ms with the "
                f"inputs cold in L2; a profiler trace read {t['profiler_device_ms']:.4f}); simt "
                f"on the same operands {t['simt_ms']:.4f} ms; plain (chunk {chunk}) "
                f"{t['plain_ms']:.4f} ms, device {t['plain_device_ms']:.4f}; bound "
                f"{bound * 1e3:.2f} us ({by}: "
                f"{n_bytes} B, {flops} FLOP; mma at {t['device_ms'] / bound:.1f}x the bound, simt "
                f"at {t['simt_device_ms'] / bound:.1f}x); {t['tflops']:.3f} TFLOP/s (simt "
                f"{t['simt_tflops']:.3f}) on these times; {tile} columns a block, clusters of "
                f"{t['tiles']}, {t['max_clusters']} clusters on the card at once, "
                f"{t['smem_bytes']} B of dynamic shared memory a block")
            require(t["device_ms"] < t["simt_device_ms"],
                    f"gated_linear_scan_bwd: mma {t['device_ms']:.4f} ms is not below simt's "
                    f"{t['simt_device_ms']:.4f} at {case['tag']}")
            timings[case["tag"]] = t
        del q, k, v, log_a, dy, ds, kw
    main, mamba = timings["xlstm-train"], timings["mamba2-train"]
    return {
        "name": "gated_linear_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/linear_scan_bwd.cu",
        # the gradient of this Pallas kernel, which has no VJP of its own (the
        # reference trains through jax.vjp of its oracle, src/repro/kernels/ref.py:174)
        "replaces": "src/repro/kernels/linear_scan.py:76",
        "launches": 0,
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "tolerance": worst_tol,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "device_ms": main["device_ms"],
        "plain_device_ms": main["plain_device_ms"],
        "cold_device_ms": main["cold_device_ms"],
        "profiler_device_ms": main["profiler_device_ms"],
        "bound_ms": main["bound_ms"],
        "bound_us": main["bound_ms"] * 1e3,
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this gradient
        "library_device_ms": None,
        "tflops": main["tflops"],
        "variant": "mma",
        "timed_shape": main["shape"],
        "other_timings": [
            mamba,
            {"variant": "simt", "shape": main["shape"], "ms": main["simt_ms"],
             "device_ms": main["simt_device_ms"], "tflops": main["simt_tflops"]},
            {"variant": "simt", "shape": mamba["shape"], "ms": mamba["simt_ms"],
             "device_ms": mamba["simt_device_ms"], "tflops": mamba["simt_tflops"]}],
    }


def phase_kernels(torch) -> list:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flash, flash_bwd = check_flash(torch, gen), check_flash_bwd(torch, gen)
    fwd_hd80, bwd_hd80 = time_flash_hd80(torch, gen)
    flash["other_timings"].append(fwd_hd80)
    flash_bwd["other_timings"].append(bwd_hd80)
    # each variant's device ms at its timed shape: wgmma at the kernel's own,
    # tf32x3 and simt (the same operands) at train_100m's
    for row, hd80 in ((flash, fwd_hd80), (flash_bwd, bwd_hd80)):
        row["variants"] = {"wgmma": row["device_ms"], "tf32x3": hd80["device_ms"],
                           "simt": hd80["simt_device_ms"]}
    return [flash, flash_bwd, check_paged(torch, gen), check_decode(torch, gen),
            check_fused_linear(torch, gen), check_scan(torch, gen), check_scan_bwd(torch, gen)]


# ---------------------------------------------------------------------------
# 4. REDUCED model on the card vs the CPU
# ---------------------------------------------------------------------------


def reduced_logits(torch, cfg, params, prompts, steps_tokens, device):
    """Prefill each prompt into its slot of a ring-paged pool, then run
    teacher-forced paged decode ticks; returns every logits tensor on the CPU."""
    import numpy as np

    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import paged_layout

    B = len(prompts)
    max_len = max(len(p) for p in prompts) + len(steps_tokens)
    layout = paged_layout(cfg, max_slots=B, max_len=max_len, page_size=8)
    require(layout.ring, "reduced check expects a ring layout")
    pools = tf.init_paged_caches(cfg, layout, device=device)
    table = np.zeros((B, layout.n_pages_seq), np.int32)
    ring = layout.ring_table(device=device)
    outs = []
    for s, prompt in enumerate(prompts):
        table[s] = 1 + s * layout.n_pages_seq + np.arange(layout.n_pages_seq)
        caches = tf.init_caches(cfg, 1, layout.cache_len, device=device)
        tokens = torch.as_tensor(np.asarray([prompt], np.int32), device=device)
        logits, caches = tf.lm_prefill(cfg, params, tokens, caches)
        outs.append(logits.cpu())
        tf.commit_prefill_paged(cfg, layout, pools, caches,
                                torch.as_tensor(table[s], device=device), ring[s])
    full_table = torch.as_tensor(table, device=device)
    pos = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
    active = torch.ones((B,), dtype=torch.bool, device=device)
    for step_tokens in steps_tokens:
        tokens = torch.as_tensor(np.asarray(step_tokens, np.int32), device=device)
        logits, pools = tf.lm_paged_decode_step(cfg, layout, params, pools, full_table, tokens,
                                                pos, active)
        outs.append(logits.cpu())
        pos = pos + 1
    return outs


def phase_reduced(torch) -> None:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("gemma3-1b", reduced=True)
    require(cfg.compute_dtype == "float32", "REDUCED gemma3-1b computes in fp32")
    params_cpu = build(cfg).init(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (45, 12, 3)]
    steps = rng.integers(1, cfg.vocab_size, (16, len(prompts))).tolist()
    ops.reset_launch_counts()
    on_card = reduced_logits(torch, cfg, _to_device(params_cpu, "cuda"), prompts, steps, "cuda")
    counts = ops.launch_counts()
    require_fp32_flash("reduced")
    on_cpu = reduced_logits(torch, cfg, params_cpu, prompts, steps, "cpu")
    require(counts["flash_attention"] == len(prompts) * cfg.num_layers
            and counts["paged_decode_attention"] == len(steps) * cfg.num_layers,
            f"reduced run did not go through the kernels: {counts}")
    worst = max(float((a - b).abs().max()) for a, b in zip(on_card, on_cpu))
    same_greedy = all(torch.equal(a.argmax(-1), b.argmax(-1)) for a, b in zip(on_card, on_cpu))
    log(f"[reduced] gemma3-1b REDUCED fp32, prefill of {len(prompts)} prompts + {len(steps)} "
        f"teacher-forced paged ticks: max |logits card - cpu| = {worst:.3e} (atol {REDUCED_ATOL}),"
        f" greedy tokens equal: {same_greedy}, launches {counts}")
    require(worst <= REDUCED_ATOL, f"REDUCED logits differ by {worst:.3e} > {REDUCED_ATOL}")
    require(same_greedy, "REDUCED greedy tokens differ between the card and the CPU")


# ---------------------------------------------------------------------------
# 5 and 7. serve full-width gemma3-1b (paged, then dense)
# ---------------------------------------------------------------------------


LARGE_GEMM = (4096, 4096, 4096)  # M, K, N of the large fused_linear timings
SERVE_REQUESTS = dict(n=16, prompt_range=(64, 1025), steps_range=(16, 65), seed=0)


def phase_serve(torch, kv_mode: str = "paged") -> tuple:
    """Full-width gemma3-1b serves the 16 synthetic requests through the
    continuous-batching scheduler in `kv_mode`. Returns (launch counts of
    the served run, {rid: tokens}, tok/s)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.common import dtype_of
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.workload import synthetic_requests

    tag = "[serve]" if kv_mode == "paged" else f"[serve-{kv_mode}]"
    gc.collect()  # earlier phases' weights: peak memory counts this phase's only
    cfg = get_config("gemma3-1b")
    model = build(cfg)
    n_req = SERVE_REQUESTS["n"]
    prompt_range, steps_range = SERVE_REQUESTS["prompt_range"], SERVE_REQUESTS["steps_range"]
    max_len = (prompt_range[1] - 1) + (steps_range[1] - 1)
    with Runtime("torchdev") as rt:
        t0 = time.perf_counter()
        params = model.init(seed=0, device=rt.processing_unit.context,
                            dtype=dtype_of(cfg.compute_dtype))
        torch.cuda.synchronize()
        log(f"{tag} {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.num_heads}q/{cfg.num_kv_heads}kv heads x {cfg.resolved_head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.compute_dtype}; weights initialised on "
            f"the card in {time.perf_counter() - t0:.1f}s")
        sched = ContinuousBatchingScheduler(
            model, params, max_batch=8, max_len=max_len, runtime=rt, kv_mode=kv_mode,
            page_size=16, sync_interval=8,
        )
        if kv_mode == "paged":
            layout = sched.decoder.layout
            log(f"{tag} layout: cache_len {layout.cache_len}, ring {layout.ring} "
                f"(w_pages {layout.w_pages}), pool pages {layout.num_pages}")
        # warm-up: CUDA context, cuBLAS handles, kernel library
        warm = synthetic_requests(cfg.vocab_size, 2, prompt_range=(64, 65), steps_range=(9, 10),
                                  seed=1, rid_prefix="warm")
        sched.serve(warm)
        if kv_mode == "paged":
            require(sched.decoder.kv.pages_used == 0, "warm-up left pages allocated")

        requests = synthetic_requests(cfg.vocab_size, n_req, prompt_range=prompt_range,
                                      steps_range=steps_range, seed=SERVE_REQUESTS["seed"])
        admitted_at = {}
        admit = sched.try_admit

        def timed_admit(request):
            ok = admit(request)
            if ok:  # the first token is the prefill's greedy pick
                admitted_at[request.rid] = time.perf_counter()
            return ok

        sched.try_admit = timed_admit
        ticks0 = sched.ticks
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results = sched.serve(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        variants = ops.variant_counts()
        peak = torch.cuda.max_memory_allocated()
        ticks = sched.ticks - ticks0
        if kv_mode == "dense":
            log(f"{tag} dense caches: {sched.decoder.cache_capacity} positions deep on the "
                f"global layers")

    require(len(results) == n_req, f"{len(results)} of {n_req} requests finished")
    n_tok = 0
    for r in requests:
        fin = results[r.rid]
        toks = np.asarray(fin.tokens)
        require(len(toks) == r.max_new_tokens and fin.finish_reason == "length",
                f"{r.rid}: {len(toks)} tokens ({fin.finish_reason}), budget {r.max_new_tokens}")
        require(bool(np.all((toks >= 0) & (toks < cfg.vocab_size))), f"{r.rid}: token out of range")
        n_tok += len(toks)
    require(counts["flash_attention"] == n_req * cfg.num_layers,
            f"flash_attention launched {counts['flash_attention']} times, "
            f"expected {n_req * cfg.num_layers}")
    require_variant(variants, "flash_attention", "wgmma", counts["flash_attention"],
                    f"{kv_mode} serve")
    decode_kernel = "paged_decode_attention" if kv_mode == "paged" else "decode_attention"
    require(counts[decode_kernel] == ticks * cfg.num_layers,
            f"{decode_kernel} launched {counts[decode_kernel]} times, "
            f"expected {ticks * cfg.num_layers}")
    require_variant(variants, decode_kernel, "mma", counts[decode_kernel], f"{kv_mode} serve")
    if kv_mode == "paged":
        require(sched.decoder.kv.pages_used == 0, "pages still allocated after the drain")
    ttft = np.asarray([admitted_at[r.rid] - t0 for r in requests])
    plens = [len(r.prompt) for r in requests]
    log(f"{tag} {n_req} requests (prompts {min(plens)}-{max(plens)} tokens, "
        f"{sum(plens)} prompt tokens), {n_tok} generated tokens in {wall:.3f}s: "
        f"{n_tok / wall:.1f} tok/s; TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms, "
        f"p90 {np.percentile(ttft, 90) * 1e3:.1f} ms (from a common start, queueing included); "
        f"{ticks} decode ticks; peak device memory {peak / 2**30:.2f} GiB; launches {counts}; "
        f"flash by variant {variants['flash_attention']}")
    for r in requests[:3]:
        log(f"{tag} {r.rid}: prompt {len(r.prompt)} tokens -> {results[r.rid].tokens[:8]}...")
    return counts, {rid: fin.tokens for rid, fin in results.items()}, n_tok / wall


# ---------------------------------------------------------------------------
# 6. REDUCED model through the dense decode, on the card vs the CPU
# ---------------------------------------------------------------------------


def dense_logits(torch, cfg, params, prompts, steps_tokens, device):
    """Prefill each prompt into its slot of dense per-slot caches, then run
    teacher-forced dense decode ticks at per-slot positions; returns every
    logits tensor on the CPU."""
    import numpy as np

    from repro_torch.models import transformer as tf

    B = len(prompts)
    max_len = max(len(p) for p in prompts) + len(steps_tokens)
    caches, outs = None, []
    for s, prompt in enumerate(prompts):
        tokens = torch.as_tensor(np.asarray([prompt], np.int32), device=device)
        logits, one = tf.lm_prefill(cfg, params, tokens, tf.init_caches(cfg, 1, max_len,
                                                                         device=device))
        outs.append(logits.cpu())
        if caches is None:
            caches = [tuple(torch.zeros((B,) + t.shape[1:], dtype=t.dtype, device=device)
                            for t in kv) for kv in one]
        for (bk, bv), (k, v) in zip(caches, one):
            bk[s], bv[s] = k[0], v[0]
    pos = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
    for step_tokens in steps_tokens:
        tokens = torch.as_tensor(np.asarray(step_tokens, np.int32)[:, None], device=device)
        logits, caches = tf.lm_decode_step(cfg, params, caches, tokens, pos)
        outs.append(logits.cpu())
        pos = pos + 1
    return outs


def phase_reduced_dense(torch) -> None:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.workload import synthetic_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("gemma3-1b", reduced=True)
    model = build(cfg)
    params_cpu = model.init(seed=0, device="cpu")
    params_card = _to_device(params_cpu, "cuda")

    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (45, 12, 3)]
    steps = rng.integers(1, cfg.vocab_size, (16, len(prompts))).tolist()
    ops.reset_launch_counts()
    on_card = dense_logits(torch, cfg, params_card, prompts, steps, "cuda")
    counts = ops.launch_counts()
    require_fp32_flash("reduced-dense")
    on_cpu = dense_logits(torch, cfg, params_cpu, prompts, steps, "cpu")
    require(counts["decode_attention"] == len(steps) * cfg.num_layers
            and counts["flash_attention"] == len(prompts) * cfg.num_layers,
            f"reduced dense run did not go through the kernels: {counts}")
    worst = max(float((a - b).abs().max()) for a, b in zip(on_card, on_cpu))
    same_greedy = all(torch.equal(a.argmax(-1), b.argmax(-1)) for a, b in zip(on_card, on_cpu))
    log(f"[reduced-dense] gemma3-1b REDUCED fp32, prefill of {len(prompts)} prompts + "
        f"{len(steps)} teacher-forced dense ticks at per-slot positions: max |logits card - cpu| "
        f"= {worst:.3e} (atol {REDUCED_ATOL}), greedy tokens equal: {same_greedy}, "
        f"launches {counts}")
    require(worst <= REDUCED_ATOL, f"REDUCED dense logits differ by {worst:.3e} > {REDUCED_ATOL}")
    require(same_greedy, "REDUCED dense greedy tokens differ between the card and the CPU")

    requests = synthetic_requests(cfg.vocab_size, 6, prompt_range=(3, 12), steps_range=(2, 14),
                                  seed=0)
    engine_prompts = rng.integers(1, cfg.vocab_size, (3, 9)).astype(np.int32)
    served, generated, launches = {}, {}, {}
    for device, params in (("cuda", params_card), ("cpu", params_cpu)):
        with Runtime("torchdev", device=device) as rt:
            ops.reset_launch_counts()
            sched = ContinuousBatchingScheduler(model, params, max_batch=4, max_len=64,
                                                runtime=rt, kv_mode="dense")
            served[device] = {rid: f.tokens for rid, f in sched.serve(requests).items()}
            launches[device] = ops.launch_counts()
            require_fp32_flash("reduced-dense")
            engine = ServeEngine(model, params, max_len=40, runtime=rt)
            generated[device] = engine.generate(engine_prompts, steps=12).tokens
    log(f"[reduced-dense] dense serve of {len(requests)} requests and serial generate "
        f"(3 x 9 prompts, 12 steps): card tokens equal CPU tokens: serve "
        f"{served['cuda'] == served['cpu']}, generate "
        f"{bool(np.array_equal(generated['cuda'], generated['cpu']))}; card serve launches "
        f"{launches['cuda']}")
    require(launches["cuda"]["decode_attention"] > 0, "the dense serve launched no decode kernel")
    require(served["cuda"] == served["cpu"], "REDUCED dense serve tokens differ card vs CPU")
    require(bool(np.array_equal(generated["cuda"], generated["cpu"])),
            "REDUCED serial generate tokens differ card vs CPU")


# ---------------------------------------------------------------------------
# 8. serial engine, full width
# ---------------------------------------------------------------------------


def phase_serial(torch) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.common import dtype_of
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("gemma3-1b")
    model = build(cfg)
    B, S, steps = 8, 512, 32
    gc.collect()  # earlier phases' weights: peak memory counts this phase's only
    prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    with Runtime("torchdev") as rt:
        params = model.init(seed=0, device=rt.processing_unit.context,
                            dtype=dtype_of(cfg.compute_dtype))
        engine = ServeEngine(model, params, max_len=S + steps, runtime=rt)
        engine.generate(prompts[:, :64], steps=2)  # warm-up
        first = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = engine.generate(prompts, steps=steps,
                              on_first_token=lambda: first.append(time.perf_counter()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        variants = ops.variant_counts()
        peak = torch.cuda.max_memory_allocated()
    toks = out.tokens
    require(toks.shape == (B, steps), f"serial generate returned {toks.shape}")
    require(bool(np.all((toks >= 0) & (toks < cfg.vocab_size))), "serial token out of range")
    require(counts["flash_attention"] == cfg.num_layers
            and counts["decode_attention"] == steps * cfg.num_layers,
            f"serial launches {counts}, expected flash {cfg.num_layers} and decode "
            f"{steps * cfg.num_layers}")
    require_variant(variants, "flash_attention", "wgmma", counts["flash_attention"], "serial")
    require_variant(variants, "decode_attention", "mma", counts["decode_attention"], "serial")
    require(bool(np.isfinite(out.prefill_logits).all()), "serial prefill logits not finite")
    log(f"[serial] ServeEngine.generate B={B} prompts of {S} tokens, {steps} steps: "
        f"{B * steps} tokens in {wall:.3f}s: {B * steps / wall:.1f} tok/s; first token after "
        f"{(first[0] - t0) * 1e3:.1f} ms; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {counts}; flash by variant {variants['flash_attention']}; row 0 -> "
        f"{toks[0, :8].tolist()}...")
    return counts


# ---------------------------------------------------------------------------
# 9. the paper's Test Case 2: heterogeneous inference
# ---------------------------------------------------------------------------


def phase_tc2(torch) -> dict:
    from repro_torch.apps import mlp_inference
    from repro_torch.backends import hostcpu, torchdev
    from repro_torch.kernels import ops

    weights = mlp_inference.train_weights()
    host_res = hostcpu.HostTopologyManager().query_topology().all_compute_resources()[0]
    card_res = torchdev.TorchTopologyManager().query_topology().all_compute_resources()[0]
    n_test, batch = 2000, 256
    n_batches = -(-n_test // batch)
    results, counts, walls, variants = {}, {}, {}, {}
    for kernel, cm, res in (("numpy", hostcpu.HostComputeManager(), host_res),
                            ("torch", torchdev.TorchComputeManager(), card_res),
                            ("fused_linear", torchdev.TorchComputeManager(), card_res)):
        mlp_inference.run_inference(cm, res, kernel=kernel, weights=weights, n_test=batch,
                                    batch_size=batch)  # warm-up
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results[kernel] = mlp_inference.run_inference(cm, res, kernel=kernel, weights=weights,
                                                      n_test=n_test, batch_size=batch)
        walls[kernel] = time.perf_counter() - t0
        counts[kernel] = ops.launch_counts()
        variants[kernel] = ops.variant_counts()
    for kernel, r in results.items():
        log(f"[tc2] {kernel:>12}: accuracy {r.accuracy:.4f}, img-0 class {r.img0_class}, "
            f"score {r.img0_score:.7f}; {n_test} images in {walls[kernel] * 1e3:.1f} ms; "
            f"launches {counts[kernel]}")
    accs = {r.accuracy for r in results.values()}
    scores = [r.img0_score for r in results.values()]
    require(len(accs) == 1, f"Test Case 2 accuracies diverged: {accs}")
    require(min(accs) > 0.85, f"Test Case 2 accuracy {min(accs)} <= 0.85")
    require(len({r.img0_class for r in results.values()}) == 1, "img-0 class differs across rows")
    require(max(scores) - min(scores) < 1e-4, f"img-0 scores spread {max(scores) - min(scores)}")
    require(counts["fused_linear"]["fused_linear"] == 2 * n_batches,
            f"fused_linear launched {counts['fused_linear']['fused_linear']} times, "
            f"expected {2 * n_batches}")
    require(all(c["fused_linear"] == 0 for k, c in counts.items() if k != "fused_linear"),
            "a row other than fused_linear launched the kernel")
    # fp32 products of 256 rows (208 in the last batch): the small-product variant
    require_variant(variants["fused_linear"], "fused_linear", "simt_small", 2 * n_batches,
                    "Test Case 2")
    log(f"[tc2] Table 2 holds: accuracy {min(accs):.4f} on every row, img-0 score spread "
        f"{max(scores) - min(scores):.2e}; fused_linear by variant "
        f"{variants['fused_linear']['fused_linear']}")
    return counts["fused_linear"]


# ---------------------------------------------------------------------------
# 10. REDUCED xlstm on the card vs the CPU
# ---------------------------------------------------------------------------


def xlstm_logits(torch, cfg, params, prompts, steps_tokens, device):
    """Prefill each prompt from zero states (B=1), stack the states as the
    slots of one batch, then run teacher-forced decode ticks; returns every
    logits tensor on the CPU."""
    import numpy as np

    from repro_torch.models import xlstm_model as xm

    outs, states = [], []
    for prompt in prompts:
        tokens = torch.as_tensor(np.asarray([prompt], np.int32), device=device)
        logits, st = xm.lm_prefill(cfg, params, tokens, xm.init_states(cfg, 1, device=device))
        outs.append(logits.cpu())
        states.append(st)
    batch = [{k: torch.cat([st[i][k] for st in states]) for k in states[0][i]}
             for i in range(cfg.num_layers)]
    for step_tokens in steps_tokens:
        tokens = torch.as_tensor(np.asarray(step_tokens, np.int32)[:, None], device=device)
        logits, batch = xm.lm_decode_step(cfg, params, batch, tokens, 0)
        outs.append(logits.cpu())
    return outs


def phase_reduced_xlstm(torch) -> None:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models import xlstm_model as xm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.workload import synthetic_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("xlstm-125m", reduced=True)
    require(cfg.compute_dtype == "float32", "REDUCED xlstm-125m computes in fp32")
    n_mlstm = xm.block_kinds(cfg).count("mlstm")
    model = build(cfg)
    params_cpu = model.init(seed=0, device="cpu")
    params_card = _to_device(params_cpu, "cuda")
    rng = np.random.default_rng(2)

    # the stateless forward and loss
    tokens = rng.integers(0, cfg.vocab_size, (2, 96)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 96)).astype(np.int32)
    out = {}
    for device, params in (("cuda", params_card), ("cpu", params_cpu)):
        t = torch.as_tensor(tokens, device=device)
        ops.reset_launch_counts()
        logits, _ = xm.lm_forward(cfg, params, t)
        loss, _ = model.loss(params, {"tokens": t, "labels": torch.as_tensor(labels, device=device)})
        out[device] = (logits.cpu(), float(loss), ops.launch_counts())
    err_logits = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    err_loss = abs(out["cuda"][1] - out["cpu"][1])
    log(f"[reduced-xlstm] xlstm-125m REDUCED fp32 forward (2 x 96 tokens): max |logits card - "
        f"cpu| = {err_logits:.3e}, loss card {out['cuda'][1]:.6f} cpu {out['cpu'][1]:.6f} "
        f"(atol {REDUCED_ATOL}); card launches {out['cuda'][2]}")
    require(out["cuda"][2]["gated_linear_scan"] == 2 * n_mlstm,
            f"forward + loss launched {out['cuda'][2]['gated_linear_scan']} scans, expected "
            f"one per mLSTM block per call, {2 * n_mlstm}")
    require(err_logits <= REDUCED_ATOL and err_loss <= REDUCED_ATOL,
            f"REDUCED xlstm forward differs: logits {err_logits:.3e}, loss {err_loss:.3e}")

    # prefill from zero states + teacher-forced decode ticks carrying the states
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (45, 12, 3)]
    steps = rng.integers(1, cfg.vocab_size, (16, len(prompts))).tolist()
    ops.reset_launch_counts()
    on_card = xlstm_logits(torch, cfg, params_card, prompts, steps, "cuda")
    counts = ops.launch_counts()
    on_cpu = xlstm_logits(torch, cfg, params_cpu, prompts, steps, "cpu")
    require(counts["gated_linear_scan"] == n_mlstm * (len(prompts) + len(steps)),
            f"reduced xlstm run did not go through the scan kernel: {counts}")
    worst = max(float((a - b).abs().max()) for a, b in zip(on_card, on_cpu))
    same_greedy = all(torch.equal(a.argmax(-1), b.argmax(-1)) for a, b in zip(on_card, on_cpu))
    log(f"[reduced-xlstm] prefill of {len(prompts)} prompts + {len(steps)} teacher-forced "
        f"ticks carrying the states: max |logits card - cpu| = {worst:.3e} (atol "
        f"{REDUCED_ATOL}), greedy tokens equal: {same_greedy}, launches {counts}")
    require(worst <= REDUCED_ATOL, f"REDUCED xlstm logits differ by {worst:.3e} > {REDUCED_ATOL}")
    require(same_greedy, "REDUCED xlstm greedy tokens differ between the card and the CPU")

    requests = synthetic_requests(cfg.vocab_size, 6, prompt_range=(3, 40), steps_range=(2, 14),
                                  seed=0)
    engine_prompts = rng.integers(1, cfg.vocab_size, (3, 9)).astype(np.int32)
    served, generated, launches = {}, {}, {}
    for device, params in (("cuda", params_card), ("cpu", params_cpu)):
        with Runtime("torchdev", device=device) as rt:
            ops.reset_launch_counts()
            sched = ContinuousBatchingScheduler(model, params, max_batch=4, max_len=64,
                                                runtime=rt, kv_mode="dense")
            served[device] = {rid: f.tokens for rid, f in sched.serve(requests).items()}
            launches[device] = ops.launch_counts()
            engine = ServeEngine(model, params, max_len=40, runtime=rt)
            generated[device] = engine.generate(engine_prompts, steps=12).tokens
    log(f"[reduced-xlstm] dense serve of {len(requests)} requests and serial generate "
        f"(3 x 9 prompts, 12 steps): card tokens equal CPU tokens: serve "
        f"{served['cuda'] == served['cpu']}, generate "
        f"{bool(np.array_equal(generated['cuda'], generated['cpu']))}; card serve launches "
        f"{launches['cuda']}")
    require(launches["cuda"]["gated_linear_scan"] > 0, "the xlstm serve launched no scan kernel")
    require(served["cuda"] == served["cpu"], "REDUCED xlstm serve tokens differ card vs CPU")
    require(bool(np.array_equal(generated["cuda"], generated["cpu"])),
            "REDUCED xlstm serial generate tokens differ card vs CPU")


# ---------------------------------------------------------------------------
# 11. serve full-width xlstm-125m (dense scheduler, then the serial engine)
# ---------------------------------------------------------------------------


def phase_serve_xlstm(torch) -> dict:
    """Full-width xlstm-125m serves the 16 synthetic requests through the
    dense continuous-batching scheduler, then the serial engine runs 8 x 512
    prompts for 32 steps. Returns the launch counts of the served run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models import xlstm_model as xm
    from repro_torch.models.common import dtype_of
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.workload import synthetic_requests

    gc.collect()  # earlier phases' weights: peak memory counts this phase's only
    cfg = get_config("xlstm-125m")
    model = build(cfg)
    per_step = xm.block_kinds(cfg).count("mlstm")  # scans per prefill and per tick
    n_req = SERVE_REQUESTS["n"]
    prompt_range, steps_range = SERVE_REQUESTS["prompt_range"], SERVE_REQUESTS["steps_range"]
    max_len = (prompt_range[1] - 1) + (steps_range[1] - 1)
    with Runtime("torchdev") as rt:
        t0 = time.perf_counter()
        params = model.init(seed=0, device=rt.processing_unit.context,
                            dtype=dtype_of(cfg.compute_dtype))
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        log(f"[serve-xlstm] {cfg.name}: {cfg.num_layers} blocks ({xm.block_kinds(cfg)}), d_model "
            f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.ssm_expand * cfg.d_model // cfg.num_heads}"
            f", vocab {cfg.vocab_size}, {cfg.compute_dtype}; {n_params} parameters initialised "
            f"on the card in {time.perf_counter() - t0:.1f}s")
        sched = ContinuousBatchingScheduler(model, params, max_batch=8, max_len=max_len,
                                            runtime=rt, kv_mode="dense")
        warm = synthetic_requests(cfg.vocab_size, 2, prompt_range=(64, 65), steps_range=(9, 10),
                                  seed=1, rid_prefix="warm")
        sched.serve(warm)
        requests = synthetic_requests(cfg.vocab_size, n_req, prompt_range=prompt_range,
                                      steps_range=steps_range, seed=SERVE_REQUESTS["seed"])
        admitted_at = {}
        admit = sched.try_admit

        def timed_admit(request):
            ok = admit(request)
            if ok:  # the first token is the prefill's greedy pick
                admitted_at[request.rid] = time.perf_counter()
            return ok

        sched.try_admit = timed_admit
        ticks0 = sched.ticks
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results = sched.serve(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        scan_variants = ops.variant_counts()["gated_linear_scan"]
        peak = torch.cuda.max_memory_allocated()
        ticks = sched.ticks - ticks0

        require(len(results) == n_req, f"{len(results)} of {n_req} requests finished")
        n_tok = 0
        for r in requests:
            fin = results[r.rid]
            toks = np.asarray(fin.tokens)
            require(len(toks) == r.max_new_tokens and fin.finish_reason == "length",
                    f"{r.rid}: {len(toks)} tokens ({fin.finish_reason}), budget {r.max_new_tokens}")
            require(bool(np.all((toks >= 0) & (toks < cfg.vocab_size))),
                    f"{r.rid}: token out of range")
            n_tok += len(toks)
        want = per_step * (n_req + ticks)
        require(counts["gated_linear_scan"] == want,
                f"gated_linear_scan launched {counts['gated_linear_scan']} times, expected "
                f"{per_step} per prefill and per tick = {want}")
        require(all(n == 0 for name, n in counts.items() if name != "gated_linear_scan"),
                f"the xlstm serve launched another kernel: {counts}")
        # prompts of 64 tokens and more prefill on the tensor-core kernel,
        # ticks (one position) on the step kernel
        require(scan_variants == {"simt": 0, "mma": per_step * n_req, "step": per_step * ticks},
                f"xlstm serve scan launches by variant {scan_variants}, expected "
                f"{per_step * n_req} mma (prefills) and {per_step * ticks} step (ticks)")
        ttft = np.asarray([admitted_at[r.rid] - t0 for r in requests])
        plens = [len(r.prompt) for r in requests]
        log(f"[serve-xlstm] {n_req} requests (prompts {min(plens)}-{max(plens)} tokens, "
            f"{sum(plens)} prompt tokens), {n_tok} generated tokens in {wall:.3f}s: "
            f"{n_tok / wall:.1f} tok/s; TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms, "
            f"p90 {np.percentile(ttft, 90) * 1e3:.1f} ms (from a common start, queueing "
            f"included); {ticks} decode ticks; peak device memory {peak / 2**30:.2f} GiB; "
            f"launches {counts}, the scan's by variant {scan_variants}")
        for r in requests[:3]:
            log(f"[serve-xlstm] {r.rid}: prompt {len(r.prompt)} tokens -> "
                f"{results[r.rid].tokens[:8]}...")

        # the serial engine: one B=8 prefill, then 32 steps
        B, S, steps = 8, 512, 32
        prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
        engine = ServeEngine(model, params, max_len=S + steps, runtime=rt)
        engine.generate(prompts[:, :64], steps=2)  # warm-up
        first = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = engine.generate(prompts, steps=steps,
                              on_first_token=lambda: first.append(time.perf_counter()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        serial_counts = ops.launch_counts()
        serial_variants = ops.variant_counts()["gated_linear_scan"]
        peak = torch.cuda.max_memory_allocated()
    toks = out.tokens
    require(toks.shape == (B, steps), f"serial generate returned {toks.shape}")
    require(bool(np.all((toks >= 0) & (toks < cfg.vocab_size))), "serial token out of range")
    require(bool(np.isfinite(out.prefill_logits).all()), "serial prefill logits not finite")
    require(serial_counts["gated_linear_scan"] == per_step * (1 + steps)
            and sum(serial_counts.values()) == serial_counts["gated_linear_scan"],
            f"serial launches {serial_counts}, expected {per_step * (1 + steps)} scans only")
    require(serial_variants == {"simt": 0, "mma": per_step, "step": per_step * steps},
            f"serial scan launches by variant {serial_variants}")
    log(f"[serve-xlstm] serial ServeEngine.generate B={B} prompts of {S} tokens, {steps} steps: "
        f"{B * steps} tokens in {wall:.3f}s: {B * steps / wall:.1f} tok/s; first token after "
        f"{(first[0] - t0) * 1e3:.1f} ms; peak device memory {peak / 2**30:.2f} GiB; launches "
        f"{serial_counts}; row 0 -> {toks[0, :8].tolist()}...")
    return counts


# ---------------------------------------------------------------------------
# 12. full-width xlstm-125m forward and loss
# ---------------------------------------------------------------------------


def phase_loss_xlstm(torch) -> dict:
    """`ModelBundle.loss` of full-width xlstm-125m on B=4 x S=2048 seeded
    tokens under `torch.no_grad()`: the path the reference's Pallas scan
    runs on. Returns the launch counts of that call."""
    import math

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models import xlstm_model as xm
    from repro_torch.models.common import dtype_of

    gc.collect()
    cfg = get_config("xlstm-125m")
    model = build(cfg)
    B, S = 4, 2048
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                             device="cuda")
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                             device="cuda")
    with torch.no_grad():
        params = model.init(seed=0, device="cuda", dtype=dtype_of(cfg.compute_dtype))
        model.loss(params, {"tokens": tokens[:, :128], "labels": labels[:, :128]})  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss, metrics = model.loss(params, {"tokens": tokens, "labels": labels})
        loss = float(loss)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        scan_variants = ops.variant_counts()["gated_linear_scan"]
        peak = torch.cuda.max_memory_allocated()
    want = xm.block_kinds(cfg).count("mlstm")  # one scan (y and normaliser) per mLSTM block
    log(f"[loss-xlstm] ModelBundle.loss B={B} S={S} ({B * S} tokens), {cfg.compute_dtype}: loss "
        f"{loss:.5f} (ln V = {math.log(cfg.vocab_size):.5f} for random weights; ce "
        f"{float(metrics['ce_loss']):.5f}) in {wall:.3f}s ({B * S / wall:.0f} tok/s); peak "
        f"device memory {peak / 2**30:.2f} GiB; launches {counts}")
    require(math.isfinite(loss), f"loss is not finite: {loss}")
    require(abs(loss - math.log(cfg.vocab_size)) < 2.0,
            f"loss {loss} is far from ln V = {math.log(cfg.vocab_size)} for random weights")
    require(counts["gated_linear_scan"] == want
            and sum(counts.values()) == counts["gated_linear_scan"],
            f"loss launches {counts}, expected {want} scans only")
    require(scan_variants["mma"] == want, f"loss scan launches by variant {scan_variants}")
    return counts


# ---------------------------------------------------------------------------
# 13. REDUCED gemma3 with the prefix cache, on the card and on the CPU
# ---------------------------------------------------------------------------


def _serve_one_by_one(sched, requests):
    """Serve `requests` one after another (later shared prompts then hit
    what earlier ones donated). Returns {rid: tokens}."""
    out = {}
    for r in requests:
        out.update({rid: fin.tokens for rid, fin in sched.serve([r]).items()})
    return out


def phase_reduced_prefix(torch) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
    from repro_torch.serve.workload import (multi_turn_requests, resume_prompt,
                                            shared_prefix_requests)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("gemma3-1b", reduced=True)
    model = build(cfg)
    params_cpu = model.init(seed=0, device="cpu")
    params_card = _to_device(params_cpu, "cuda")
    requests = shared_prefix_requests(cfg.vocab_size, 8, prefix_len=20, prefix_share=0.75,
                                      tail_range=(1, 6), steps_range=(4, 12), seed=7)
    [[turn1, turn2]] = multi_turn_requests(cfg.vocab_size, 1, 2, first_prompt_range=(8, 9),
                                           followup_range=(3, 4), steps_range=(9, 10), seed=4)
    kw = dict(kv_mode="paged", max_batch=2, max_len=64, page_size=8, sync_interval=3)
    tokens, stats, launches = {}, {}, {}
    for device, params in (("cuda", params_card), ("cpu", params_cpu)):
        with Runtime("torchdev", device=device) as rt:
            for cache in (True, False):
                sched = ContinuousBatchingScheduler(model, params, runtime=rt,
                                                    prefix_cache=cache, **kw)
                ops.reset_launch_counts()
                got = _serve_one_by_one(sched, requests)
                r1 = sched.serve([turn1])[turn1.rid]
                prompt2 = resume_prompt(turn1.prompt, r1.tokens, turn2.prompt)
                got[turn1.rid] = r1.tokens
                got[turn2.rid] = sched.serve(
                    [Request(turn2.rid, prompt2, turn2.max_new_tokens)])[turn2.rid].tokens
                tokens[device, cache] = got
                launches[device, cache] = ops.launch_counts()
                require_fp32_flash("reduced-prefix")
                if cache:
                    kv = sched.decoder.kv
                    stats[device] = sched.prefix.stats()
                    require(kv.pages_used == sched.prefix.cached_pages,
                            f"{device}: {kv.pages_used} pages used after the drain, the cache "
                            f"holds {sched.prefix.cached_pages}")
                    sched.prefix.reset()
                    require(kv.pages_used == 0 and kv.pages_available == kv.capacity,
                            f"{device}: pages left after the cache's reset")
                else:
                    require(sched.decoder.kv.pages_used == 0, f"{device}: pages left, no cache")
    on = launches["cuda", True]
    log(f"[reduced-prefix] gemma3-1b REDUCED fp32, {len(requests)} shared-prompt requests one "
        f"by one + a 2-turn conversation: tokens equal with the cache on and off: card "
        f"{tokens['cuda', True] == tokens['cuda', False]}, cpu "
        f"{tokens['cpu', True] == tokens['cpu', False]}; card equal cpu "
        f"{tokens['cuda', True] == tokens['cpu', True]}; cache stats card {stats['cuda']}; "
        f"card launches cache on {on}, off {launches['cuda', False]}")
    require(tokens["cuda", True] == tokens["cuda", False],
            "REDUCED tokens differ with the prefix cache on and off (card)")
    require(tokens["cuda", True] == tokens["cpu", True], "REDUCED prefix tokens differ card vs CPU")
    require(stats["cuda"] == stats["cpu"], f"cache stats differ: {stats}")
    require(stats["cuda"]["hits"] > 0 and stats["cuda"]["hit_tokens"] >= 16,
            f"no prefix hit: {stats['cuda']}")
    # the tail prefill is plain torch (as the reference's oracle); the
    # decode ticks run the paged kernel
    require(on["paged_decode_attention"] > 0 and on["flash_attention"] == 0,
            f"prefix-cache serve launches {on}")


# ---------------------------------------------------------------------------
# 14. full-width gemma3-1b with the prefix cache (paged)
# ---------------------------------------------------------------------------


PREFIX_LEN, PREFIX_TAIL, PREFIX_STEPS = 512, (2, 8), (8, 24)  # benchmarks/bench_serve.py


def _timed_serve(torch, sched, requests):
    """Serve `requests` from a common start, timing each admission (the
    prefill a prefix hit shortens) and each first token. Returns (wall,
    {rid: ttft}, {rid: admission seconds}, {rid: tokens})."""
    from collections import deque

    backlog = deque(requests)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ttft, admit_s, tokens = {}, {}, {}
    while len(tokens) < len(requests):
        while backlog:
            t_adm = time.perf_counter()
            if not sched.try_admit(backlog[0]):
                break
            now = time.perf_counter()  # the first token is on the host
            admit_s[backlog[0].rid], ttft[backlog[0].rid] = now - t_adm, now - t0
            backlog.popleft()
        for fin in sched.step():
            tokens[fin.rid] = fin.tokens
    torch.cuda.synchronize()
    return time.perf_counter() - t0, ttft, admit_s, tokens


def _agreement(a: dict, b: dict) -> tuple:
    same = sum(sum(x == y for x, y in zip(a[rid], b[rid])) for rid in a)
    return same, sum(len(t) for t in a.values())


def phase_serve_prefix(torch) -> dict:
    """Full-width gemma3-1b, paged, 8 slots: 16 shared-system-prompt
    requests with the prefix cache (after one warm request that pins the
    system prompt) and without, then a 3-turn multi-turn pass both ways.
    Returns the launch counts of the cached shared-prompt pass."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.common import dtype_of
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
    from repro_torch.serve.workload import (multi_turn_requests, resume_prompt,
                                            shared_prefix_requests)

    gc.collect()
    cfg = get_config("gemma3-1b")
    model = build(cfg)
    n_req, page = 16, 16
    requests = shared_prefix_requests(cfg.vocab_size, n_req, prefix_len=PREFIX_LEN,
                                      prefix_share=0.75, tail_range=PREFIX_TAIL,
                                      steps_range=PREFIX_STEPS, seed=1)
    max_len = PREFIX_LEN + PREFIX_TAIL[1] + PREFIX_STEPS[1] + 1
    n_ps = -(-max_len // page)
    system = next(r.prompt[:PREFIX_LEN] for r in requests if "-s" in r.rid)
    warm = Request("warm-0", list(system) + [1], 2)
    with Runtime("torchdev") as rt:
        params = model.init(seed=0, device=rt.processing_unit.context,
                            dtype=dtype_of(cfg.compute_dtype))
        kw = dict(max_batch=8, max_len=max_len, runtime=rt, kv_mode="paged", page_size=page,
                  sync_interval=8)
        off = ContinuousBatchingScheduler(model, params, **kw)
        # headroom over the slots' worst case, so resident cache pages do
        # not force eviction mid-burst (as the reference's bench)
        on = ContinuousBatchingScheduler(model, params, prefix_cache=True,
                                         pool_pages=8 * n_ps + 1 + 2 * n_ps, **kw)
        require(on.decoder.layout.shared and not on.decoder.layout.ring,
                "the prefix cache's layout is not shared")
        # warm-up passes (CUDA context, cuBLAS handles, every code path)
        off.serve(requests[:4])
        on.serve([warm] + requests[:4])
        on.prefix.reset()
        on.serve([warm])  # deploy-time state: the system prompt resident
        s0 = dict(on.prefix.stats())
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ticks0 = on.ticks
        wall_on, ttft_on, adm_on, tok_on = _timed_serve(torch, on, requests)
        counts = ops.launch_counts()
        variants = ops.variant_counts()
        ticks = on.ticks - ticks0
        peak = torch.cuda.max_memory_allocated()
        s1 = on.prefix.stats()
        ops.reset_launch_counts()
        wall_off, ttft_off, adm_off, tok_off = _timed_serve(torch, off, requests)
        counts_off = ops.launch_counts()
        kv = on.decoder.kv
        pages_after = (kv.pages_used, on.prefix.cached_pages)
        on.prefix.reset()
        pages_reset = (kv.pages_used, kv.pages_available, kv.capacity)

        # multi-turn: each turn's prompt is the whole exchange so far (the
        # cache-on run's replies), served with the cache and without
        convs = multi_turn_requests(cfg.vocab_size, 4, 3, first_prompt_range=(256, 512),
                                    followup_range=(16, 64), steps_range=(16, 32), seed=2)
        mt_len = max(sum(len(t.prompt) + t.max_new_tokens for t in conv) for conv in convs)
        mt_kw = dict(kw, max_len=-(-mt_len // page) * page)
        mt_on = ContinuousBatchingScheduler(model, params, prefix_cache=True, **mt_kw)
        mt_off = ContinuousBatchingScheduler(model, params, **mt_kw)
        history = [None] * len(convs)
        mt = {"on": {}, "off": {}, "ttft_on": [], "ttft_off": []}
        for t in range(3):
            turn = []
            for c, conv in enumerate(convs):
                r = conv[t]
                prompt = r.prompt if t == 0 else resume_prompt(*history[c], r.prompt)
                turn.append(Request(r.rid, prompt, r.max_new_tokens))
            _, tt_on, _, got_on = _timed_serve(torch, mt_on, turn)
            _, tt_off, _, got_off = _timed_serve(torch, mt_off, turn)
            mt["on"].update(got_on)
            mt["off"].update(got_off)
            if t:  # turns that resume a cached history
                mt["ttft_on"] += list(tt_on.values())
                mt["ttft_off"] += list(tt_off.values())
            history = [(req.prompt, got_on[req.rid]) for req in turn]
        mt_stats = mt_on.prefix.stats()
        mt_pages = (mt_on.decoder.kv.pages_used, mt_on.prefix.cached_pages,
                    mt_off.decoder.kv.pages_used)

    n_tok = 0
    for r in requests:
        for got in (tok_on, tok_off):
            toks = np.asarray(got[r.rid])
            require(len(toks) == r.max_new_tokens and bool(np.all((toks >= 0)
                                                                   & (toks < cfg.vocab_size))),
                    f"{r.rid}: {len(toks)} tokens for a budget of {r.max_new_tokens}")
        n_tok += r.max_new_tokens
    hit_tokens = s1["hit_tokens"] - s0["hit_tokens"]
    queried = s1["queried_tokens"] - s0["queried_tokens"]
    hit_rate = hit_tokens / queried if queried else 0.0
    same, total = _agreement(tok_on, tok_off)
    mt_same, mt_total = _agreement(mt["on"], mt["off"])
    split = {}
    for name, ttft in (("on", ttft_on), ("off", ttft_off)):
        for kind in ("s", "u"):
            vals = [v for rid, v in ttft.items() if f"-{kind}" in rid]
            split[name, kind] = (np.percentile(vals, 50) * 1e3, np.percentile(vals, 90) * 1e3)
    adm = {name: np.mean([v for rid, v in a.items() if "-s" in rid]) * 1e3
           for name, a in (("on", adm_on), ("off", adm_off))}
    log(f"[serve-prefix] {cfg.name} paged, 8 slots, page {page}, {n_req} requests "
        f"(prefix {PREFIX_LEN} tokens shared by 75 %, tails {PREFIX_TAIL}, {PREFIX_STEPS} new "
        f"tokens; {n_tok} generated) after a warm request pinning the system prompt")
    log(f"[serve-prefix] cache on: {wall_on:.3f}s, {n_tok / wall_on:.1f} tok/s; cache off: "
        f"{wall_off:.3f}s, {n_tok / wall_off:.1f} tok/s; token hit rate {hit_rate:.4f} "
        f"({hit_tokens}/{queried}); TTFT p50/p90 ms, shared (-s) on {split['on', 's'][0]:.1f}/"
        f"{split['on', 's'][1]:.1f}, off {split['off', 's'][0]:.1f}/{split['off', 's'][1]:.1f}; "
        f"unique (-u) on {split['on', 'u'][0]:.1f}/{split['on', 'u'][1]:.1f}, off "
        f"{split['off', 'u'][0]:.1f}/{split['off', 'u'][1]:.1f}; mean admission of a shared "
        f"request {adm['on']:.1f} ms on, {adm['off']:.1f} ms off; {ticks} decode ticks; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    log(f"[serve-prefix] pages after the drain: {pages_after[0]} used = {pages_after[1]} cached; "
        f"after reset {pages_reset[0]} used, {pages_reset[1]} of {pages_reset[2]} available; "
        f"tokens equal to the cache-off run at the same position: {same} of {total} "
        f"({same / total:.3f}; the tail's plain attention and flash sum in other orders in "
        f"bf16, so reported, not required); launches on {counts}, paged by variant "
        f"{variants['paged_decode_attention']}; off {counts_off}")
    log(f"[serve-prefix] multi-turn, 4 conversations x 3 turns (first prompts 256-511, "
        f"follow-ups 16-63, 16-31 new tokens; max_len {mt_kw['max_len']}): cache stats "
        f"{mt_stats}; TTFT of resumed turns p50 on {np.percentile(mt['ttft_on'], 50) * 1e3:.1f} "
        f"ms, off {np.percentile(mt['ttft_off'], 50) * 1e3:.1f} ms; tokens equal to the "
        f"cache-off run {mt_same} of {mt_total}; pages after the drain {mt_pages[0]} used = "
        f"{mt_pages[1]} cached, {mt_pages[2]} without the cache")
    require(hit_rate > 0, f"no prefix hit in the shared-prompt pass: {s1}")
    require(pages_after[0] == pages_after[1], f"pages after the drain {pages_after}")
    require(pages_reset[0] == 0 and pages_reset[1] == pages_reset[2],
            f"pages after reset {pages_reset}")
    require(mt_stats["hit_tokens"] > 0, f"no hit in the multi-turn pass: {mt_stats}")
    require(mt_pages[0] == mt_pages[1] and mt_pages[2] == 0, f"multi-turn pages {mt_pages}")
    require(counts["flash_attention"] == 0,
            f"the cached pass launched flash {counts['flash_attention']} times (tails are plain)")
    require(counts["paged_decode_attention"] == ticks * cfg.num_layers,
            f"paged_decode_attention launched {counts['paged_decode_attention']} times, expected "
            f"{ticks * cfg.num_layers}")
    require_variant(variants, "paged_decode_attention", "mma",
                    counts["paged_decode_attention"], "prefix serve")
    require(counts_off["flash_attention"] == n_req * cfg.num_layers,
            f"the uncached pass launched flash {counts_off['flash_attention']} times")
    return counts


# ---------------------------------------------------------------------------
# 15. REDUCED zamba2 on the card vs the CPU
# ---------------------------------------------------------------------------


def hybrid_logits(torch, cfg, params, prompts, steps_tokens, device):
    """Prefill each prompt (B=1) into `max_len`-deep states, stack the
    states as the slots of one batch, then run teacher-forced decode ticks
    at per-slot positions; returns every logits tensor on the CPU."""
    import numpy as np

    from repro_torch.models import hybrid

    max_len = max(len(p) for p in prompts) + len(steps_tokens)
    outs, states = [], []
    for prompt in prompts:
        tokens = torch.as_tensor(np.asarray([prompt], np.int32), device=device)
        logits, st = hybrid.lm_prefill(cfg, params, tokens,
                                       hybrid.init_states(cfg, 1, max_len, device=device))
        outs.append(logits.cpu())
        states.append(st)

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(x[k] for x in leaves)) for k in leaves[0]}
        if isinstance(leaves[0], (list, tuple)):
            return type(leaves[0])(stack(*xs) for xs in zip(*leaves))
        return torch.cat(leaves)

    batch = stack(*states)
    pos = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
    for step_tokens in steps_tokens:
        tokens = torch.as_tensor(np.asarray(step_tokens, np.int32)[:, None], device=device)
        logits, batch = hybrid.lm_decode_step(cfg, params, batch, tokens, pos)
        outs.append(logits.cpu())
        pos = pos + 1
    return outs


def phase_reduced_zamba2(torch) -> None:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build, hybrid
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.workload import synthetic_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("zamba2-7b", reduced=True)
    require(cfg.compute_dtype == "float32", "REDUCED zamba2-7b computes in fp32")
    _, n_groups, _ = hybrid.group_structure(cfg)
    model = build(cfg)
    params_cpu = model.init(seed=0, device="cpu")
    params_card = _to_device(params_cpu, "cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (45, 12, 7)]
    steps = rng.integers(1, cfg.vocab_size, (16, len(prompts))).tolist()
    ops.reset_launch_counts()
    on_card = hybrid_logits(torch, cfg, params_card, prompts, steps, "cuda")
    counts = ops.launch_counts()
    require_fp32_flash("reduced-zamba2")
    on_cpu = hybrid_logits(torch, cfg, params_cpu, prompts, steps, "cpu")
    calls = len(prompts) + len(steps)
    require(counts["flash_attention"] == n_groups * len(prompts)
            and counts["decode_attention"] == n_groups * len(steps)
            and counts["gated_linear_scan"] == cfg.num_layers * calls,
            f"reduced zamba2 run did not go through the kernels: {counts}")
    worst = max(float((a - b).abs().max()) for a, b in zip(on_card, on_cpu))
    same_greedy = all(torch.equal(a.argmax(-1), b.argmax(-1)) for a, b in zip(on_card, on_cpu))
    log(f"[reduced-zamba2] zamba2-7b REDUCED fp32 ({cfg.num_layers} Mamba2 layers, the shared "
        f"block after every {cfg.shared_attn_interval}): prefill of {len(prompts)} prompts + "
        f"{len(steps)} teacher-forced ticks at per-slot positions: max |logits card - cpu| = "
        f"{worst:.3e} (atol {REDUCED_ATOL}), greedy tokens equal: {same_greedy}, launches "
        f"{counts}")
    require(worst <= REDUCED_ATOL, f"REDUCED zamba2 logits differ by {worst:.3e} > {REDUCED_ATOL}")
    require(same_greedy, "REDUCED zamba2 greedy tokens differ between the card and the CPU")

    requests = synthetic_requests(cfg.vocab_size, 6, prompt_range=(3, 40), steps_range=(2, 14),
                                  seed=0)
    engine_prompts = rng.integers(1, cfg.vocab_size, (3, 9)).astype(np.int32)
    served, generated, launches = {}, {}, {}
    for device, params in (("cuda", params_card), ("cpu", params_cpu)):
        with Runtime("torchdev", device=device) as rt:
            ops.reset_launch_counts()
            sched = ContinuousBatchingScheduler(model, params, max_batch=4, max_len=64,
                                                runtime=rt, kv_mode="dense")
            served[device] = {rid: f.tokens for rid, f in sched.serve(requests).items()}
            launches[device] = ops.launch_counts()
            require_fp32_flash("reduced-zamba2")
            engine = ServeEngine(model, params, max_len=40, runtime=rt)
            generated[device] = engine.generate(engine_prompts, steps=12).tokens
    log(f"[reduced-zamba2] dense serve of {len(requests)} requests and serial generate "
        f"(3 x 9 prompts, 12 steps): card tokens equal CPU tokens: serve "
        f"{served['cuda'] == served['cpu']}, generate "
        f"{bool(np.array_equal(generated['cuda'], generated['cpu']))}; card serve launches "
        f"{launches['cuda']}")
    require(launches["cuda"]["gated_linear_scan"] > 0 and launches["cuda"]["decode_attention"] > 0,
            "the zamba2 serve launched no scan or decode kernel")
    require(served["cuda"] == served["cpu"], "REDUCED zamba2 serve tokens differ card vs CPU")
    require(bool(np.array_equal(generated["cuda"], generated["cpu"])),
            "REDUCED zamba2 serial generate tokens differ card vs CPU")


# ---------------------------------------------------------------------------
# 16. serve full-width zamba2-7b (dense scheduler, then the serial engine)
# ---------------------------------------------------------------------------


def phase_serve_zamba2(torch) -> tuple:
    """Full-width zamba2-7b (bf16, seeded weights) serves the 16 synthetic
    requests through the dense scheduler on 8 slots, then the serial engine
    runs 8 x 512 prompts for 32 steps. Returns the launch counts of (the
    served run, the serial run)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build, hybrid
    from repro_torch.models.common import dtype_of
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.workload import synthetic_requests

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("zamba2-7b")
    model = build(cfg)
    g, n_groups, n_tail = hybrid.group_structure(cfg)
    n_req = SERVE_REQUESTS["n"]
    prompt_range, steps_range = SERVE_REQUESTS["prompt_range"], SERVE_REQUESTS["steps_range"]
    max_len = (prompt_range[1] - 1) + (steps_range[1] - 1)
    with Runtime("torchdev") as rt:
        t0 = time.perf_counter()
        params = model.init(seed=0, device=rt.processing_unit.context,
                            dtype=dtype_of(cfg.compute_dtype))
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        weights = torch.cuda.memory_allocated()
        log(f"[serve-zamba2] {cfg.name}: {cfg.num_layers} Mamba2 layers ({n_groups} groups of "
            f"{g}, the shared block after each, {n_tail} tail), d_model {cfg.d_model}, Mamba2 "
            f"{cfg.num_heads} heads x {cfg.ssm_expand * cfg.d_model // cfg.num_heads} state "
            f"{cfg.ssm_state}, attention {cfg.num_heads}q/{cfg.num_kv_heads}kv x "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
            f"{cfg.compute_dtype}; {n_params} parameters ({weights / 2**30:.2f} GiB) "
            f"initialised on the card in {time.perf_counter() - t0:.1f}s")
        sched = ContinuousBatchingScheduler(model, params, max_batch=8, max_len=max_len,
                                            runtime=rt, kv_mode="dense")
        warm = synthetic_requests(cfg.vocab_size, 2, prompt_range=(64, 65), steps_range=(9, 10),
                                  seed=1, rid_prefix="warm")
        sched.serve(warm)
        requests = synthetic_requests(cfg.vocab_size, n_req, prompt_range=prompt_range,
                                      steps_range=steps_range, seed=SERVE_REQUESTS["seed"])
        ticks0 = sched.ticks
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        wall, ttft, _, tokens = _timed_serve(torch, sched, requests)
        counts = ops.launch_counts()
        variants = ops.variant_counts()
        peak = torch.cuda.max_memory_allocated()
        ticks = sched.ticks - ticks0

        n_tok = 0
        for r in requests:
            toks = np.asarray(tokens[r.rid])
            require(len(toks) == r.max_new_tokens, f"{r.rid}: {len(toks)} tokens, budget "
                    f"{r.max_new_tokens}")
            require(bool(np.all((toks >= 0) & (toks < cfg.vocab_size))),
                    f"{r.rid}: token out of range")
            n_tok += len(toks)
        want = {"flash_attention": n_groups * n_req, "decode_attention": n_groups * ticks,
                "gated_linear_scan": cfg.num_layers * (n_req + ticks),
                "paged_decode_attention": 0, "fused_linear": 0,
                "flash_attention_bwd": 0, "gated_linear_scan_bwd": 0}
        require(counts == want, f"zamba2 serve launches {counts}, expected {want}")
        require_variant(variants, "flash_attention", "wgmma", want["flash_attention"],
                        "zamba2 serve")
        # one query head a KV head at hd 112: the SIMT walk (decode_core.variant)
        require_variant(variants, "decode_attention", "simt", want["decode_attention"],
                        "zamba2 serve")
        scan = variants["gated_linear_scan"]
        require(scan == {"simt": 0, "mma": cfg.num_layers * n_req,
                         "step": cfg.num_layers * ticks},
                f"zamba2 serve scan launches by variant {scan}")
        tt = np.asarray(list(ttft.values()))
        plens = [len(r.prompt) for r in requests]
        log(f"[serve-zamba2] {n_req} requests (prompts {min(plens)}-{max(plens)} tokens, "
            f"{sum(plens)} prompt tokens), {n_tok} generated tokens in {wall:.3f}s: "
            f"{n_tok / wall:.1f} tok/s; TTFT p50 {np.percentile(tt, 50) * 1e3:.1f} ms, p90 "
            f"{np.percentile(tt, 90) * 1e3:.1f} ms (from a common start, queueing included); "
            f"{ticks} decode ticks; peak device memory {peak / 2**30:.2f} GiB (weights "
            f"{weights / 2**30:.2f}); launches {counts}, by variant "
            f"{ {k: variants[k] for k in ('flash_attention', 'decode_attention', 'gated_linear_scan')} }")
        for r in requests[:3]:
            log(f"[serve-zamba2] {r.rid}: prompt {len(r.prompt)} tokens -> "
                f"{tokens[r.rid][:8]}...")
        del sched
        gc.collect()

        B, S, steps = 8, 512, 32
        prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
        engine = ServeEngine(model, params, max_len=S + steps, runtime=rt)
        engine.generate(prompts[:, :64], steps=2)  # warm-up
        first = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = engine.generate(prompts, steps=steps,
                              on_first_token=lambda: first.append(time.perf_counter()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        serial_counts = ops.launch_counts()
        serial_variants = ops.variant_counts()
        peak = torch.cuda.max_memory_allocated()
    toks = out.tokens
    require(toks.shape == (B, steps), f"serial generate returned {toks.shape}")
    require(bool(np.all((toks >= 0) & (toks < cfg.vocab_size))), "serial token out of range")
    require(bool(np.isfinite(out.prefill_logits).all()), "serial prefill logits not finite")
    want = {"flash_attention": n_groups, "decode_attention": n_groups * steps,
            "gated_linear_scan": cfg.num_layers * (1 + steps), "paged_decode_attention": 0,
            "fused_linear": 0,
            "flash_attention_bwd": 0, "gated_linear_scan_bwd": 0}
    require(serial_counts == want, f"zamba2 serial launches {serial_counts}, expected {want}")
    require_variant(serial_variants, "flash_attention", "wgmma", want["flash_attention"],
                    "zamba2 serial")
    require_variant(serial_variants, "decode_attention", "simt", want["decode_attention"],
                    "zamba2 serial")
    require(serial_variants["gated_linear_scan"] == {
        "simt": 0, "mma": cfg.num_layers, "step": cfg.num_layers * steps},
        f"zamba2 serial scan launches by variant {serial_variants['gated_linear_scan']}")
    log(f"[serve-zamba2] serial ServeEngine.generate B={B} prompts of {S} tokens, {steps} steps: "
        f"{B * steps} tokens in {wall:.3f}s: {B * steps / wall:.1f} tok/s; first token after "
        f"{(first[0] - t0) * 1e3:.1f} ms; peak device memory {peak / 2**30:.2f} GiB; launches "
        f"{serial_counts}; row 0 -> {toks[0, :8].tolist()}...")
    return counts, serial_counts


# ---------------------------------------------------------------------------
# 17-18. the dense family: granite-20b, minitron-8b, stablelm-12b
# ---------------------------------------------------------------------------


DENSE_FAMILY = ("granite-20b", "minitron-8b", "stablelm-12b")
#: the variants each config's full-width paged serve launches, by the
#: kernels' rules: (flash, paged decode). Every prefill takes flash's wgmma
#: (granite's 48 query heads a KV head fill 48 of a warpgroup's 64 rows;
#: stablelm's head_dim 160 pads to 192 columns); every decode tick takes the
#: decode core's mma walk (stablelm's hd 160 at its own width)
DENSE_FAMILY_VARIANTS = {"granite-20b": ("wgmma", "mma"), "minitron-8b": ("wgmma", "mma"),
                         "stablelm-12b": ("wgmma", "mma")}


def phase_reduced_dense_family(torch) -> None:
    """Each REDUCED fp32 config of the dense family on the card against the
    CPU: prefill plus 16 teacher-forced dense ticks (logits within 1e-4),
    then a paged continuous serve and a serial `generate` (equal tokens)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.workload import synthetic_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in DENSE_FAMILY:
        cfg = get_config(arch, reduced=True)
        require(cfg.compute_dtype == "float32", f"REDUCED {arch} computes in fp32")
        model = build(cfg)
        params_cpu = model.init(seed=0, device="cpu")
        params_card = _to_device(params_cpu, "cuda")
        rng = np.random.default_rng(7)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (45, 12, 3)]
        steps = rng.integers(1, cfg.vocab_size, (16, len(prompts))).tolist()
        ops.reset_launch_counts()
        on_card = dense_logits(torch, cfg, params_card, prompts, steps, "cuda")
        counts = ops.launch_counts()
        require_fp32_flash("reduced-dense-family")
        on_cpu = dense_logits(torch, cfg, params_cpu, prompts, steps, "cpu")
        require(counts["flash_attention"] == len(prompts) * cfg.num_layers
                and counts["decode_attention"] == len(steps) * cfg.num_layers,
                f"reduced {arch} run did not go through the kernels: {counts}")
        worst = max(float((a - b).abs().max()) for a, b in zip(on_card, on_cpu))
        same_greedy = all(torch.equal(a.argmax(-1), b.argmax(-1)) for a, b in zip(on_card, on_cpu))

        requests = synthetic_requests(cfg.vocab_size, 6, prompt_range=(3, 40),
                                      steps_range=(2, 14), seed=0)
        engine_prompts = rng.integers(1, cfg.vocab_size, (3, 9)).astype(np.int32)
        served, generated, launches, pages = {}, {}, {}, {}
        for device, params in (("cuda", params_card), ("cpu", params_cpu)):
            with Runtime("torchdev", device=device) as rt:
                ops.reset_launch_counts()
                sched = ContinuousBatchingScheduler(model, params, max_batch=4, max_len=64,
                                                    runtime=rt, kv_mode="paged", page_size=8,
                                                    sync_interval=4)
                served[device] = {rid: f.tokens for rid, f in sched.serve(requests).items()}
                pages[device] = sched.decoder.kv.pages_used
                engine = ServeEngine(model, params, max_len=40, runtime=rt)
                generated[device] = engine.generate(engine_prompts, steps=12).tokens
                launches[device] = ops.launch_counts()
                require_fp32_flash("reduced-dense-family")
        log(f"[reduced-dense-family] {arch} REDUCED fp32 ({cfg.num_layers} layers, "
            f"{cfg.num_heads}q/{cfg.num_kv_heads}kv x {cfg.resolved_head_dim}, act {cfg.act}, "
            f"untied): prefill of {len(prompts)} prompts + {len(steps)} teacher-forced dense ticks:"
            f" max |logits card - cpu| = {worst:.3e} (atol {REDUCED_ATOL}), greedy tokens equal: "
            f"{same_greedy}; paged serve of {len(requests)} requests and serial generate (3 x 9, "
            f"12 steps): card tokens equal CPU tokens: serve {served['cuda'] == served['cpu']}, "
            f"generate {bool(np.array_equal(generated['cuda'], generated['cpu']))}; pages used "
            f"after the drain {pages}; card launches {launches['cuda']}")
        require(worst <= REDUCED_ATOL, f"REDUCED {arch} logits differ by {worst:.3e}")
        require(same_greedy, f"REDUCED {arch} greedy tokens differ between the card and the CPU")
        require(launches["cuda"]["paged_decode_attention"] > 0
                and launches["cuda"]["decode_attention"] > 0,
                f"the {arch} serve and engine launched no decode kernel")
        require(served["cuda"] == served["cpu"], f"REDUCED {arch} paged serve tokens differ")
        require(bool(np.array_equal(generated["cuda"], generated["cpu"])),
                f"REDUCED {arch} serial generate tokens differ card vs CPU")
        require(pages == {"cuda": 0, "cpu": 0}, f"{arch}: pages left after the drain: {pages}")


def phase_serve_dense_family(torch) -> dict:
    """Each dense-family config at full width (bf16, seeded, depth not cut)
    serves the 16 synthetic requests on 8 slots through the paged scheduler;
    stablelm-12b also runs the serial engine on 4 of them. One config's
    weights are freed before the next is made. Returns launch counts by
    path."""
    counts = {}
    for arch in DENSE_FAMILY:
        counts.update(_serve_dense_config(torch, arch))
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated()
        require(left < 2**30, f"{arch}: {left / 2**30:.2f} GiB still allocated after its phase")
    return counts


def _serve_dense_config(torch, arch: str) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.common import dtype_of
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.workload import synthetic_requests

    tag = f"[serve-dense-family] {arch}"
    cfg = get_config(arch)
    model = build(cfg)
    L = cfg.num_layers
    n_req = SERVE_REQUESTS["n"]
    prompt_range, steps_range = SERVE_REQUESTS["prompt_range"], SERVE_REQUESTS["steps_range"]
    max_len = (prompt_range[1] - 1) + (steps_range[1] - 1)
    flash_kind, decode_kind = DENSE_FAMILY_VARIANTS[arch]
    out = {}
    gc.collect()  # earlier phases' objects in reference cycles hold card memory
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with Runtime("torchdev") as rt:
        t0 = time.perf_counter()
        params = model.init(seed=0, device=rt.processing_unit.context,
                            dtype=dtype_of(cfg.compute_dtype))
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        weights = torch.cuda.memory_allocated() - base
        log(f"{tag}: {L} layers, d_model {cfg.d_model}, {cfg.num_heads}q/{cfg.num_kv_heads}kv "
            f"heads x {cfg.resolved_head_dim}, d_ff {cfg.d_ff} ({cfg.act}), vocab "
            f"{cfg.vocab_size} (untied), {cfg.compute_dtype}; {n_params} parameters "
            f"({weights / 2**30:.2f} GiB) initialised on the card in "
            f"{time.perf_counter() - t0:.1f}s")
        sched = ContinuousBatchingScheduler(model, params, max_batch=8, max_len=max_len,
                                            runtime=rt, kv_mode="paged", page_size=16,
                                            sync_interval=8)
        pool = sum(k.nbytes + v.nbytes for k, v in sched.decoder.kv.pools)
        warm = synthetic_requests(cfg.vocab_size, 2, prompt_range=(64, 65), steps_range=(9, 10),
                                  seed=1, rid_prefix="warm")
        sched.serve(warm)
        requests = synthetic_requests(cfg.vocab_size, n_req, prompt_range=prompt_range,
                                      steps_range=steps_range, seed=SERVE_REQUESTS["seed"])
        ticks0 = sched.ticks
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        wall, ttft, _, tokens = _timed_serve(torch, sched, requests)
        counts = ops.launch_counts()
        variants = ops.variant_counts()
        peak = torch.cuda.max_memory_allocated() - base
        ticks = sched.ticks - ticks0
        n_tok = 0
        for r in requests:
            toks = np.asarray(tokens[r.rid])
            require(len(toks) == r.max_new_tokens,
                    f"{arch} {r.rid}: {len(toks)} tokens, budget {r.max_new_tokens}")
            require(bool(np.all((toks >= 0) & (toks < cfg.vocab_size))),
                    f"{arch} {r.rid}: token out of range")
            n_tok += len(toks)
        want = {"flash_attention": n_req * L, "paged_decode_attention": ticks * L,
                "decode_attention": 0, "gated_linear_scan": 0, "fused_linear": 0,
                "flash_attention_bwd": 0, "gated_linear_scan_bwd": 0}
        require(counts == want, f"{arch} serve launches {counts}, expected {want}")
        require_variant(variants, "flash_attention", flash_kind, want["flash_attention"],
                        f"{arch} serve")
        require_variant(variants, "paged_decode_attention", decode_kind,
                        want["paged_decode_attention"], f"{arch} serve")
        require(sched.decoder.kv.pages_used == 0, f"{arch}: pages still allocated after the drain")
        tt = np.asarray(list(ttft.values()))
        plens = [len(r.prompt) for r in requests]
        log(f"{tag}: {n_req} requests (prompts {min(plens)}-{max(plens)} tokens, {sum(plens)} "
            f"prompt tokens), {n_tok} generated tokens in {wall:.3f}s: {n_tok / wall:.1f} tok/s; "
            f"TTFT p50 {np.percentile(tt, 50) * 1e3:.1f} ms, p90 {np.percentile(tt, 90) * 1e3:.1f}"
            f" ms (from a common start, queueing included); {ticks} decode ticks; peak device "
            f"memory {peak / 2**30:.2f} GiB (weights "
            f"{weights / 2**30:.2f}, page pool {pool / 2**30:.2f}); launches {counts}, "
            f"by variant flash {variants['flash_attention']}, paged decode "
            f"{variants['paged_decode_attention']}")
        for r in requests[:2]:
            log(f"{tag} {r.rid}: prompt {len(r.prompt)} tokens -> {tokens[r.rid][:8]}...")
        out[f"serve-{arch}"] = counts
        del sched
        gc.collect()

        if arch == "stablelm-12b":
            # the serial engine (dense caches, the decode core's simt walk at
            # hd 160) on 4 of the requests, one at a time
            engine = ServeEngine(model, params, max_len=max_len, runtime=rt)
            engine.generate(np.asarray([warm[0].prompt], np.int32), steps=2)  # warm-up
            few = requests[:4]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            firsts, t0 = [], time.perf_counter()
            for r in few:
                t_req = time.perf_counter()
                res = engine.generate(np.asarray([r.prompt], np.int32), steps=r.max_new_tokens,
                                      on_first_token=lambda t=t_req: firsts.append(
                                          time.perf_counter() - t))
                toks = res.tokens[0]
                require(len(toks) == r.max_new_tokens and bool(np.all(
                    (toks >= 0) & (toks < cfg.vocab_size))), f"serial {r.rid}: bad tokens")
                require(bool(np.isfinite(res.prefill_logits).all()),
                        f"serial {r.rid}: prefill logits not finite")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            serial = ops.launch_counts()
            serial_variants = ops.variant_counts()
            peak = torch.cuda.max_memory_allocated() - base
            n_steps = sum(r.max_new_tokens for r in few)
            want = {"flash_attention": len(few) * L, "decode_attention": n_steps * L,
                    "paged_decode_attention": 0, "gated_linear_scan": 0, "fused_linear": 0,
                    "flash_attention_bwd": 0, "gated_linear_scan_bwd": 0}
            require(serial == want, f"{arch} serial launches {serial}, expected {want}")
            require_variant(serial_variants, "flash_attention", "wgmma", want["flash_attention"],
                            f"{arch} serial")
            require_variant(serial_variants, "decode_attention", decode_kind,
                            want["decode_attention"], f"{arch} serial")
            log(f"{tag} serial ServeEngine.generate on {len(few)} requests one at a time "
                f"(prompts {[len(r.prompt) for r in few]}): {n_steps} tokens in {wall:.3f}s: "
                f"{n_steps / wall:.1f} tok/s; first token after "
                f"{[round(f * 1e3, 1) for f in firsts]} ms; peak device memory "
                f"{peak / 2**30:.2f} GiB; launches {serial}")
            out[f"serve-{arch} serial"] = serial
            del engine
        del params
    return out


# ---------------------------------------------------------------------------
# 19. the torchdev backend's contracts on the card
# ---------------------------------------------------------------------------


def phase_conformance(torch) -> None:
    """The manager contracts of the conformance matrix, for `torchdev` bound
    to the card: execute returns a Future that resolves (and carries an
    error), memcpy returns an Event that lands host to device, device to
    device and device to host, memory slots are allocated, registered and
    freed."""
    from repro_torch.backends import torchdev
    from repro_torch.core.definitions import LifetimeError, UnsupportedOperationError

    topo = torchdev.TorchTopologyManager().query_topology()
    dev = topo.get_devices()[0]
    require(dev.kind == "gpu" and topo.all_compute_resources()[0].attributes["sm_count"] > 0,
            f"torchdev topology on the card: {dev}")
    cm = torchdev.TorchComputeManager()
    pu = cm.create_processing_unit(topo.all_compute_resources()[0])
    cm.initialize(pu)
    x = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
    try:
        unit = cm.create_execution_unit(lambda t: (t * 2).sum(), name="double-sum")
        state = cm.create_execution_state(unit, x)
        fut = cm.execute(pu, state)
        require(fut.wait(30), "execute's Future never resolved")
        got = float(fut.result())
        require(got == float((1 << 20) * ((1 << 20) - 1)), f"execute returned {got}")
        require(fut.done() and cm.is_finished(state), "the Future resolved, the state did not")
        try:
            cm.execute(pu, state)
            require(False, "a finished execution state ran again")
        except LifetimeError:
            pass

        def boom(t):
            raise ValueError("conformance-boom")

        bad = cm.create_execution_state(cm.create_execution_unit(boom, name="boom"), x)
        fut = cm.execute(pu, bad)
        require(fut.wait(30), "a failing unit's Future never resolved")
        try:
            fut.result()
            require(False, "the error did not propagate through the Future")
        except ValueError as e:
            require("conformance-boom" in str(e), f"the Future carried {e!r}")
        require(bad.error is not None, "the failing state records no error")
        for op in (cm.suspend, cm.resume):
            try:
                op(pu)
                require(False, f"{op.__name__} did not raise")
            except UnsupportedOperationError:
                pass
    finally:
        cm.finalize(pu)

    mm, host_mm = torchdev.TorchMemoryManager(), torchdev.TorchMemoryManager(device="cpu")
    space, host = mm.memory_spaces()[0], host_mm.memory_spaces()[0]
    require(space.kind == "device_hbm" and host.kind == "host_ram",
            f"memory spaces {space.kind}, {host.kind}")
    n = 1 << 22
    payload = torch.randint(0, 256, (n,), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    src = host_mm.register_tensor_slot(host, payload)
    on_card = mm.allocate_local_memory_slot(space, n)
    again = mm.allocate_local_memory_slot(space, n)
    back = host_mm.allocate_local_memory_slot(host, n)
    require(on_card.handle.device.type == "cuda" and back.handle.device.type == "cpu",
            "slots on the wrong devices")
    comm = torchdev.TorchCommunicationManager()
    events = {}
    for name, dst, s in (("host to device", on_card, src), ("device to device", again, on_card),
                         ("device to host", back, again)):
        ev = comm.memcpy(dst, 0, s, 0, n)
        require(ev.wait(30) and ev.done(), f"the {name} memcpy Event never completed")
        events[name] = bool(torch.equal(dst.handle.cpu(), payload))
    comm.fence(0)
    require(all(events.values()), f"memcpy results wrong: {events}")
    # offsets inside the slots, device to device
    ev = comm.memcpy(again, 100, on_card, 7, 1000)
    require(ev.wait(30), "offset memcpy never completed")
    require(bool(torch.equal(again.handle[100:1100].cpu(), payload[7:1007])), "offset memcpy")
    reg = mm.register_tensor_slot(space, x)
    require(reg.registered and reg.size_bytes == x.nbytes and reg.handle is x,
            "registering a card tensor did not keep it")
    try:
        mm.allocate_local_memory_slot(space, 0)
        require(False, "a zero-byte allocation was accepted")
    except ValueError:
        pass
    mm.free_local_memory_slot(on_card)
    for fn in (on_card.check_alive, lambda: mm.free_local_memory_slot(on_card)):
        try:
            fn()
            require(False, "a freed slot is still alive")
        except LifetimeError:
            pass
    try:
        comm.exchange_global_memory_slots(1, {})
        require(False, "torchdev exchanged global slots")
    except UnsupportedOperationError:
        pass
    log(f"[conformance] torchdev on {dev.attributes['torch_device']} "
        f"({topo.all_compute_resources()[0].attributes['name']}): execute Future resolves and "
        f"carries errors, states are single use, suspension refused; memcpy of {n} B "
        f"{events}; alloc/register/free and the lifetime errors hold")


# ---------------------------------------------------------------------------
# 20-21. the serving fleet: a router instance and runtime-created workers
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _worker_schedulers(keep: bool = True):
    """Record every scheduler the fleet's workers build: the schedulers
    themselves when `keep` (their pools can be read after the drain), else
    weak references (a kept scheduler would hold a killed worker's pool
    alive). Yields the list."""
    from repro_torch.serve import router

    made = []
    base = router.ContinuousBatchingScheduler

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self if keep else weakref.ref(self))

    router.ContinuousBatchingScheduler = Recorded
    try:
        yield made
    finally:
        router.ContinuousBatchingScheduler = base


def _kill_mid_stream(at: int):
    """The fleet's fault injection, as `tests/test_fleet.py` triggers it:
    the `on_forward` hook kills the worker of the first request observed at
    `at` forwarded tokens, before its terminal chunk."""
    state = {"worker": None, "victim": None}

    def hook(router_, rid, chunk):
        if state["worker"] is not None or "error" in chunk:
            return
        fl = router_._flights.get(rid)
        if fl and fl.worker is not None and fl.forwarded >= at and not chunk["done"]:
            state["worker"], state["victim"] = fl.worker, rid
            router_.kill_worker(fl.worker)

    return state, hook


def phase_reduced_fleet(torch) -> None:
    """REDUCED fp32 gemma3-1b through the fleet on the card: a 2-worker
    paged fleet gives the tokens of a single-instance scheduler on the card
    and on the CPU; a worker killed mid-stream requeues onto the survivor,
    token-identically; every surviving worker's pool is back."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.serve.router import run_fleet
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.workload import synthetic_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("gemma3-1b", reduced=True)
    model = build(cfg)
    params_cpu = model.init(seed=0, device="cpu")
    params_card = _to_device(params_cpu, "cuda")
    paged = dict(kv_mode="paged", page_size=16, sync_interval=2)

    def single(requests, max_len):
        out = {}
        for device, params in (("cuda", params_card), ("cpu", params_cpu)):
            with Runtime("torchdev", device=device) as rt:
                sched = ContinuousBatchingScheduler(model, params, max_batch=4, max_len=max_len,
                                                    runtime=rt, **paged)
                out[device] = {rid: f.tokens for rid, f in sched.serve(requests).items()}
        require(out["cuda"] == out["cpu"], "single-instance tokens differ card vs CPU")
        return out["cuda"]

    requests = synthetic_requests(cfg.vocab_size, 8, prompt_range=(3, 9), steps_range=(6, 14),
                                  seed=0)
    want = single(requests, 32)
    with _worker_schedulers() as made:
        ops.reset_launch_counts()
        out = run_fleet(model, params_card, requests, n_workers=2, max_batch=2, max_len=32,
                        device="cuda", **paged)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        require_fp32_flash("reduced-fleet")
    got = {rid: res.get("tokens") for rid, res in out.results.items()}
    settled = out.stats["per_worker_settled"]
    ticks = sum(s.ticks for s in made)
    log(f"[reduced-fleet] 2 workers x 2 slots, paged, {len(requests)} requests: tokens equal the "
        f"single-instance scheduler's on the card and the CPU: {got == want}; per-worker settled "
        f"{settled}; worker errors {out.stats['worker_errors']}; pages used after the drain "
        f"{[s.decoder.kv.pages_used for s in made]}; launches {counts}")
    require(got == want, "fleet tokens differ from the single-instance scheduler's")
    require(out.stats["worker_errors"] == {} and len(made) == 2, "a fleet worker failed")
    require(sorted(settled) == [0, 1] and min(settled.values()) >= 1,
            f"admissions did not spread over both workers: {settled}")
    require(all(s.decoder.kv.pages_used == 0 for s in made), "a worker's pool is not back")
    require(counts["flash_attention"] == len(requests) * cfg.num_layers
            and counts["paged_decode_attention"] == ticks * cfg.num_layers,
            f"fleet launches {counts}, expected flash {len(requests) * cfg.num_layers} and "
            f"paged decode {ticks * cfg.num_layers}")

    requests = synthetic_requests(cfg.vocab_size, 5, prompt_range=(3, 7), steps_range=(16, 25),
                                  seed=5)
    want = single(requests, 48)
    state, hook = _kill_mid_stream(2)
    with _worker_schedulers() as made:
        out = run_fleet(model, params_card, requests, n_workers=2, max_batch=2, max_len=48,
                        stream_interval=1, on_forward=hook, device="cuda", **paged)
        torch.cuda.synchronize()
    got = {rid: res.get("tokens") for rid, res in out.results.items()}
    restarted = set(out.stats["restarted"])
    live = [s for s in made if s.active_count == 0]
    log(f"[reduced-fleet] kill mid-stream: worker {state['worker']} killed at request "
        f"{state['victim']}; restarted {sorted(restarted)}; tokens equal the single-instance "
        f"scheduler's: {got == want}; worker errors {out.stats['worker_errors']}; pages used by "
        f"the survivors after the drain {[s.decoder.kv.pages_used for s in live]}")
    require(state["worker"] is not None, "the kill never triggered")
    require(state["victim"] in restarted, "the killed worker's request was not requeued")
    require(got == want, "tokens after a kill differ from the single-instance scheduler's")
    require(all(out.results[rid]["restarted"] == (rid in restarted) for rid in want),
            "restarted flags disagree with the router's stats")
    require(any("terminated with" in e for e in out.stats["worker_errors"].values()),
            "the killed worker's failure was not recorded")
    require(len(live) == 1 and live[0].decoder.kv.pages_used == 0,
            "the surviving worker's pool is not back")


def phase_serve_fleet(torch, serve_tokens: dict, serve_tok_s: float) -> dict:
    """Full-width gemma3-1b through a 2-worker fleet (4 slots each, paged) on
    the 16 synthetic requests, then two kill-and-respawn runs in turns with
    two plain runs on one worker, each on 4 requests, for the card's memory.
    Returns the
    timed fleet run's launch counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.common import dtype_of
    from repro_torch.serve.router import run_fleet
    from repro_torch.serve.workload import synthetic_requests

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma3-1b")
    model = build(cfg)
    L = cfg.num_layers
    n_req = SERVE_REQUESTS["n"]
    prompt_range, steps_range = SERVE_REQUESTS["prompt_range"], SERVE_REQUESTS["steps_range"]
    max_len = (prompt_range[1] - 1) + (steps_range[1] - 1)
    with Runtime("torchdev") as rt:
        params = model.init(seed=0, device=rt.processing_unit.context,
                            dtype=dtype_of(cfg.compute_dtype))
    torch.cuda.synchronize()
    fleet = dict(max_batch=4, max_len=max_len, kv_mode="paged", page_size=16, sync_interval=8,
                 msg_size=max(512, 128 + 8 * max_len), stream_interval=1)
    # warm-up, and the fleet's own cost: spawning two workers (a Runtime, a
    # scheduler and its pool each) and draining them with no request
    run_fleet(model, params, synthetic_requests(cfg.vocab_size, 2, prompt_range=(64, 65),
                                                steps_range=(9, 10), seed=1, rid_prefix="warm"),
              n_workers=2, **fleet)
    t0 = time.perf_counter()
    run_fleet(model, params, [], n_workers=2, **fleet)
    spawn_s = time.perf_counter() - t0

    requests = synthetic_requests(cfg.vocab_size, n_req, prompt_range=prompt_range,
                                  steps_range=steps_range, seed=SERVE_REQUESTS["seed"])
    first = {}

    def on_forward(router_, rid, chunk):
        if rid not in first and chunk.get("delta"):
            first[rid] = time.perf_counter() - t0

    with _worker_schedulers() as made:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = run_fleet(model, params, requests, n_workers=2, on_forward=on_forward, **fleet)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        variants = ops.variant_counts()
        peak = torch.cuda.max_memory_allocated()
        ticks = [s.ticks for s in made]
        pages = [s.decoder.kv.pages_used for s in made]
        pool_bytes = sum(k.nbytes + v.nbytes for k, v in made[0].decoder.kv.pools)
    n_tok = 0
    for r in requests:
        res = out.results[r.rid]
        toks = np.asarray(res.get("tokens", []))
        require(len(toks) == r.max_new_tokens and res.get("finish_reason") == "length",
                f"fleet {r.rid}: {res}")
        require(bool(np.all((toks >= 0) & (toks < cfg.vocab_size))), f"fleet {r.rid}: bad token")
        n_tok += len(toks)
    settled = out.stats["per_worker_settled"]
    require(out.stats["worker_errors"] == {}, f"fleet workers failed: {out.stats['worker_errors']}")
    require(len(settled) == 2 and min(settled.values()) >= 1,
            f"both workers must settle work: {settled}")
    want = {"flash_attention": n_req * L, "paged_decode_attention": sum(ticks) * L,
            "decode_attention": 0, "gated_linear_scan": 0, "fused_linear": 0,
            "flash_attention_bwd": 0, "gated_linear_scan_bwd": 0}
    require(counts == want, f"fleet launches {counts}, expected {want}")
    require_variant(variants, "flash_attention", "wgmma", want["flash_attention"], "fleet")
    require_variant(variants, "paged_decode_attention", "mma", want["paged_decode_attention"],
                    "fleet")
    require(pages == [0, 0], f"fleet workers' pages after the drain: {pages}")
    same, total = _agreement({rid: out.results[rid]["tokens"] for rid in serve_tokens},
                             serve_tokens)
    tt = np.asarray([first[r.rid] for r in requests])
    # the fleet's own cost without a second worker: one worker with all 8
    # slots, the single scheduler's batch behind the router and channels
    first, t0 = {}, time.perf_counter()
    one = run_fleet(model, params, requests, n_workers=1, on_forward=on_forward,
                    **dict(fleet, max_batch=8))
    torch.cuda.synchronize()
    wall_one = time.perf_counter() - t0
    tt_one = np.asarray([first[r.rid] for r in requests])
    require(all(len(one.results[r.rid].get("tokens", [])) == r.max_new_tokens for r in requests),
            "the one-worker fleet did not finish every request")
    log(f"[serve-fleet] gemma3-1b, 2 workers x 4 slots (paged, one card, one stream), "
        f"{n_req} requests, {n_tok} generated tokens in {wall:.3f}s: {n_tok / wall:.1f} tok/s "
        f"(the single scheduler on 8 slots, phase serve: {serve_tok_s:.1f} tok/s); TTFT p50 "
        f"{np.percentile(tt, 50) * 1e3:.1f} ms, p90 {np.percentile(tt, 90) * 1e3:.1f} ms (first "
        f"streamed token at the router, from a common start that includes spawning the workers;"
        f" spawning and draining two idle workers takes {spawn_s:.3f}s); peak device memory "
        f"{peak / 2**30:.2f} GiB; per-worker settled {settled}, decode ticks {ticks}; launches "
        f"{counts}; tokens equal to phase serve's at {same} of {total} positions "
        f"({same / total:.3f}; bf16 in other batches, reported, not required)")
    log(f"[serve-fleet] the same through 1 worker x 8 slots: {n_tok / wall_one:.1f} tok/s "
        f"({wall_one:.3f}s), TTFT p50 {np.percentile(tt_one, 50) * 1e3:.1f} ms, p90 "
        f"{np.percentile(tt_one, 90) * 1e3:.1f} ms")

    # kill-and-respawn on one worker beside the same run without the kill: a
    # killed worker's pool must be freed when its thread ends, so the card's
    # peak does not grow by a pool when its replacement allocates its own.
    # The two run in turns, plain, kill, plain, kill: the plain runs' peaks
    # show the baseline's own spread, and each kill run is held below the
    # larger of them plus half a pool (a leak adds a whole pool to both)
    few = synthetic_requests(cfg.vocab_size, 4, prompt_range=(64, 257), steps_range=(24, 33),
                             seed=2)
    peaks, results = {False: [], True: []}, {}
    for kill in (False, True, False, True):
        state, hook = _kill_mid_stream(2)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with _worker_schedulers(keep=False) as made:
            res = run_fleet(model, params, few, n_workers=1, respawn=kill,
                            on_forward=hook if kill else None, **fleet)
        torch.cuda.synchronize()
        peaks[kill].append(torch.cuda.max_memory_allocated() - base)
        gc.collect()
        left = torch.cuda.memory_allocated() - base
        results[kill] = {rid: r.get("tokens") for rid, r in res.results.items()}
        require(all(ref() is None for ref in made), "a worker's scheduler outlived its fleet")
        require(left < pool_bytes // 2, f"{left} B still allocated after the fleet")
        if kill:
            require(state["worker"] is not None and res.stats["workers_spawned"] == 2
                    and state["victim"] in res.stats["restarted"],
                    f"kill-and-respawn did not happen: {state}, {res.stats}")
    mib = lambda xs: ", ".join(f"{x / 2**20:.1f}" for x in xs)  # noqa: E731
    limit = max(peaks[False]) + pool_bytes // 2
    log(f"[serve-fleet] kill-and-respawn on one worker (4 requests, prompts 64-256), in turns "
        f"plain, kill, plain, kill: peak device memory above the weights {mib(peaks[True])} MiB "
        f"with the kill against {mib(peaks[False])} MiB without (limit {limit / 2**20:.1f} MiB:"
        f" the larger plain peak plus half of one worker's pool, {pool_bytes / 2**20:.1f} MiB);"
        f" tokens equal to the run without the kill: {results[True] == results[False]} "
        f"(reported: bf16)")
    require(all(p < limit for p in peaks[True]),
            "the card's peak memory grew by a pool over a kill-and-respawn")
    del params
    return counts


# ---------------------------------------------------------------------------
# 22. the paper's Test Cases 3 and 4, on the host of the card's machine
# ---------------------------------------------------------------------------


def phase_apps() -> None:
    """Fibonacci (fine-grained tasking, n = 14, both task managers) and
    Jacobi (coarse-grained tasking, locally and over 2 localsim instances)
    against their oracles. Host programs, as in the JAX package: the times
    are host times of this machine's CPU, not of the card."""
    import numpy as np

    from repro_torch.apps import fibonacci, jacobi

    for manager in ("coroutine", "threads"):
        out = fibonacci.run_fibonacci(14, workers=4, task_manager=manager)
        require(out["value"] == fibonacci.fib_reference(14) == 377
                and out["tasks"] == fibonacci.expected_tasks(14),
                f"fibonacci ({manager}): {out['value']}, {out['tasks']} tasks")
        log(f"[apps] fibonacci n=14 ({manager}, 4 workers): value {out['value']}, "
            f"{out['tasks']} tasks in {out['seconds']:.4f}s host time, per worker "
            f"{out['per_worker']}")
    grid = jacobi.init_grid((20, 16, 16))
    want = jacobi.jacobi_reference(grid, 4)
    for name, run in (("local, 2x2x1 subgrids", lambda: jacobi.run_local(
            grid, 4, thread_grid=(2, 2, 1))),
            ("distributed, 2 instances (rdma)", lambda: jacobi.run_distributed(
                grid, 4, instances=2, mode="rdma")),
            ("distributed, 2 instances (rendezvous)", lambda: jacobi.run_distributed(
                grid, 4, instances=2, mode="rendezvous"))):
        out = run()
        err = float(np.abs(out["grid"] - want).max())
        require(bool(np.allclose(out["grid"], want, rtol=1e-6, atol=1e-6)),
                f"jacobi ({name}) differs from the oracle by {err:.3e}")
        log(f"[apps] jacobi 20x16x16, 4 iterations ({name}): max |grid - oracle| {err:.3e}; "
            f"{out['seconds']:.4f}s host time, {out['gflops']:.3f} GFLOP/s on the host")


# ---------------------------------------------------------------------------
# 23-28. the remaining families: MoE serving (grok-1, kimi-k2), paligemma-3b
# and whisper-small through their bundles
# ---------------------------------------------------------------------------

MOE_FAMILY = ("grok-1-314b", "kimi-k2-1t-a32b")
#: full-width layers each MoE config keeps on one 80 GB card (of 64 and 61):
#: the published widths, the depth cut (grok 3.31 G parameters a layer, kimi
#: 17.03 G, beside 1.61 G and 2.35 G of untied embeddings)
MOE_LAYERS = {"grok-1-314b": 8, "kimi-k2-1t-a32b": 1}
#: (flash, decode core) variants their serves launch: both prefills take
#: flash's wgmma (grok's 6 query heads a KV head: 10 positions, 60 of 64
#: rows; kimi's hd 112 pads to 128 columns); both ticks take the decode
#: core's mma walk (kimi's hd 112 at its own width)
MOE_VARIANTS = {"grok-1-314b": ("wgmma", "mma"), "kimi-k2-1t-a32b": ("wgmma", "mma")}
#: kv modes each full-width MoE config serves (grok also the dense per-slot
#: decoder, whose MoE keeps the reference's per-slot capacity: no drop)
MOE_MODES = {"grok-1-314b": ("paged", "dense"), "kimi-k2-1t-a32b": ("paged",)}


@contextlib.contextmanager
def _moe_drops(torch):
    """Counts the rows MoE layers drop by capacity, in prefills (S > 1) and in
    decode ticks, by wrapping `models.moe.moe_ffn` (which the transformer
    calls through its module); the counts stay on the device until read."""
    from repro_torch.models import moe

    real = moe.moe_ffn
    tally = {"prefill": [], "tick": [], "prefill_rows": 0, "tick_rows": 0}

    def counted(cfg, p, x, *, dropless=False):
        y, aux = real(cfg, p, x, dropless=dropless)
        where = "prefill" if x.shape[1] > 1 else "tick"
        tally[where].append(aux["dropped"].sum())
        tally[f"{where}_rows"] += aux["dropped"].numel()
        return y, aux

    moe.moe_ffn = counted
    try:
        yield tally
    finally:
        moe.moe_ffn = real


def _drops(torch, tally, where: str) -> int:
    return int(torch.stack(tally[where]).sum().item()) if tally[where] else 0


def phase_reduced_moe(torch) -> None:
    """grok-1 and kimi-k2 REDUCED in fp32 on the card against the CPU: prefill
    plus 16 teacher-forced dense ticks (logits within 1e-4, equal greedy
    tokens), then the dense and the paged continuous serve and a serial
    `generate` (equal tokens, every page back)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.workload import synthetic_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in MOE_FAMILY:
        cfg = get_config(arch, reduced=True)
        require(cfg.compute_dtype == "float32", f"REDUCED {arch} computes in fp32")
        model = build(cfg)
        params_cpu = model.init(seed=0, device="cpu")
        params_card = _to_device(params_cpu, "cuda")
        rng = np.random.default_rng(7)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (45, 12, 3)]
        steps = rng.integers(1, cfg.vocab_size, (16, len(prompts))).tolist()
        ops.reset_launch_counts()
        on_card = dense_logits(torch, cfg, params_card, prompts, steps, "cuda")
        counts = ops.launch_counts()
        require_fp32_flash("reduced-moe")
        on_cpu = dense_logits(torch, cfg, params_cpu, prompts, steps, "cpu")
        require(counts["flash_attention"] == len(prompts) * cfg.num_layers
                and counts["decode_attention"] == len(steps) * cfg.num_layers,
                f"reduced {arch} run did not go through the kernels: {counts}")
        worst = max(float((a - b).abs().max()) for a, b in zip(on_card, on_cpu))
        same_greedy = all(torch.equal(a.argmax(-1), b.argmax(-1)) for a, b in zip(on_card, on_cpu))

        requests = synthetic_requests(cfg.vocab_size, 6, prompt_range=(3, 40),
                                      steps_range=(2, 14), seed=0)
        engine_prompts = rng.integers(1, cfg.vocab_size, (3, 9)).astype(np.int32)
        served, generated, launches, pages = {}, {}, {}, {}
        for device, params in (("cuda", params_card), ("cpu", params_cpu)):
            with Runtime("torchdev", device=device) as rt:
                ops.reset_launch_counts()
                for kv_mode in ("dense", "paged"):
                    sched = ContinuousBatchingScheduler(
                        model, params, max_batch=4, max_len=64, runtime=rt, kv_mode=kv_mode,
                        page_size=8, sync_interval=4)
                    served[device, kv_mode] = {rid: f.tokens
                                               for rid, f in sched.serve(requests).items()}
                    if kv_mode == "paged":
                        pages[device] = sched.decoder.kv.pages_used
                engine = ServeEngine(model, params, max_len=40, runtime=rt)
                generated[device] = engine.generate(engine_prompts, steps=12).tokens
                launches[device] = ops.launch_counts()
                require_fp32_flash("reduced-moe")
        same = {m: served["cuda", m] == served["cpu", m] for m in ("dense", "paged")}
        log(f"[reduced-moe] {arch} REDUCED fp32 ({cfg.num_layers} layers, {cfg.num_experts} "
            f"experts top-{cfg.experts_per_token}, {cfg.act}, {cfg.num_heads}q/"
            f"{cfg.num_kv_heads}kv x {cfg.resolved_head_dim}): prefill of {len(prompts)} prompts "
            f"+ {len(steps)} teacher-forced dense ticks: max |logits card - cpu| = {worst:.3e} "
            f"(atol {REDUCED_ATOL}), greedy tokens equal: {same_greedy}; dense and paged serves "
            f"of {len(requests)} requests and serial generate (3 x 9, 12 steps): card tokens "
            f"equal CPU tokens: {same}, generate "
            f"{bool(np.array_equal(generated['cuda'], generated['cpu']))}; pages used after the "
            f"drain {pages}; card launches {launches['cuda']}")
        require(worst <= REDUCED_ATOL, f"REDUCED {arch} logits differ by {worst:.3e}")
        require(same_greedy, f"REDUCED {arch} greedy tokens differ between the card and the CPU")
        require(launches["cuda"]["paged_decode_attention"] > 0
                and launches["cuda"]["decode_attention"] > 0,
                f"the {arch} serves and engine launched no decode kernel")
        require(all(same.values()), f"REDUCED {arch} serve tokens differ card vs CPU: {same}")
        require(bool(np.array_equal(generated["cuda"], generated["cpu"])),
                f"REDUCED {arch} serial generate tokens differ card vs CPU")
        require(pages == {"cuda": 0, "cpu": 0}, f"{arch}: pages left after the drain: {pages}")


def phase_serve_moe(torch) -> dict:
    """grok-1 (8 of 64 layers) and kimi-k2 (1 of 61) at their published widths
    (bf16, seeded weights made on the card) serve the 16 synthetic requests
    on 8 slots through the paged scheduler, grok also through the dense one.
    One config's weights are freed before the next is made. Returns launch
    counts by path."""
    counts = {}
    for arch in MOE_FAMILY:
        counts.update(_serve_moe_config(torch, arch))
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated()
        require(left < 2**30, f"{arch}: {left / 2**30:.2f} GiB still allocated after its phase")
    return counts


def _serve_moe_config(torch, arch: str) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.common import dtype_of
    from repro_torch.models.moe import capacity
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.workload import synthetic_requests

    tag = f"[serve-moe] {arch}"
    full = get_config(arch)
    cfg = full.replace(num_layers=MOE_LAYERS[arch])
    model = build(cfg)
    L = cfg.num_layers
    n_req = SERVE_REQUESTS["n"]
    prompt_range, steps_range = SERVE_REQUESTS["prompt_range"], SERVE_REQUESTS["steps_range"]
    max_len = (prompt_range[1] - 1) + (steps_range[1] - 1)
    flash_kind, decode_kind = MOE_VARIANTS[arch]
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    require(base < 2**30, f"{arch}: {base / 2**30:.2f} GiB allocated before its phase")
    with Runtime("torchdev") as rt:
        t0 = time.perf_counter()
        params = model.init(seed=0, device=rt.processing_unit.context,
                            dtype=dtype_of(cfg.compute_dtype))
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        weights = torch.cuda.memory_allocated() - base
        experts = sum(t.nbytes for layer in params["layers"] for name, t in layer["moe"].items()
                      if name != "router")
        log(f"{tag}: {L} of {full.num_layers} layers at the published widths (d_model "
            f"{cfg.d_model}, {cfg.num_heads}q/{cfg.num_kv_heads}kv heads x "
            f"{cfg.resolved_head_dim}, {cfg.num_experts} experts top-{cfg.experts_per_token} of "
            f"d_ff {cfg.expert_d_ff} ({cfg.act}), vocab {cfg.vocab_size} untied, "
            f"{cfg.compute_dtype}); {n_params} parameters ({weights / 2**30:.2f} GiB, experts "
            f"{experts / 2**30:.2f} GiB) made on the card in {time.perf_counter() - t0:.1f}s")
        for kv_mode in MOE_MODES[arch]:
            path = f"serve-{arch}" + ("" if kv_mode == "paged" else f" {kv_mode}")
            sched = ContinuousBatchingScheduler(model, params, max_batch=8, max_len=max_len,
                                                runtime=rt, kv_mode=kv_mode, page_size=16,
                                                sync_interval=8)
            warm = synthetic_requests(cfg.vocab_size, 2, prompt_range=(64, 65),
                                      steps_range=(9, 10), seed=1, rid_prefix="warm")
            sched.serve(warm)
            requests = synthetic_requests(cfg.vocab_size, n_req, prompt_range=prompt_range,
                                          steps_range=steps_range, seed=SERVE_REQUESTS["seed"])
            ticks0 = sched.ticks
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            with _moe_drops(torch) as tally:
                wall, ttft, _, tokens = _timed_serve(torch, sched, requests)
                counts = ops.launch_counts()
                variants = ops.variant_counts()
            dropped = {w: _drops(torch, tally, w) for w in ("prefill", "tick")}
            peak = torch.cuda.max_memory_allocated() - base
            ticks = sched.ticks - ticks0
            if kv_mode == "paged":
                state = sum(k.nbytes + v.nbytes for k, v in sched.decoder.kv.pools)
            else:
                state = sum(t.nbytes for kv in sched.decoder._states for t in kv)
            n_tok = 0
            for r in requests:
                toks = np.asarray(tokens[r.rid])
                require(len(toks) == r.max_new_tokens,
                        f"{path} {r.rid}: {len(toks)} tokens, budget {r.max_new_tokens}")
                require(bool(np.all((toks >= 0) & (toks < cfg.vocab_size))),
                        f"{path} {r.rid}: token out of range")
                n_tok += len(toks)
            decode = "paged_decode_attention" if kv_mode == "paged" else "decode_attention"
            want = {"flash_attention": n_req * L, "paged_decode_attention": 0,
                    "decode_attention": 0, "gated_linear_scan": 0, "fused_linear": 0,
                "flash_attention_bwd": 0, "gated_linear_scan_bwd": 0}
            want[decode] = ticks * L
            require(counts == want, f"{path} launches {counts}, expected {want}")
            require_variant(variants, "flash_attention", flash_kind, want["flash_attention"], path)
            require_variant(variants, decode, decode_kind, want[decode], path)
            if kv_mode == "paged":
                require(sched.decoder.kv.pages_used == 0, f"{path}: pages left after the drain")
            else:  # the per-slot capacity: a dense tick never drops a row
                require(dropped["tick"] == 0, f"{path}: dense ticks dropped {dropped['tick']} rows")
            tt = np.asarray(list(ttft.values()))
            plens = [len(r.prompt) for r in requests]
            log(f"{tag} {kv_mode}: {n_req} requests (prompts {min(plens)}-{max(plens)} tokens, "
                f"{sum(plens)} prompt tokens), {n_tok} generated tokens in {wall:.3f}s: "
                f"{n_tok / wall:.1f} tok/s; TTFT p50 {np.percentile(tt, 50) * 1e3:.1f} ms, p90 "
                f"{np.percentile(tt, 90) * 1e3:.1f} ms (from a common start, queueing included); "
                f"{ticks} decode ticks; peak device memory above the base {peak / 2**30:.2f} GiB "
                f"(weights {weights / 2**30:.2f}, {'page pool' if kv_mode == 'paged' else 'slot caches'}"
                f" {state / 2**30:.2f}, the rest {(peak - weights - state) / 2**30:.2f}); rows "
                f"dropped by capacity: {dropped['prefill']} of {tally['prefill_rows']} in "
                f"prefills (capacity at a 1024-token prompt {capacity(cfg, 1024)} an expert), "
                f"{dropped['tick']} of {tally['tick_rows']} in ticks; launches {counts}, by "
                f"variant flash {variants['flash_attention']}, decode {variants[decode]}")
            for r in requests[:2]:
                log(f"{tag} {kv_mode} {r.rid}: prompt {len(r.prompt)} tokens -> "
                    f"{tokens[r.rid][:8]}...")
            out[path] = counts
            del sched
            gc.collect()
        del params
    return out


def _bundle_generate(torch, model, params, batch, steps: int, first_pos: int, max_len: int):
    """Greedy decoding through a `ModelBundle`: `make_prefill(max_len)` on the
    batch, then `steps - 1` `decode_step`s at a shared position from
    `first_pos`. Returns (tokens (B, steps) on the host, TTFT s, wall s,
    prefill logits, last logits)."""
    prefill = model.make_prefill(max_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, batch)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok.cpu()]  # the first token, on the host
    ttft = time.perf_counter() - t0
    first_logits = logits.float().cpu()
    for i in range(steps - 1):
        logits, state = model.decode_step(params, state, {"tokens": tok[:, None],
                                                          "pos": first_pos + i})
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok.cpu())
    wall = time.perf_counter() - t0
    return torch.stack(out, dim=1).numpy(), ttft, wall, first_logits, logits.float().cpu()


def _reduced_bundle(torch, arch: str, extra: str, make_extra, n_text: int, tag: str):
    """A REDUCED fp32 bundle on the card against the CPU, 3 requests: prefill
    logits within 1e-4 and a greedy chain of 16 tokens identical. Returns
    (the config, the card run's launch counts)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch, reduced=True)
    require(cfg.compute_dtype == "float32", f"REDUCED {arch} computes in fp32")
    model = build(cfg)
    params_cpu = model.init(seed=0, device="cpu")
    params_card = _to_device(params_cpu, "cuda")
    rng = np.random.default_rng(11)
    tokens = rng.integers(1, cfg.vocab_size, (3, n_text)).astype(np.int32)
    ext = make_extra(rng, cfg, 3)
    prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    chain, runs = 16, {}
    for device, params in (("cuda", params_card), ("cpu", params_cpu)):
        batch = {"tokens": torch.as_tensor(tokens, device=device),
                 extra: torch.as_tensor(ext, device=device)}
        ops.reset_launch_counts()
        runs[device] = _bundle_generate(torch, model, params, batch, chain, prefix + n_text,
                                        prefix + n_text + chain)
        runs[device] += (ops.launch_counts(),)
        require_fp32_flash(tag)
    err_first = float((runs["cuda"][3] - runs["cpu"][3]).abs().max())
    err_last = float((runs["cuda"][4] - runs["cpu"][4]).abs().max())
    same = bool(np.array_equal(runs["cuda"][0], runs["cpu"][0]))
    counts = runs["cuda"][5]
    log(f"[{tag}] {arch} REDUCED fp32 (B=3, {n_text}-token prompts"
        + (f" after {prefix} vision tokens" if prefix else "") + f"): prefill max |logits card "
        f"- cpu| = {err_first:.3e}, after {chain - 1} decode steps {err_last:.3e} (atol "
        f"{REDUCED_ATOL}); greedy chains of {chain} equal: {same}; card launches {counts}")
    require(err_first <= REDUCED_ATOL and err_last <= REDUCED_ATOL,
            f"REDUCED {arch} logits differ: {err_first:.3e}, {err_last:.3e}")
    require(same, f"REDUCED {arch} greedy chains differ between the card and the CPU")
    require(runs["cpu"][5]["flash_attention"] == 0, "the CPU run launched a kernel")
    return cfg, counts


def phase_reduced_vlm(torch) -> None:
    def patches(rng, cfg, B):
        return rng.standard_normal((B, cfg.vision_tokens, cfg.vision_embed_dim)).astype("float32")

    cfg, counts = _reduced_bundle(torch, "paligemma-3b", "patches", patches, 7, "reduced-vlm")
    L = cfg.num_layers
    require(counts["flash_attention"] == L and counts["decode_attention"] == 15 * L,
            f"REDUCED paligemma did not go through the kernels: {counts}")


def phase_reduced_whisper(torch) -> None:
    def frames(rng, cfg, B):
        return (rng.standard_normal((B, cfg.encoder_context, cfg.d_model)) * 0.02).astype(
            "float32")

    cfg, counts = _reduced_bundle(torch, "whisper-small", "frames", frames, 5, "reduced-whisper")
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    require(counts["flash_attention"] == Le + 2 * Ld + 15 * Ld
            and counts["decode_attention"] == 15 * Ld,
            f"REDUCED whisper did not go through the kernels: {counts}")


GENERATE = {  # B, prompt tokens, generated tokens of the two bundle phases
    "paligemma-3b": dict(B=8, prompt=32, steps=64),
    "whisper-small": dict(B=8, prompt=16, steps=128),
}


def phase_generate_bundle(torch, arch: str) -> dict:
    """paligemma-3b (18 layers) or whisper-small (12 + 12) at full width,
    bf16, seeded: a batch of 8 requests through the bundle, prefill with
    their seeded patches (256 x 1152) or frames (1500 x 768, x 0.02, as the
    reference's `make_batch`), then greedy decoding. Checks finite logits,
    tokens in the vocabulary, exact launch counts and variants. Returns the
    launch counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.common import dtype_of

    tag = f"[generate-{arch.split('-')[0]}]"
    cfg = get_config(arch)
    model = build(cfg)
    cd = dtype_of(cfg.compute_dtype)
    g = GENERATE[arch]
    B, S, steps = g["B"], g["prompt"], g["steps"]
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda", dtype=cd)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    weights = torch.cuda.memory_allocated() - base
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen, device="cuda",
                           dtype=torch.int32)
    if cfg.family == "vlm":
        extra = "patches"
        ext = torch.randn((B, cfg.vision_tokens, cfg.vision_embed_dim), generator=gen,
                          device="cuda").to(cd)
        prefix = cfg.vision_tokens
    else:
        extra = "frames"
        ext = (torch.randn((B, cfg.encoder_context, cfg.d_model), generator=gen,
                           device="cuda") * 0.02).to(cd)
        prefix = 0
    log(f"{tag} {arch}: {cfg.num_layers} layers" + (
        f" + {cfg.encoder_layers} encoder layers over {cfg.encoder_context} frames"
        if cfg.family == "audio" else f", a {cfg.vision_tokens}-token vision prefix") +
        f", d_model {cfg.d_model}, {cfg.num_heads}q/{cfg.num_kv_heads}kv x "
        f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, {cfg.compute_dtype}; {n_params} "
        f"parameters ({weights / 2**30:.2f} GiB) made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    batch = {"tokens": tokens, extra: ext}
    max_len = prefix + S + steps
    _bundle_generate(torch, model, params, {"tokens": tokens[:2], extra: ext[:2]}, 2,
                     prefix + S, max_len)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out, ttft, wall, first, last = _bundle_generate(torch, model, params, batch, steps,
                                                    prefix + S, max_len)
    counts = ops.launch_counts()
    variants = ops.variant_counts()
    peak = torch.cuda.max_memory_allocated() - base
    require(out.shape == (B, steps), f"{arch}: tokens of shape {out.shape}")
    require(bool(np.all((out >= 0) & (out < cfg.vocab_size))), f"{arch}: token out of range")
    require(bool(torch.isfinite(first).all()) and bool(torch.isfinite(last).all()),
            f"{arch}: logits not finite")
    L = cfg.num_layers
    if cfg.family == "vlm":
        want_flash = L
    else:  # encoder, decoder self and cross at prefill, cross every step
        want_flash = cfg.encoder_layers + 2 * L + (steps - 1) * L
    want = {"flash_attention": want_flash, "decode_attention": (steps - 1) * L,
            "paged_decode_attention": 0, "gated_linear_scan": 0, "fused_linear": 0,
            "flash_attention_bwd": 0, "gated_linear_scan_bwd": 0}
    require(counts == want, f"{arch} launches {counts}, expected {want}")
    require_variant(variants, "flash_attention", "wgmma", want_flash, arch)
    require_variant(variants, "decode_attention", "mma", want["decode_attention"], arch)
    n_tok = B * steps
    log(f"{tag} {arch}: B={B}, {S}-token prompts{' after the vision prefix' if prefix else ''}"
        f", {steps} greedy tokens each: {n_tok} tokens in {wall:.3f}s: {n_tok / wall:.1f} "
        f"tok/s; first token after {ttft * 1e3:.1f} ms (prefill{' with the encoder' if not prefix else ''}); "
        f"peak device memory above the base {peak / 2**30:.2f} GiB (weights "
        f"{weights / 2**30:.2f}); launches {counts}; flash by variant "
        f"{variants['flash_attention']}, decode by variant {variants['decode_attention']}")
    log(f"{tag} request 0 -> {out[0, :8].tolist()}...")
    del params, batch, ext
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# 29-31. training: REDUCED card = CPU, full-width gemma3-1b, resume
# ---------------------------------------------------------------------------

#: the CPU test's optimizer (tests/test_torch_train.py: the reference's
#: `TestMicrobatching` AdamW) and tolerances of one step, card against CPU
TRAIN_OPT = dict(name="adamw", learning_rate=1e-3)
TRAIN_TOL = {"metrics": dict(rtol=1e-5, atol=0.0), "grads": dict(rtol=1e-4, atol=1e-6),
             "params": dict(rtol=1e-4, atol=1e-5)}
RESUME_TOL = dict(rtol=1e-6, atol=1e-7)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _tree_misfit(torch, a, b, *, rtol, atol) -> tuple:
    """(largest |a - b| beyond atol + rtol |b| over two trees' leaves, 0 if
    none; the largest |a - b|)."""
    worst = misfit = 0.0
    for (path, x), (_, y) in zip(_paths(a), _paths(b), strict=True):
        x, y = x.detach().cpu().float(), y.detach().cpu().float()
        d = (x - y).abs()
        worst = max(worst, float(d.max()))
        misfit = max(misfit, float((d - atol - rtol * y.abs()).clamp_min(0).max()))
    return misfit, worst


def _one_train_step(torch, cfg, params, batch, device):
    """One AdamW step of `cfg` from `params` (CPU tensors) on `device`:
    (new params, gradients, metrics), back on the CPU."""
    from repro_torch.models import build
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts

    ocfg = topt.OptimizerConfig(**TRAIN_OPT)
    seen = []
    step = tts.make_train_step(build(cfg), ocfg, grads_hook=seen.append)
    p = _to_device(params, device)
    new, _, _, metrics = step(p, topt.init(ocfg, p), None, batch)
    return (_to_device(new, "cpu"), _to_device(seen[0], "cpu"),
            {k: float(v) for k, v in metrics.items()})


def phase_reduced_train(torch) -> None:
    """One AdamW step of REDUCED gemma3-1b in fp32 (TF32 off) on the card
    against the same step on the CPU, within the CPU test's tolerances;
    every attention's forward and backward on the kernels."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.train.data import SyntheticTokenStream

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("gemma3-1b", reduced=True)
    require(cfg.compute_dtype == "float32", "REDUCED gemma3-1b computes in fp32")
    params = build(cfg).init(seed=0, device="cpu")
    batch = SyntheticTokenStream(cfg, ShapeConfig("t", 32, 4, "train")).next_batch()
    ops.reset_launch_counts()
    card = _one_train_step(torch, cfg, params, batch, "cuda")
    counts, variants = ops.launch_counts(), ops.variant_counts()
    require_fp32_flash("reduced-train")
    cpu = _one_train_step(torch, cfg, params, batch, "cpu")
    keys = ("loss", "ce_loss", "grad_norm", "lr")
    metric_err = max(abs(card[2][k] - cpu[2][k]) / max(abs(cpu[2][k]), 1e-30) for k in keys)
    grad_misfit, grad_err = _tree_misfit(torch, card[1], cpu[1], **TRAIN_TOL["grads"])
    param_misfit, param_err = _tree_misfit(torch, card[0], cpu[0], **TRAIN_TOL["params"])
    log(f"[reduced-train] gemma3-1b REDUCED fp32, one AdamW step (B=4 x 32 tokens): loss card "
        f"{card[2]['loss']:.6f}, cpu {cpu[2]['loss']:.6f}; metrics max rel err {metric_err:.3e} "
        f"(rtol {TRAIN_TOL['metrics']['rtol']}); gradients max |card - cpu| {grad_err:.3e} "
        f"({TRAIN_TOL['grads']}); updated params {param_err:.3e} ({TRAIN_TOL['params']}); "
        f"launches {counts}")
    require(metric_err <= TRAIN_TOL["metrics"]["rtol"], f"metrics differ by {metric_err:.3e}")
    require(grad_misfit == 0.0, f"gradients differ beyond tolerance by {grad_misfit:.3e}")
    require(param_misfit == 0.0, f"updated params differ beyond tolerance by {param_misfit:.3e}")
    fwd, bwd, _, _ = expected_train_launches(cfg)
    require(counts["flash_attention"] == fwd and counts["flash_attention_bwd"] == bwd,
            f"the step did not run every attention through the kernels ({fwd} forward launches "
            f"with remat_policy={cfg.remat_policy!r}'s recompute, {bwd} backward): {counts}")
    require_variant(variants, "flash_attention_bwd", "tf32x3", bwd, "reduced-train")


def expected_train_launches(cfg) -> tuple:
    """(flash forward, flash backward, scan forward, scan backward) launches
    of one training step of `cfg`. Under a `remat_policy` other than "none"
    every forward inside a rematerialised region runs again in the backward
    (the kernels launch outside the dispatcher, so no policy keeps their
    outputs): the transformer's layers (or units), the encoder-decoder's
    layers, the hybrid's groups; xlstm has no region, the hybrid's tail
    layers none."""
    r = 1 if cfg.remat_policy == "none" else 2
    if cfg.family in ("dense", "moe", "vlm"):
        return r * cfg.num_layers, cfg.num_layers, 0, 0
    if cfg.family == "audio":
        attn = cfg.encoder_layers + 2 * cfg.num_layers  # encoder, decoder self and cross
        return r * attn, attn, 0, 0
    if cfg.family == "ssm":
        from repro_torch.models.xlstm_model import block_kinds

        m = block_kinds(cfg).count("mlstm")
        return 0, 0, m, m
    g, n_groups = cfg.shared_attn_interval, cfg.num_layers // cfg.shared_attn_interval
    return r * n_groups, n_groups, r * n_groups * g + cfg.num_layers % g, cfg.num_layers


def _plain_scan(q, k, v, log_a, *, chunk: int = 128, initial_state=None, normaliser=False,
                initial_normaliser=None, impl=None):
    """`ops.gated_linear_scan`'s plain version on any device (`impl`, the
    CPU route's choice of twin, does not apply)."""
    from repro_torch.kernels import ref

    if normaliser:
        return ref.gated_linear_scan_normalised(q, k, v, log_a, chunk=chunk,
                                                initial_state=initial_state,
                                                initial_normaliser=initial_normaliser)
    return ref.gated_linear_scan(q, k, v, log_a, chunk=chunk, initial_state=initial_state)


@contextlib.contextmanager
def plain_kernels():
    """`ops.attention` and `ops.gated_linear_scan` swapped for their plain
    versions (the models call them through the module)."""
    from repro_torch.kernels import ops, ref

    saved = ops.attention, ops.gated_linear_scan
    ops.attention = lambda *a, impl=None, **kw: ref.attention(*a, **kw)  # noqa: E731
    ops.gated_linear_scan = _plain_scan
    try:
        yield
    finally:
        ops.attention, ops.gated_linear_scan = saved


def _device_breakdown(torch, prof, wall_s: float) -> dict:
    """Device time by kernel name in a profiler trace: busy seconds, idle
    share of `wall_s`, and the ten largest names with their totals."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    groups = {"flash backward": ("flash_bwd",), "flash forward": ("flash_attention",),
              "scan backward": ("scan_bwd",), "scan forward": ("scan_mma", "scan_simt",
                                                                "scan_step"),
              "products (cuBLAS)": ("gemm", "nvjet", "cutlass", "sm90_xmma", "Kernel2")}
    split = {g: sum(t for n, t in by_name.items() if any(m in n for m in marks)) / 1e6
             for g, marks in groups.items()}
    split["other"] = busy - sum(split.values())
    return {"busy_s": busy, "wall_s": wall_s, "idle_share": 1 - busy / wall_s,
            "by_group_s": split, "top": [(n[:90], t / 1e6) for n, t in top]}


def phase_train(torch) -> dict:
    """gemma3-1b at full width (26 layers, d_model 1152, 4 query heads over 1
    at hd 256, window 512 on 22 layers, tied vocab 262144): fp32 masters,
    bf16 compute, AdamW, B=4 x S=1024, 6 steps through the launcher
    (`launch/train.py::train`). Requires finite losses, every parameter's
    gradient finite and non-zero after step 1 (wq, wk, wv of every layer
    included: their gradient comes only through the flash backward kernel),
    the step-0 loss within 1e-2 relative of the same weights' loss through
    the plain attention, and exactly 52 flash forward launches a step (26,
    and 26 again in the backward: `remat_policy="minimal"` recomputes each
    unit) and 26 backward launches, all on wgmma. Then one more step under the
    profiler, for where its time goes and the backward's share of it. Returns
    the 6 steps' launch counts and their counts by variant."""
    import math

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts
    from repro_torch.train.data import SyntheticTokenStream

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma3-1b")
    B, S, steps = 4, 1024, 6
    model = build(cfg)
    stream = SyntheticTokenStream(cfg, ShapeConfig("train", S, B, "train"))
    batch0 = tts.batch_to(stream.next_batch(), "cuda")
    with torch.no_grad(), plain_kernels():  # the launcher's weights (seed 0)
        params = model.init(seed=0, device="cuda")
        n_params = sum(t.numel() for _, t in _paths(params))
        plain_loss = float(model.loss(params, batch0)[0])
    del params
    gc.collect()
    torch.cuda.empty_cache()

    hook, first = _first_grads_hook(torch)
    args = train_cli.parse_args(["--arch", "gemma3-1b", "--steps", str(steps), "--batch", str(B),
                                 "--seq", str(S), "--log-every", "1"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params, opt_state, history = train_cli.train(args, grads_hook=hook)
    counts = ops.launch_counts()
    variants = ops.variant_counts()
    peak = torch.cuda.max_memory_allocated() - base
    state_bytes = sum(t.nbytes for _, t in _paths(params) + _paths(opt_state))

    losses = [h["loss"] for h in history]
    warm = history[1:]
    ms = [h["seconds"] * 1e3 for h in history]
    mean_ms = sum(h["seconds"] for h in warm) / len(warm) * 1e3
    tok_s = B * S / (mean_ms / 1e3)
    L = cfg.num_layers
    log(f"[train] gemma3-1b full width ({n_params} parameters, fp32 masters, bf16 compute, "
        f"AdamW), B={B} x S={S} = {B * S} tokens a step, {steps} steps through the launcher: "
        f"losses {[round(x, 5) for x in losses]}, grad_norm "
        f"{[round(h['grad_norm'], 4) for h in history]}, lr "
        f"{[round(h['lr'], 8) for h in history]}")
    log(f"[train] ms a step {[round(x, 2) for x in ms]}: steps 2-{steps} {mean_ms:.2f} ms "
        f"= {tok_s:.0f} training tok/s (step 1, with the first calls' set-up, {ms[0]:.2f} ms); "
        f"peak device memory above the baseline {peak / 2**30:.2f} GiB (params + AdamW state "
        f"{state_bytes / 2**30:.2f} GiB); step-0 loss {losses[0]:.6f} against {plain_loss:.6f} "
        f"through the plain attention (ln V = {math.log(cfg.vocab_size):.4f}); launches "
        f"{counts}, flash by variant {variants['flash_attention']}, its backward by variant "
        f"{variants['flash_attention_bwd']}")
    _check_training("train", losses, plain_loss, first, len(_paths(params)))
    TRAIN_RECORD.update(losses=losses, mean_ms=mean_ms, ms=ms)
    fwd, bwd, _, _ = expected_train_launches(cfg)
    require(counts["flash_attention"] == fwd * steps
            and counts["flash_attention_bwd"] == bwd * steps
            and sum(counts.values()) == (fwd + bwd) * steps,
            f"expected {fwd} flash forward (remat_policy={cfg.remat_policy!r}) and {bwd} backward "
            f"launches a step: {counts}")
    require_variant(variants, "flash_attention", "wgmma", fwd * steps, "train")
    require_variant(variants, "flash_attention_bwd", "wgmma", L * steps, "train")

    # one more step under the profiler: where a step's time goes
    ocfg = topt.OptimizerConfig(name="adamw", learning_rate=args.lr, warmup_steps=20,
                                decay_steps=100)
    step = tts.make_train_step(model, ocfg)
    batch = stream._batch_for(steps)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = step(params, opt_state, None, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del out
    br = _device_breakdown(torch, prof, wall)
    _log_breakdown("train", br)
    bwd_s = br["by_group_s"]["flash backward"]
    log(f"[train] the flash backward's share of the traced step's device time: "
        f"{bwd_s * 1e3:.2f} of {br['busy_s'] * 1e3:.2f} ms ({bwd_s / br['busy_s']:.4f}), "
        f"{L} calls on wgmma")
    del params, opt_state, prof
    gc.collect()
    torch.cuda.empty_cache()
    return counts, variants


def phase_train_resume(torch) -> None:
    """REDUCED gemma3-1b in fp32 on the card through the launcher: 4 steps,
    against 2 steps with a checkpoint, then a second launch that resumes
    from it (data stream state included) for 2 more; the parameters agree
    within rtol 1e-6 / atol 1e-7."""
    import tempfile

    from repro_torch.launch import train as train_cli

    base = ["--arch", "gemma3-1b", "--reduced", "--batch", "4", "--seq", "32",
            "--log-every", "1"]
    straight, _, _ = train_cli.train(train_cli.parse_args(base + ["--steps", "4"]))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        resume = base + ["--ckpt-dir", ckpt_dir, "--ckpt-every", "2"]
        train_cli.train(train_cli.parse_args(resume + ["--steps", "2"]))
        resumed, opt_state, history = train_cli.train(train_cli.parse_args(
            resume + ["--steps", "4"]))
    misfit, worst = _tree_misfit(torch, resumed, straight, **RESUME_TOL)
    log(f"[train-resume] REDUCED gemma3-1b on the card: 4 steps against 2 + checkpoint + "
        f"resume + 2: max |param difference| {worst:.3e} ({RESUME_TOL}); the resumed run's "
        f"steps {[h['step'] for h in history]}, optimizer count {int(opt_state['count'])}")
    require([h["step"] for h in history] == [3, 4] and int(opt_state["count"]) == 4,
            "the second launch did not resume from step 2")
    require(misfit == 0.0, f"the resumed parameters differ beyond tolerance by {misfit:.3e}")


# ---------------------------------------------------------------------------
# 32-35. training of every family: REDUCED card = CPU, xlstm-125m, zamba2-7b,
# paligemma-3b and whisper-small on the card
# ---------------------------------------------------------------------------

#: families whose card gradients walk the scan position by position (the
#: backward kernel) where the CPU sums chunks: held per leaf to max |d| /
#: max |cpu| (the fp32 gradient of the chunked log decay cancels large terms;
#: tests/test_torch_train_families.py)
SCAN_FAMILIES = ("ssm", "hybrid")


def _bad_grads(torch, grads) -> list:
    """Paths of the leaves whose gradient is not finite or is zero."""
    return [p for p, g in _paths(grads)
            if not (bool(torch.isfinite(g).all()) and bool((g != 0).any()))]


def phase_reduced_train_families(torch) -> None:
    """One AdamW step of every family REDUCED in fp32 (TF32 off) on the card
    against the same step on the CPU, on a `make_batch` batch (B=2 x 64):
    metrics within rtol 1e-5, gradients rtol 1e-4 / atol 1e-6 (xlstm and
    zamba2: max |d| / max |cpu| <= 1e-4 per leaf), updated parameters rtol
    1e-4 / atol 1e-5; every gradient finite and non-zero; every attention
    and scan through the kernels, forward and backward
    (`expected_train_launches`)."""
    from repro_torch.configs import ARCH_IDS, ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        require(cfg.compute_dtype == "float32", f"REDUCED {arch} computes in fp32")
        model = build(cfg)
        params = model.init(seed=0, device="cpu")
        batch = model.make_batch(torch.Generator().manual_seed(1),
                                 ShapeConfig("t", 64, 2, "train"))
        ops.reset_launch_counts()
        card = _one_train_step(torch, cfg, params, batch, "cuda")
        counts, variants = ops.launch_counts(), ops.variant_counts()
        require_fp32_flash("reduced-train-families")
        cpu = _one_train_step(torch, cfg, params, batch, "cpu")
        keys = ("loss", "ce_loss", "grad_norm", "lr")
        metric_err = max(abs(card[2][k] - cpu[2][k]) / max(abs(cpu[2][k]), 1e-30) for k in keys)
        if cfg.family in SCAN_FAMILIES:
            grad_rel = max(float((a.float() - b.float()).abs().max()
                                 / b.float().abs().max().clamp_min(1e-30))
                           for (_, a), (_, b) in zip(_paths(card[1]), _paths(cpu[1])))
            grad_ok, grad_note = grad_rel <= 1e-4, f"max |d| / max |cpu| {grad_rel:.3e} (1e-4)"
        else:
            misfit, worst = _tree_misfit(torch, card[1], cpu[1], **TRAIN_TOL["grads"])
            grad_ok, grad_note = misfit == 0.0, f"max |d| {worst:.3e} ({TRAIN_TOL['grads']})"
        param_misfit, param_err = _tree_misfit(torch, card[0], cpu[0], **TRAIN_TOL["params"])
        bad = _bad_grads(torch, card[1])
        want = expected_train_launches(cfg)
        got = tuple(counts[k] for k in ("flash_attention", "flash_attention_bwd",
                                        "gated_linear_scan", "gated_linear_scan_bwd"))
        log(f"[reduced-train-families] {arch} REDUCED fp32, one AdamW step (B=2 x 64): loss card "
            f"{card[2]['loss']:.6f}, cpu {cpu[2]['loss']:.6f}; metrics max rel err "
            f"{metric_err:.3e}; gradients {grad_note}; updated params {param_err:.3e}; launches "
            f"(flash fwd, flash bwd, scan fwd, scan bwd) {got}, expected {want}")
        require(metric_err <= TRAIN_TOL["metrics"]["rtol"], f"{arch}: metrics differ")
        require(grad_ok, f"{arch}: gradients differ beyond tolerance")
        require(param_misfit == 0.0, f"{arch}: updated params differ by {param_misfit:.3e}")
        require(not bad, f"{arch}: zero or non-finite gradients: {bad}")
        require(got == want and sum(counts.values()) == sum(want),
                f"{arch}: launches {counts}, expected {want}")
        require_variant(variants, "flash_attention_bwd", "tf32x3", want[1],
                        f"reduced-train-families {arch}")


def _first_grads_hook(torch):
    """(hook, first): a `grads_hook` that records the first step's gradient
    tree in `first` ({"n": leaves, "bad": zero or non-finite paths})."""
    first = {}

    def hook(grads):
        if not first:
            first["n"] = len(_paths(grads))
            first["bad"] = _bad_grads(torch, grads)

    return hook, first


def _train_loop(torch, model, params, batches, *, lr: float = 1e-3):
    """AdamW steps of `model` (the launcher's schedule: warmup 20) from
    `params`, one a batch: (params, opt_state, history of {"loss",
    "grad_norm", "seconds"}, the first step's gradient check (leaves, bad
    paths)), each step timed on the host clock to its end on the device."""
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts

    ocfg = topt.OptimizerConfig(name="adamw", learning_rate=lr, warmup_steps=20,
                                decay_steps=100)
    hook, first = _first_grads_hook(torch)
    step = tts.make_train_step(model, ocfg, grads_hook=hook)
    opt_state = topt.init(ocfg, params)
    history = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, _, m = step(params, opt_state, None, batch)
        loss = float(m["loss"])
        history.append({"loss": loss, "grad_norm": float(m["grad_norm"]),
                        "seconds": time.perf_counter() - t0})
    return params, opt_state, history, first


def _traced_step(torch, model, params, batch, *, cuda_only: bool = False) -> dict:
    """One AdamW step under the profiler: `_device_breakdown` of it.
    `cuda_only` records the device's activity alone (a step of hundreds of
    thousands of launches traces faster without the host's)."""
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts

    ocfg = topt.OptimizerConfig(name="adamw", learning_rate=1e-3)
    step = tts.make_train_step(model, ocfg)
    opt_state = topt.init(ocfg, params)
    step(params, opt_state, None, batch)  # the optimizer's first-call allocations
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if not cuda_only:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = step(params, opt_state, None, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del out, opt_state
    return _device_breakdown(torch, prof, wall)


def _log_breakdown(tag: str, br: dict) -> None:
    log(f"[{tag}] one traced step: wall {br['wall_s'] * 1e3:.2f} ms, device busy "
        f"{br['busy_s'] * 1e3:.2f} ms, idle share {br['idle_share']:.3f}; device ms by group "
        + ", ".join(f"{g} {t * 1e3:.2f}" for g, t in br["by_group_s"].items())
        + "; top kernels " + "; ".join(f"{n} {t * 1e3:.2f} ms" for n, t in br["top"]))


def _check_training(tag, losses, plain_loss, first, n_leaves) -> None:
    """What every training phase requires: finite losses, every parameter's
    step-1 gradient finite and non-zero, the step-0 loss within 1e-2
    relative of the same weights' loss through the plain attention and scan."""
    require(all(math.isfinite(x) for x in losses), f"{tag}: a loss is not finite: {losses}")
    require(first.get("n") == n_leaves and not first["bad"],
            f"{tag}: parameters whose step-1 gradient is zero or not finite: {first.get('bad')}")
    require(abs(losses[0] - plain_loss) <= 1e-2 * abs(plain_loss),
            f"{tag}: step-0 loss {losses[0]} against the plain kernels' {plain_loss}")


def phase_train_xlstm(torch) -> tuple:
    """xlstm-125m at its published widths and depth (12 blocks: 9 mLSTM, 3
    sLSTM, d_model 768, 4 heads of 384, vocab 50304): fp32 masters, bf16
    compute, AdamW, B=4 x S=2048, 6 steps through the launcher. Requires
    the training checks (`_check_training`) and exactly 9 scan forward
    launches a step (`mma`) and 9 backward launches (the kernel). Then the
    sLSTM blocks' forward and backward alone on the step's shape (their share
    of a step) and one step traced on the device. Returns the 6 steps'
    launch counts and their counts by variant."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build
    from repro_torch.models import xlstm_model as xm
    from repro_torch.models.ssm import slstm_forward
    from repro_torch.train import train_step as tts
    from repro_torch.train.data import SyntheticTokenStream
    from repro_torch.train.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("xlstm-125m")
    B, S, steps = 4, 2048, 6
    model = build(cfg)
    stream = SyntheticTokenStream(cfg, ShapeConfig("train", S, B, "train"))
    batch0 = tts.batch_to(stream.next_batch(), "cuda")
    with torch.no_grad(), plain_kernels():  # the launcher's weights (seed 0)
        params = model.init(seed=0, device="cuda")
        n_params = sum(t.numel() for _, t in _paths(params))
        plain_loss = float(model.loss(params, batch0)[0])
    del params
    gc.collect()
    torch.cuda.empty_cache()

    hook, first = _first_grads_hook(torch)
    args = train_cli.parse_args(["--arch", "xlstm-125m", "--steps", str(steps), "--batch",
                                 str(B), "--seq", str(S), "--log-every", "1"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params, opt_state, history = train_cli.train(args, grads_hook=hook)
    counts = ops.launch_counts()
    variants = ops.variant_counts()
    peak = torch.cuda.max_memory_allocated() - base
    losses = [h["loss"] for h in history]
    ms = [h["seconds"] * 1e3 for h in history]
    mean_ms = sum(ms[1:]) / (steps - 1)
    m = xm.block_kinds(cfg).count("mlstm")
    log(f"[train-xlstm] xlstm-125m full width ({n_params} parameters, fp32 masters, bf16 "
        f"compute, AdamW), B={B} x S={S} = {B * S} tokens a step, {steps} steps through the "
        f"launcher: losses {[round(x, 5) for x in losses]}, grad_norm "
        f"{[round(h['grad_norm'], 4) for h in history]}")
    log(f"[train-xlstm] ms a step {[round(x, 2) for x in ms]}: steps 2-{steps} {mean_ms:.2f} ms "
        f"= {B * S / (mean_ms / 1e3):.0f} training tok/s; peak device memory above the baseline "
        f"{peak / 2**30:.2f} GiB; step-0 loss {losses[0]:.6f} against {plain_loss:.6f} through "
        f"the plain scan (ln V = {math.log(cfg.vocab_size):.4f}); launches {counts}, scan by "
        f"variant {variants['gated_linear_scan']}, its backward "
        f"{variants['gated_linear_scan_bwd']}")
    _check_training("train-xlstm", losses, plain_loss, first, len(_paths(params)))
    require(counts["gated_linear_scan"] == m * steps
            and counts["gated_linear_scan_bwd"] == m * steps
            and sum(counts.values()) == 2 * m * steps,
            f"expected {m} scan forward and {m} backward launches a step: {counts}")
    require_variant(variants, "gated_linear_scan", "mma", m * steps, "train-xlstm")
    require_variant(variants, "gated_linear_scan_bwd", "mma", m * steps, "train-xlstm")

    # the sLSTM blocks alone, forward and backward, on the step's shape
    batch = tts.batch_to(stream._batch_for(steps), "cuda")
    kinds = xm.block_kinds(cfg)
    blocks = [p for p, kind in zip(params["blocks"], kinds) if kind == "slstm"]
    live = [[t.detach().requires_grad_() for t in tree_leaves(p)] for p in blocks]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    x.requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = x
    for p, leaves in zip(blocks, live):
        h, _ = slstm_forward(cfg, dict(zip(p.keys(), leaves)), h)
    torch.autograd.grad(h.float().square().mean(), [x] + [t for ls in live for t in ls])
    torch.cuda.synchronize()
    slstm_ms = (time.perf_counter() - t0) * 1e3
    log(f"[train-xlstm] the {len(blocks)} sLSTM blocks' forward and backward alone (B={B} x "
        f"S={S}, a position at a time): {slstm_ms:.2f} ms, {slstm_ms / mean_ms:.3f} of a step")
    del live, x, h
    br = _traced_step(torch, model, params, batch, cuda_only=True)
    _log_breakdown("train-xlstm", br)
    bwd_s = br["by_group_s"]["scan backward"]
    log(f"[train-xlstm] the scan backward's share of the traced step's device time: "
        f"{bwd_s * 1e3:.2f} of {br['busy_s'] * 1e3:.2f} ms ({bwd_s / br['busy_s']:.4f}), {m} calls")
    del params, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    return counts, variants


#: zamba2-7b's depth cut for one card: two groups of 6 Mamba2 layers (the
#: shared block after each) and one tail layer, at the published widths
ZAMBA2_TRAIN_LAYERS = 13


def phase_train_zamba2(torch) -> tuple:
    """zamba2-7b at its published widths (d_model 3584, 32 heads of 112,
    Mamba2 state 64, vocab 32000), depth cut to `ZAMBA2_TRAIN_LAYERS`
    (`cfg.replace(num_layers=13)`): fp32 masters, bf16 compute, AdamW, B=2 x
    S=1024, 4 steps. Requires the training checks and the launches
    `expected_train_launches` names (the groups rematerialised: their scan
    and flash forwards run twice), flash's forward and backward on `simt`
    (hd 112), the scan's forward on `mma`. Prints the parameter count and
    the bytes, and the flash kernels' share of a traced step."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.model_zoo import param_count
    from repro_torch.train import train_step as tts
    from repro_torch.train.data import SyntheticTokenStream

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("zamba2-7b").replace(num_layers=ZAMBA2_TRAIN_LAYERS)
    B, S, steps = 2, 1024, 4
    model = build(cfg)
    stream = SyntheticTokenStream(cfg, ShapeConfig("train", S, B, "train"))
    batches = [tts.batch_to(stream.next_batch(), "cuda") for _ in range(steps + 1)]
    with torch.no_grad():
        params = model.init(seed=0, device="cuda")
        with plain_kernels():
            plain_loss = float(model.loss(params, batches[0])[0])
    n_params = param_count(params)
    n_bytes = sum(t.nbytes for _, t in _paths(params))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params, opt_state, history, first = _train_loop(torch, model, params, batches[:steps])
    counts = ops.launch_counts()
    variants = ops.variant_counts()
    peak = torch.cuda.max_memory_allocated() - base
    losses = [h["loss"] for h in history]
    ms = [h["seconds"] * 1e3 for h in history]
    mean_ms = sum(ms[1:]) / (steps - 1)
    log(f"[train-zamba2] zamba2-7b at its published widths, {cfg.num_layers} of 81 layers "
        f"({n_params} parameters, {n_bytes / 2**30:.2f} GiB of fp32 masters; bf16 compute, "
        f"AdamW), B={B} x S={S}, {steps} steps: losses {[round(x, 5) for x in losses]}; ms a "
        f"step {[round(x, 2) for x in ms]}: steps 2-{steps} {mean_ms:.2f} ms = "
        f"{B * S / (mean_ms / 1e3):.0f} training tok/s; peak above the baseline "
        f"{peak / 2**30:.2f} GiB; step-0 loss {losses[0]:.6f} against {plain_loss:.6f} through "
        f"the plain attention and scan; launches {counts}, by variant "
        f"{ {k: v for k, v in variants.items() if sum(v.values())} }")
    _check_training("train-zamba2", losses, plain_loss, first, len(_paths(params)))
    fwd, bwd, sfwd, sbwd = expected_train_launches(cfg)
    require(counts["flash_attention"] == fwd * steps
            and counts["flash_attention_bwd"] == bwd * steps
            and counts["gated_linear_scan"] == sfwd * steps
            and counts["gated_linear_scan_bwd"] == sbwd * steps
            and sum(counts.values()) == (fwd + bwd + sfwd + sbwd) * steps,
            f"launches {counts}, expected {(fwd, bwd, sfwd, sbwd)} a step")
    require_variant(variants, "flash_attention", "wgmma", fwd * steps, "train-zamba2")
    require_variant(variants, "flash_attention_bwd", "wgmma", bwd * steps, "train-zamba2")
    require_variant(variants, "gated_linear_scan", "mma", sfwd * steps, "train-zamba2")
    require_variant(variants, "gated_linear_scan_bwd", "mma", sbwd * steps, "train-zamba2")
    br = _traced_step(torch, model, params, batches[steps])
    _log_breakdown("train-zamba2", br)
    flash_s = br["by_group_s"]["flash forward"] + br["by_group_s"]["flash backward"]
    log(f"[train-zamba2] the shared attention's flash wgmma forward and backward: "
        f"{flash_s * 1e3:.2f} of {br['busy_s'] * 1e3:.2f} ms of the traced step's device time "
        f"({flash_s / br['busy_s']:.4f}); the scan backward "
        f"{br['by_group_s']['scan backward'] * 1e3:.2f} ms ({sbwd} calls)")
    del params, opt_state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return counts, variants


#: the bundles' training shapes: B=2; paligemma 256 patch embeddings + 256
#: text tokens, whisper 1500 frames + 448 text tokens (its decoder's context)
BUNDLE_TRAIN = {"paligemma-3b": 512, "whisper-small": 448}


def phase_train_bundles(torch) -> dict:
    """paligemma-3b and whisper-small at full width (fp32 masters, bf16
    compute, AdamW), B=2, 3 steps on `make_batch` batches (patches; frames
    x 0.02) through `make_train_step`: the training checks and the launches
    `expected_train_launches` names, every flash forward and backward on
    `wgmma` (hd 256 with 8 query heads a KV head; hd 64). Returns the launch
    counts by config."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.model_zoo import param_count

    out = {}
    steps = 3
    for arch, seq in BUNDLE_TRAIN.items():
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        model = build(cfg)
        gen = torch.Generator(device="cuda").manual_seed(11)
        batches = [model.make_batch(gen, ShapeConfig("train", seq, 2, "train"))
                   for _ in range(steps)]
        with torch.no_grad():
            params = model.init(seed=0, device="cuda")
            with plain_kernels():
                plain_loss = float(model.loss(params, batches[0])[0])
        n_params = param_count(params)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        params, opt_state, history, first = _train_loop(torch, model, params, batches)
        counts = ops.launch_counts()
        variants = ops.variant_counts()
        peak = torch.cuda.max_memory_allocated() - base
        losses = [h["loss"] for h in history]
        ms = [h["seconds"] * 1e3 for h in history]
        tokens = 2 * batches[0]["tokens"].shape[1]
        mean_ms = sum(ms[1:]) / (steps - 1)
        log(f"[train-bundles] {arch} full width ({n_params} parameters), B=2 x {seq} "
            f"({tokens} text tokens a step), {steps} steps: losses "
            f"{[round(x, 5) for x in losses]}; ms a step {[round(x, 2) for x in ms]} (steps "
            f"2-{steps} {mean_ms:.2f} ms, {tokens / (mean_ms / 1e3):.0f} text tok/s); peak "
            f"above the baseline {peak / 2**30:.2f} GiB; step-0 loss {losses[0]:.6f} against "
            f"{plain_loss:.6f} through the plain attention; launches {counts}, flash by variant "
            f"{variants['flash_attention']}, backward {variants['flash_attention_bwd']}")
        _check_training(f"train-bundles {arch}", losses, plain_loss, first, len(_paths(params)))
        fwd, bwd, _, _ = expected_train_launches(cfg)
        require(counts["flash_attention"] == fwd * steps
                and counts["flash_attention_bwd"] == bwd * steps
                and sum(counts.values()) == (fwd + bwd) * steps,
                f"{arch}: launches {counts}, expected {fwd} forward and {bwd} backward a step")
        require_variant(variants, "flash_attention", "wgmma", fwd * steps, arch)
        require_variant(variants, "flash_attention_bwd", "wgmma", bwd * steps, arch)
        out[f"train-{arch}"] = counts
        del params, opt_state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# 36-37. multi-device: the SPMD backend, and training through its mesh
# ---------------------------------------------------------------------------

#: the `train` phase's losses and ms a step, for `train-spmd` to compare with
TRAIN_RECORD: dict = {}


def phase_spmd(torch) -> None:
    """An NCCL world of one from the environment (127.0.0.1, a free port; a
    failed init fails the phase, no gloo or CPU fallback) and a (1, 1)
    ("data", "model") mesh on the card: each collective of the `spmd`
    communication manager returns what world size 1 implies, exactly;
    `reshard` goes Replicate -> Shard -> Replicate on card tensors and its
    fence resolves; `mesh_from_topology` over `torchdev`'s discovered
    topology gives the same mesh; the instance manager sees one root."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.backends.spmd import SpmdCommunicationManager, SpmdInstanceManager
    from repro_torch.backends.torchdev import TorchTopologyManager
    from repro_torch.launch.mesh import make_mesh, mesh_from_topology
    from repro_torch.launch.train import init_world

    rank, world, dev = init_world("cuda")
    require(dist.get_backend() == "nccl" and (rank, world) == (0, 1) and dev.type == "cuda",
            f"spmd: expected rank 0 of an NCCL world of 1 on the card, got {dist.get_backend()} "
            f"rank {rank} of {world} on {dev}")
    mesh = make_mesh((1, 1), ("data", "model"))
    require(mesh.device_type == "cuda", f"spmd: mesh on {mesh.device_type}")
    cm = SpmdCommunicationManager(mesh)
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn((8, 12), generator=gen, device="cuda")
    got = {
        "all_reduce": cm.all_reduce(x, "data"),
        "all_gather": cm.all_gather(x, "model", axis=1),
        "reduce_scatter": cm.reduce_scatter(x, "data", scatter_dimension=1),
        "all_to_all": cm.all_to_all(x, "model", split_axis=0, concat_axis=1),
        "ppermute_halo": cm.ppermute_halo(x, "data", shift=1),
    }
    torch.cuda.synchronize()
    for name, y in got.items():
        require(y.is_cuda and torch.equal(y, x), f"spmd: {name} at world size 1 is not the input")
    d = cm.reshard(x, [Replicate(), Replicate()], tag=7)
    d = cm.reshard(d, [Shard(0), Replicate()], tag=7)
    d = cm.reshard(d, [Replicate(), Replicate()], tag=7)
    cm.fence(7)
    require(isinstance(d, DTensor) and d.placements == (Replicate(), Replicate())
            and d.to_local().is_cuda and torch.equal(d.to_local(), x),
            "spmd: reshard Replicate -> Shard -> Replicate did not give the tensor back")
    topo_mesh = mesh_from_topology(TorchTopologyManager("cuda").query_topology(),
                                   model_parallelism=1)
    require(tuple(topo_mesh.mesh.shape) == (1, 1)
            and topo_mesh.mesh_dim_names == mesh.mesh_dim_names
            and topo_mesh.device_type == "cuda",
            f"spmd: mesh_from_topology gave {topo_mesh}")
    im = SpmdInstanceManager()
    require(len(im.get_instances()) == 1 and im.get_current_instance().is_root,
            "spmd: the instance manager does not see one root instance")
    log(f"[spmd] NCCL world of 1, mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} on "
        f"cuda: all_reduce, all_gather, reduce_scatter, all_to_all, ppermute_halo equal their "
        f"input; reshard Replicate -> Shard(0) -> Replicate fenced; mesh_from_topology(torchdev) "
        f"= {tuple(topo_mesh.mesh.shape)}")


def phase_train_spmd(torch, card: str) -> tuple:
    """gemma3-1b at full width, B=4 x 1024, 3 steps through the launcher's
    SPMD route (`--mesh 1x1`: topology -> mesh -> spmd compute manager,
    parameters, AdamW state and batches placed by the sharding plan as
    DTensors; the kernels reached through `local_map`). Requires the step
    losses within 1e-3 relative of the `train` phase's (the same seed and
    steps), finite gradients on every parameter, and the flash forward and
    backward launches of `train` a step, all on wgmma. Prints ms a step
    beside `train`'s (DTensor's dispatch cost), with the card's name and
    power limit. Returns the run's launch counts and counts by variant."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma3-1b")
    B, S, steps = 4, 1024, 3
    hook, first = _first_grads_hook(torch)
    args = train_cli.parse_args(["--arch", "gemma3-1b", "--steps", str(steps), "--batch", str(B),
                                 "--seq", str(S), "--log-every", "1", "--mesh", "1x1"])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    params, opt_state, history = train_cli.train(args, grads_hook=hook)
    counts = ops.launch_counts()
    variants = ops.variant_counts()
    require(all(hasattr(t, "placements") for _, t in _paths(params)),
            "train-spmd: the launcher's parameters are not DTensors")
    losses = [h["loss"] for h in history]
    ms = [h["seconds"] * 1e3 for h in history]
    mean_ms = sum(ms[1:]) / len(ms[1:])
    want = TRAIN_RECORD["losses"][:steps]
    log(f"[train-spmd] gemma3-1b full width through the launcher's SPMD route, mesh "
        f"{{'data': 1, 'model': 1}} over NCCL, B={B} x S={S}, {steps} steps: losses "
        f"{[round(x, 5) for x in losses]} against train's {[round(x, 5) for x in want]}")
    log(f"[train-spmd] ms a step {[round(x, 2) for x in ms]}: steps 2-{steps} {mean_ms:.2f} ms "
        f"against train's {TRAIN_RECORD['mean_ms']:.2f} ms (steps 2-6; the difference is "
        f"DTensor's dispatch), {B * S / (mean_ms / 1e3):.0f} training tok/s, on {card}; "
        f"launches {counts}, flash by variant {variants['flash_attention']}, its backward by "
        f"variant {variants['flash_attention_bwd']}")
    require(all(math.isfinite(x) for x in losses), f"train-spmd: a loss is not finite: {losses}")
    require(first.get("n") == len(_paths(params)) and not first["bad"],
            f"train-spmd: parameters whose step-1 gradient is zero or not finite: "
            f"{first.get('bad')}")
    for got, ref in zip(losses, want):
        require(abs(got - ref) <= 1e-3 * abs(ref),
                f"train-spmd: losses {losses} against train's {want} (1e-3 relative)")
    fwd, bwd, _, _ = expected_train_launches(cfg)
    require(counts["flash_attention"] == fwd * steps
            and counts["flash_attention_bwd"] == bwd * steps
            and sum(counts.values()) == (fwd + bwd) * steps,
            f"train-spmd: expected {fwd} flash forward and {bwd} backward launches a step: "
            f"{counts}")
    require_variant(variants, "flash_attention", "wgmma", fwd * steps, "train-spmd")
    require_variant(variants, "flash_attention_bwd", "wgmma", bwd * steps, "train-spmd")
    del params, opt_state
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return counts, variants


# ---------------------------------------------------------------------------
# 38-40. the examples: Test Case 2, the channel serve demo and the 100M
# training driver through their own entry points
# ---------------------------------------------------------------------------


def _example(name: str):
    """`examples/<name>.py` as a module (the examples are scripts, not a
    package; importing one runs nothing)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "examples",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def phase_example_hetero(torch) -> dict:
    """`examples/heterogeneous_inference_torch.py`'s three rows on the card
    through its own `run`: Test Case 2's checks (phase tc2's), with
    `fused_linear` launched twice a batch of its row, on `simt`, and by no
    other row. Returns the run's launch counts."""
    from repro_torch.kernels import ops

    ex = _example("heterogeneous_inference_torch")
    n_test, batch = 2000, 256
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows = ex.run("cuda", n_test=n_test)
    wall = time.perf_counter() - t0
    counts, variants = ops.launch_counts(), ops.variant_counts()
    for dev, backend, r in rows:
        log(f"[example-hetero] {dev:<10} {backend:<13} accuracy {r.accuracy:.4f}, img-0 class "
            f"{r.img0_class}, score {r.img0_score:.9f}")
    accs = {r.accuracy for _, _, r in rows}
    scores = [r.img0_score for _, _, r in rows]
    n_launch = 2 * -(-n_test // batch)
    log(f"[example-hetero] three rows in {wall:.3f}s; launches {counts}, fused_linear by variant "
        f"{variants['fused_linear']}")
    require([(d, b) for d, b, _ in rows] == [("host-cpu", "numpy"), ("cuda", "torch"),
                                             ("cuda", "fused_linear")],
            f"example-hetero rows {[(d, b) for d, b, _ in rows]}")
    require(len(accs) == 1 and min(accs) > 0.85, f"Test Case 2 accuracies {accs}")
    require(len({r.img0_class for _, _, r in rows}) == 1, "img-0 class differs across rows")
    require(max(scores) - min(scores) < 1e-4, f"img-0 scores spread {max(scores) - min(scores)}")
    require(counts["fused_linear"] == n_launch and sum(counts.values()) == n_launch,
            f"example-hetero launches {counts}, expected fused_linear {n_launch} and nothing else")
    require_variant(variants, "fused_linear", "simt_small", n_launch, "example-hetero")
    return counts


def phase_example_serve_demo(torch) -> dict:
    """`examples/serve_demo_torch.py`'s two acts through its own functions:
    at REDUCED fp32 (TF32 off) on the card, every request's streamed tokens
    equal the same functions' on the CPU; then at full-width gemma3-1b (26
    layers, bf16, seeded) every request completes with its requested count
    of tokens, and the launches are exact: a flash prefill a request and a
    decode a tick, each a layer, flash on `wgmma` and decode on `mma`.
    Returns each act's launch counts at full width."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.common import dtype_of

    ex = _example("serve_demo_torch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("gemma3-1b", reduced=True)
    model = build(cfg)
    params_cpu = model.init(seed=0, device="cpu")
    params_card = _to_device(params_cpu, "cuda")
    acts = {}
    for device, params in (("cuda", params_card), ("cpu", params_cpu)):
        ops.reset_launch_counts()
        _, replies = ex.serve_channels(model, params, device)
        fleet = ex.serve_fleet(model, params, device)
        require_fp32_flash("example-serve-demo REDUCED")
        acts[device] = ({rid: toks for rid, (toks, _) in replies.items()},
                        {rid: r["tokens"] for rid, r in fleet.results.items()})
    for i, act in enumerate(("act 1 (channel server)", "act 2 (fleet)")):
        card, host = acts["cuda"][i], acts["cpu"][i]
        log(f"[example-serve-demo] REDUCED fp32 {act}: {len(card)} requests, tokens on the card "
            f"equal the CPU's: {card == host}")
        require(card == host and len(card) == 6,
                f"example-serve-demo REDUCED {act}: card {card} cpu {host}")
    del params_card

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma3-1b")
    model = build(cfg)
    L = cfg.num_layers
    params = model.init(seed=0, device="cuda", dtype=dtype_of(cfg.compute_dtype))
    torch.cuda.synchronize()
    bodies = [b for rank in range(1, 1 + ex.N_CLIENTS)
              for b in ex.client_requests(cfg.vocab_size, rank)]
    steps = {b["id"]: b["steps"] for b in bodies}
    steps.update({r.rid: r.max_new_tokens for r in ex.fleet_requests(cfg.vocab_size)})
    counts = {}

    def check(act, got, ticks, counts_, variants, wall):
        n_tok = sum(len(t) for t in got.values())
        log(f"[example-serve-demo] gemma3-1b full width {act}: {len(got)} requests, {n_tok} "
            f"tokens in {wall:.3f}s, {ticks} decode ticks; launches {counts_}")
        require(len(got) == 6 and all(len(t) == steps[rid] for rid, t in got.items()),
                f"{act}: tokens {got}")
        require(all(bool(np.all((np.asarray(t) >= 0) & (np.asarray(t) < cfg.vocab_size)))
                    for t in got.values()), f"{act}: a token out of range")
        want = {name: 0 for name in counts_}
        want.update(flash_attention=len(got) * L, decode_attention=ticks * L)
        require(counts_ == want, f"{act}: launches {counts_}, expected {want}")
        require_variant(variants, "flash_attention", "wgmma", want["flash_attention"], act)
        require_variant(variants, "decode_attention", "mma", want["decode_attention"], act)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    server, replies = ex.serve_channels(model, params, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["example-serve-demo act 1"] = ops.launch_counts()
    check("act 1 (channel server)", {rid: t for rid, (t, _) in replies.items()},
          server["ticks"], counts["example-serve-demo act 1"], ops.variant_counts(), wall)
    with _worker_schedulers() as made:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fleet = ex.serve_fleet(model, params, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts["example-serve-demo act 2"] = ops.launch_counts()
        variants = ops.variant_counts()
        ticks = sum(sched.ticks for sched in made)
    require(fleet.stats["worker_errors"] == {} and len(made) == ex.N_WORKERS,
            f"act 2: worker errors {fleet.stats['worker_errors']}, {len(made)} workers")
    log(f"[example-serve-demo] act 2: per-worker settled {fleet.stats['per_worker_settled']}, "
        f"{len(fleet.chunks)} merged chunks")
    check("act 2 (fleet)", {rid: r["tokens"] for rid, r in fleet.results.items()}, ticks,
          counts["example-serve-demo act 2"], variants, wall)
    del params, made
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_example_train_100m(torch, card: str) -> dict:
    """`examples/train_100m_torch.py` at its own widths (10 layers, d_model
    640, 8 query heads over 2 at hd 80, vocab 50304, fp32) and CLI defaults
    (30 steps, B=4 x 256, a checkpoint at 25) through its own `train`: the
    SPMD compute manager over an NCCL world of one that the run starts and
    destroys. Losses finite and falling; exactly `expected_train_launches`
    flash forward (`simt`) and backward (`tf32x3`) launches a step; ms a step,
    training tok/s, peak memory. Then a second run of 30 steps on the same
    directory resumes at 25, and its step-30 loss equals the first run's
    within 1e-5 relative (bit equality reported); one more step is traced
    (device busy time, idle share, top kernels). Returns both runs' launch
    counts."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.backends import torchdev
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.model_zoo import param_count
    from repro_torch.train.data import SyntheticTokenStream

    ex = _example("train_100m_torch")
    cfg = ex.model_config()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        args = ex.parse_args(["--ckpt-dir", ckpt_dir])
        device = torchdev.resolve_device(args.device)
        run_kw = dict(steps=args.steps, batch=args.batch, seq=args.seq, ckpt_dir=ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      out=lambda line: log(f"[example-train-100m] {line}"))
        gc.collect()
        torch.cuda.empty_cache()
        params = build(cfg).init(seed=0, device=device)
        n_params = param_count(params)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        first = ex.train(cfg, params, device, **run_kw)
        counts, variants = ops.launch_counts(), ops.variant_counts()
        peak = torch.cuda.max_memory_allocated() - base
        del params, first.params, first.opt_state
        require(not dist.is_initialized(), "the example left its process group behind")
        params = build(cfg).init(seed=0, device=device)
        ops.reset_launch_counts()
        resumed = ex.train(cfg, params, device, **run_kw)
        resume_counts, resume_variants = ops.launch_counts(), ops.variant_counts()
        # one more step under the profiler: the device's busy and idle time
        stream = SyntheticTokenStream(cfg, ShapeConfig("train100m", args.seq, args.batch,
                                                       "train"))
        br = _traced_step(torch, build(cfg), resumed.params, stream._batch_for(args.steps))
        del params, resumed.params, resumed.opt_state
    losses = [h["loss"] for h in first.history]
    ms = [h["seconds"] * 1e3 for h in first.history]
    mean_ms = sum(ms[1:]) / len(ms[1:])
    B, S, steps = args.batch, args.seq, args.steps
    log(f"[example-train-100m] {n_params / 1e6:.1f}M parameters ({cfg.num_layers}L "
        f"d={cfg.d_model} H={cfg.num_heads} KV={cfg.num_kv_heads} hd={cfg.head_dim} "
        f"V={cfg.vocab_size}, fp32), B={B} x S={S}, {steps} steps: losses "
        f"{[round(x, 5) for x in losses]}")
    log(f"[example-train-100m] ms a step {[round(x, 2) for x in ms]}: steps 2-{steps} "
        f"{mean_ms:.2f} ms = {B * S / (mean_ms / 1e3):.0f} training tok/s (step 1 "
        f"{ms[0]:.2f} ms); peak device memory above the baseline {peak / 2**30:.3f} GiB; on "
        f"{card}; launches {counts}, flash by variant {variants['flash_attention']}, backward "
        f"{variants['flash_attention_bwd']}")
    want_steps = list(range(1, steps + 1))
    require([h["step"] for h in first.history] == want_steps and first.start_step == 0,
            f"example-train-100m ran steps {[h['step'] for h in first.history]}")
    require(all(math.isfinite(x) for x in losses), f"a loss is not finite: {losses}")
    require(sum(losses[-5:]) < sum(losses[:5]) and losses[-1] < losses[0],
            f"the losses did not fall: {losses}")
    fwd, bwd, _, _ = expected_train_launches(cfg)
    for tag, got, kinds, n in (("run", counts, variants, steps),
                               ("resume", resume_counts, resume_variants,
                                steps - resumed.start_step)):
        require(got["flash_attention"] == fwd * n and got["flash_attention_bwd"] == bwd * n
                and sum(got.values()) == (fwd + bwd) * n,
                f"example-train-100m {tag}: {got}, expected {fwd} forward and {bwd} backward "
                f"flash launches a step")
        require_variant(kinds, "flash_attention", "tf32x3", fwd * n,
                        f"example-train-100m {tag}")
        require_variant(kinds, "flash_attention_bwd", "tf32x3", bwd * n,
                        f"example-train-100m {tag}")
    last, again = first.history[-1]["loss"], resumed.history[-1]["loss"]
    log(f"[example-train-100m] resumed at step {resumed.start_step}: steps "
        f"{[h['step'] for h in resumed.history]}, losses "
        f"{[h['loss'] for h in resumed.history]} against "
        f"{[h['loss'] for h in first.history[resumed.start_step:]]}; step-{steps} loss "
        f"{again!r} against {last!r}: relative difference {abs(again - last) / abs(last):.3e}, "
        f"bit-equal {again == last}; launches {resume_counts}")
    _log_breakdown("example-train-100m", br)
    require(resumed.start_step == args.ckpt_every
            and [h["step"] for h in resumed.history] == want_steps[args.ckpt_every:],
            f"the second run resumed at {resumed.start_step}")
    require(abs(again - last) <= 1e-5 * abs(last),
            f"the resumed step-{steps} loss {again} differs from {last} beyond 1e-5 relative")
    gc.collect()
    torch.cuda.empty_cache()
    return {"example-train-100m": counts, "example-train-100m resume": resume_counts}


def _load_spec() -> None:
    """The bound constants from the port's one source of them
    (`backends/gpu_spec.py`, NVIDIA's H100 SXM5 datasheet)."""
    from repro_torch.backends import gpu_spec

    global PEAK_BYTES_PER_S, PEAK_FLOPS, L2_BYTES
    PEAK_BYTES_PER_S = gpu_spec.H100.hbm_bandwidth
    PEAK_FLOPS = dict(gpu_spec.PEAK_FLOPS)
    L2_BYTES = gpu_spec.L2_BYTES


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port (src/repro_torch) is not importable: {e}", file=sys.stderr)
        return 2
    try:
        _load_spec()
        t_start = time.perf_counter()
        card = phase_device(torch)
        run_phase("build", phase_build)
        kernels = run_phase("kernels", phase_kernels, torch)
        run_phase("reduced", phase_reduced, torch)
        paged_counts, paged_tokens, paged_tok_s = run_phase("serve", phase_serve, torch, "paged")
        run_phase("reduced-dense", phase_reduced_dense, torch)
        dense_counts, dense_tokens, _ = run_phase("serve-dense", phase_serve, torch, "dense")
        agree = sum(sum(a == b for a, b in zip(dense_tokens[rid], paged_tokens[rid]))
                    for rid in paged_tokens)
        total = sum(len(t) for t in paged_tokens.values())
        log(f"[serve-dense] tokens equal to the paged run's at the same position: {agree} of "
            f"{total} ({agree / total:.3f}; bf16 sums in another order may flip a greedy "
            f"pick, so reported, not required)")
        serial_counts = run_phase("serial", phase_serial, torch)
        tc2_counts = run_phase("tc2", phase_tc2, torch)
        run_phase("reduced-xlstm", phase_reduced_xlstm, torch)
        xlstm_counts = run_phase("serve-xlstm", phase_serve_xlstm, torch)
        loss_counts = run_phase("loss-xlstm", phase_loss_xlstm, torch)
        run_phase("reduced-prefix", phase_reduced_prefix, torch)
        prefix_counts = run_phase("serve-prefix", phase_serve_prefix, torch)
        run_phase("reduced-zamba2", phase_reduced_zamba2, torch)
        zamba2_counts, zamba2_serial_counts = run_phase("serve-zamba2", phase_serve_zamba2, torch)
        run_phase("reduced-dense-family", phase_reduced_dense_family, torch)
        family_counts = run_phase("serve-dense-family", phase_serve_dense_family, torch)
        run_phase("conformance", phase_conformance, torch)
        run_phase("reduced-fleet", phase_reduced_fleet, torch)
        fleet_counts = run_phase("serve-fleet", phase_serve_fleet, torch, paged_tokens,
                                 paged_tok_s)
        run_phase("apps", phase_apps)
        run_phase("reduced-moe", phase_reduced_moe, torch)
        moe_counts = run_phase("serve-moe", phase_serve_moe, torch)
        run_phase("reduced-vlm", phase_reduced_vlm, torch)
        paligemma_counts = run_phase("generate-paligemma", phase_generate_bundle, torch,
                                     "paligemma-3b")
        run_phase("reduced-whisper", phase_reduced_whisper, torch)
        whisper_counts = run_phase("generate-whisper", phase_generate_bundle, torch,
                                   "whisper-small")
        run_phase("reduced-train", phase_reduced_train, torch)
        train_counts, train_variants = run_phase("train", phase_train, torch)
        run_phase("train-resume", phase_train_resume, torch)
        run_phase("reduced-train-families", phase_reduced_train_families, torch)
        xlstm_train_counts, xlstm_train_variants = run_phase("train-xlstm", phase_train_xlstm,
                                                             torch)
        zamba2_train_counts, zamba2_train_variants = run_phase("train-zamba2",
                                                               phase_train_zamba2, torch)
        bundle_train_counts = run_phase("train-bundles", phase_train_bundles, torch)
        run_phase("spmd", phase_spmd, torch)
        spmd_train_counts, _ = run_phase("train-spmd", phase_train_spmd, torch, card)
        hetero_counts = run_phase("example-hetero", phase_example_hetero, torch)
        demo_counts = run_phase("example-serve-demo", phase_example_serve_demo, torch)
        train_100m_counts = run_phase("example-train-100m", phase_example_train_100m, torch,
                                      card)
        log(f"[time] all phases: {time.perf_counter() - t_start:.1f}s")
    except Exception as e:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # each kernel's launches on every full-width path, each path's counts
    # zeroed just before it and read just after; `launches` is their sum
    path_counts = {"serve": paged_counts, "serve-dense": dense_counts, "serial": serial_counts,
                   "tc2": tc2_counts, "serve-xlstm": xlstm_counts, "loss-xlstm": loss_counts,
                   "serve-prefix": prefix_counts, "serve-zamba2": zamba2_counts,
                   "serve-zamba2 serial": zamba2_serial_counts, **family_counts,
                   "serve-fleet": fleet_counts, **moe_counts,
                   "generate-paligemma": paligemma_counts, "generate-whisper": whisper_counts,
                   "train": train_counts, "train-xlstm": xlstm_train_counts,
                   "train-zamba2": zamba2_train_counts, **bundle_train_counts,
                   "train-spmd": spmd_train_counts, "example-hetero": hetero_counts,
                   **demo_counts, **train_100m_counts}
    for k in kernels:
        k["launches_by_path"] = {path: c[k["name"]] for path, c in path_counts.items()
                                 if c[k["name"]]}
        k["launches"] = sum(k["launches_by_path"].values())
        if k["name"] == "flash_attention_bwd":  # the gemma3 train path's launches by variant
            k["launches_by_variant"] = train_variants["flash_attention_bwd"]
        if k["name"] == "gated_linear_scan_bwd":  # train-xlstm's and train-zamba2's
            k["launches_by_variant"] = {
                kind: xlstm_train_variants["gated_linear_scan_bwd"][kind]
                + zamba2_train_variants["gated_linear_scan_bwd"][kind]
                for kind in xlstm_train_variants["gated_linear_scan_bwd"]}
        log(f"[kernels] {k['name']}: {k['device_ms']:.4f} ms device, {k['tflops']:.3f} TFLOP/s "
            f"at {k['timed_shape']}; library device ms {k['library_device_ms']}; "
            f"{k['launches']} launches on the paths, by path {k['launches_by_path']}")
    forbidden = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "repro" or m.startswith("repro.")]
    if forbidden:
        print(f"chip_smoke: imported {forbidden[:5]}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
