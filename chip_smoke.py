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
paged scheduler, and full-width gemma3-1b through the router/worker serving
fleet -- and fails (non-zero exit) if any phase fails. It imports
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
   kernels with variants (flash_attention: wgmma / simt; fused_linear:
   wgmma / simt_tiled / simt) must take the tensor-core variant at every
   bf16 shape it covers, the timed ones included; the two decode kernels
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
   shapes: flash's simt kernel at head_dim 112 (and 160, G=4) and the decode
   core's simt walk at 32 heads of 112, both beside SDPA, the scan at
   Mamba2's tick and ragged prefill with the operands laid out as
   `mamba_forward` makes them; the paged kernel with window 512 through the
   full table (the prefix cache's local layers); the dense family's shapes:
   flash at granite-20b's prefill (48 query heads over 1, hd 128: simt),
   minitron-8b's (32 over 8: wgmma) and stablelm-12b's (hd 160: simt), the
   decode core's simt walk at stablelm-12b's tick (hd 160) and the paged
   kernel at granite-20b's tick (six head groups: mma), each held against
   its plain version and timed warm and with its inputs cold in L2 (flash
   and the dense decode beside SDPA);
4. reduced: REDUCED gemma3-1b in fp32 (TF32 off): prefill plus 16
   teacher-forced paged decode ticks on the card against the same functions
   on the CPU;
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
   twice per batch, every launch on the fp32 `simt` variant;
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
   the serial engine (8 x 512, 32 steps): flash and the decode kernel on
   their simt variants (hd 112) once per group, the scan once per layer
   (prefills `mma`, ticks `step`), peak memory;
17. reduced-dense-family: granite-20b, minitron-8b and stablelm-12b REDUCED
   in fp32 on the card against the CPU: prefill plus 16 teacher-forced
   dense ticks (within 1e-4), a paged serve and a serial `generate` (equal
   tokens, every page back);
18. serve-dense-family: each of the three at full width (bf16, seeded,
   depth not cut; granite 20.3 G parameters) serves phase 5's 16 requests
   on 8 slots through the paged scheduler, stablelm also the serial engine
   on 4 of them; tok/s, TTFT, peak memory; flash and the decode kernels on
   the variants their rules name (granite: flash simt at 48 query heads a
   KV head, paged mma in 6 head groups; minitron: wgmma and mma; stablelm:
   simt at hd 160 for both); each config's weights freed before the next;
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
   kill-and-respawn on one worker must not raise the card's peak memory by
   a pool;
22. apps: the paper's Test Cases 3 and 4 (Fibonacci, Jacobi local and over
   2 localsim instances) on the machine's host against their oracles.

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
# each input type's arithmetic (bf16 on the tensor cores, fp32 on CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2**20  # H100 L2 cache: inputs cycled past twice this are read cold
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


def _max_err_and_ok(torch, got, want, tol) -> tuple:
    got32, want32 = got.float(), want.float()
    diff = (got32 - want32).abs()
    ok = bool(torch.all(diff <= tol["atol"] + tol["rtol"] * want32.abs()).item())
    ok = ok and bool(torch.isfinite(got32).all().item())
    return float(diff.max().item()), ok


def _flash_case(torch, gen, *, Sq, Skv, H, KV, hd, dtype, B=1, causal=True, window=0,
                prefix_len=0, q_offset=0):
    from repro_torch.kernels import flash_attention, ref

    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KV, hd), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len, q_offset=q_offset)
    got = flash_attention.flash_attention(q, k, v, **kw)
    want = ref.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    return (q, k, v, kw), got, want


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
    # head dims between the tensor-core ones, on the simt kernel: zamba2-7b's
    # shared block (32 heads over 32, head_dim 112) at its prefill shape and
    # ragged; stablelm-12b's head_dim 160 with 4 query heads a KV head
    cases += [
        dict(Sq=1024, Skv=1024, H=32, KV=32, hd=112, dtype=torch.bfloat16),
        dict(Sq=777, Skv=777, H=32, KV=32, hd=112, dtype=torch.float32),
        dict(B=2, Sq=77, Skv=77, H=32, KV=32, hd=112, dtype=torch.bfloat16),
        dict(Sq=1024, Skv=1024, H=32, KV=8, hd=160, dtype=torch.bfloat16),
        dict(Sq=300, Skv=300, H=8, KV=2, hd=160, dtype=torch.float32, window=64),
    ]
    # the dense family's prefills: granite-20b's 48 query heads over 1 KV head
    # (hd 128, a group the wgmma variant's 64 rows do not divide: simt),
    # minitron-8b's 32 over 8 (hd 128, wgmma), stablelm-12b's 32 over 8 at hd
    # 160 (simt), at a full prompt and ragged
    cases += [
        dict(Sq=1024, Skv=1024, H=48, KV=1, hd=128, dtype=torch.bfloat16),
        dict(Sq=300, Skv=300, H=48, KV=1, hd=128, dtype=torch.float32),
        dict(B=2, Sq=77, Skv=77, H=48, KV=1, hd=128, dtype=torch.bfloat16),
        dict(Sq=1024, Skv=1024, H=32, KV=8, hd=128, dtype=torch.bfloat16),
        dict(Sq=777, Skv=777, H=32, KV=8, hd=128, dtype=torch.bfloat16),
        dict(Sq=777, Skv=777, H=32, KV=8, hd=160, dtype=torch.bfloat16),
    ]
    # the serial engine's prefill, 8 prompts of 512 tokens: a grid over a wave,
    # so two consumer warpgroups a block
    serial = [dict(B=8, Sq=512, Skv=512, H=4, KV=1, hd=256, dtype=torch.bfloat16, window=w)
              for w in (0, 512)]
    worst, worst_tol = 0.0, None
    consumers_seen = set()
    for case in cases + serial:
        before = dict(flash_attention.variant_launches)
        (q, k, _, _), got, want = _flash_case(torch, gen, **case)
        kind = [n for n, c in flash_attention.variant_launches.items() if c != before[n]]
        name = str(case["dtype"]).split(".")[-1]
        err, ok = _max_err_and_ok(torch, got, want, TOL[name])
        desc = ", ".join(f"{k}={v}" for k, v in case.items() if k != "dtype")
        tc = (name == "bfloat16" and case["hd"] in flash_attention.WGMMA_HEAD_DIMS
              and flash_attention.WGMMA_ROWS % (case["H"] // case["KV"]) == 0)
        layout = kind[0]
        if kind == ["wgmma"]:
            consumers = flash_attention.consumer_warpgroups(q, k)
            consumers_seen.add(consumers)
            layout = f"wgmma, {consumers} consumer warpgroup{'s' if consumers > 1 else ''}"
        log(f"[kernels] flash_attention {name} {desc} ({layout}): max_abs_err={err:.3e} "
            f"tol={TOL[name]} {'ok' if ok else 'FAIL'}")
        require(ok, f"flash_attention disagrees with its plain version ({desc}, {name})")
        require(kind == ["wgmma" if tc else "simt"],
                f"flash_attention ({desc}, {name}) ran {kind}")
        if case in serial:
            require(consumers == 2, f"flash_attention ({desc}) ran {consumers} consumer "
                    f"warpgroups a block, expected 2")
        if err > worst:
            worst, worst_tol = err, TOL[name]
    require(consumers_seen == {1, 2},
            f"the compared wgmma cases ran {sorted(consumers_seen)} consumer warpgroups a block")

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
    # the configs' other prefills (B=1, 1024 tokens), each beside SDPA: the
    # simt kernel at the head dims and group sizes the tensor-core variant
    # does not take (zamba2-7b: 32 heads over 32, hd 112; stablelm-12b: 32
    # over 8, hd 160; granite-20b: 48 over 1, hd 128), and minitron-8b's 32
    # over 8 at hd 128 on wgmma
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
    ("zamba2-7b prefill", "simt", dict(Sq=1024, H=32, KV=32, hd=112)),
    ("stablelm-12b prefill", "simt", dict(Sq=1024, H=32, KV=8, hd=160)),
    ("granite-20b prefill", "simt", dict(Sq=1024, H=48, KV=1, hd=128)),
    ("minitron-8b prefill", "wgmma", dict(Sq=1024, H=32, KV=8, hd=128)),
)


def _flash_timing(torch, gen, label, want_kind, *, Sq, H, KV, hd) -> dict:
    """Device times of flash (bf16, B=1, causal, Sq = Skv), warm and with
    its inputs cold in L2, its plain version and SDPA at one shape, with the
    bound; the launch must take variant `want_kind`."""
    from repro_torch.kernels import flash_attention, ref

    (q, k, v, kw), got, want = _flash_case(torch, gen, Sq=Sq, Skv=Sq, H=H, KV=KV, hd=hd,
                                           dtype=torch.bfloat16)
    err, ok = _max_err_and_ok(torch, got, want, TOL["bfloat16"])
    require(ok, f"flash_attention ({label}) disagrees with its plain version: {err:.3e}")
    kind = launched_variant(flash_attention,
                            lambda: flash_attention.flash_attention(q, k, v, **kw))
    require(kind == want_kind, f"flash_attention ({label}) ran {kind}, expected {want_kind}")
    d_kernel = device_ms(torch, lambda: flash_attention.flash_attention(q, k, v, **kw))
    d_cold = cold_device_ms(torch, lambda q_, k_, v_: flash_attention.flash_attention(
        q_, k_, v_, **kw), (q, k, v), q.nbytes + k.nbytes + v.nbytes)
    d_plain = device_ms(torch, lambda: ref.attention(q, k, v, **kw), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    d_lib = device_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    lib_err = float((sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2).float()
                     - want.float()).abs().max())
    pairs = Sq * (Sq + 1) // 2
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * hd * H * pairs
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    shape = f"{label}: B=1 Sq=Skv={Sq} H={H} KV={KV} hd={hd} bf16 causal ({kind})"
    log(f"[kernels] flash_attention timing {shape}: max_abs_err={err:.3e}; device time per "
        f"call: kernel {d_kernel:.4f} ms ({d_cold:.4f} ms with the inputs cold in L2), plain "
        f"{d_plain:.4f} ms, sdpa {d_lib:.4f} ms (sdpa max_abs_err vs plain {lib_err:.3e}); bound "
        f"{max(b_bytes, b_ops) * 1e3:.2f} us ({n_bytes} B, {flops} FLOP); "
        f"{flops / (d_kernel * 1e-3) / 1e12:.2f} TFLOP/s on the device time")
    return dict(shape=shape, variant=kind, max_abs_err=err, device_ms=d_kernel,
                cold_device_ms=d_cold, plain_device_ms=d_plain,
                library_device_ms=d_lib, bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                tflops=flops / (d_kernel * 1e-3) / 1e12)


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
    hdp = next(b for b in (16, 32, 64, 128, 256) if hd <= b)
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
    # the dense family's ticks: minitron-8b (32 over 8, hd 128: mma) and
    # stablelm-12b (32 over 8, hd 160: the simt walk)
    for hd in (128, 160):
        cases.append(dict(pos=uneven, dtype=torch.bfloat16, H=32, KV=8, hd=hd))
    cases.append(dict(pos=uneven, dtype=torch.float32, H=32, KV=8, hd=160))
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
    for k in ("mma", "simt"):
        log(f"[kernels] paged_decode_attention ptxas: "
            f"{decode_ptxas('PagedRows', q.dtype, hd, H // KV, k)}")
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
                           "device_ms": d_window, "bound_ms": w_bound}, granite],
    }


def _paged_timing(torch, gen, pos, label, want_kind, *, H, KV, hd) -> dict:
    """The paged kernel at one serving tick's shape (8 slots, 16-position
    pages, `pos` positions, bf16), warm and with the pools cold in L2,
    beside its plain version, with the bound; no single PyTorch call
    computes the paged gather and attention together."""
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
        f"per call: kernel {d_kernel:.4f} ms ({d_cold:.4f} ms with the pools cold in L2), plain "
        f"{d_plain:.4f} ms; bound {max(b_bytes, b_ops) * 1e3:.3f} us ({n_bytes} B, {flops} FLOP)")
    return dict(shape=shape, variant=kind, max_abs_err=err, device_ms=d_kernel,
                cold_device_ms=d_cold, plain_device_ms=d_plain, library_device_ms=None,
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
            # bf16 rows, 14 loads of 16 B), on the simt walk
            dict(pos=uneven, dtype=dtype, H=32, KV=32, hd=112),
            # the dense family: stablelm-12b (32 over 8, hd 160: the simt walk
            # at 20 loads of 16 B a bf16 row) and minitron-8b (32 over 8, hd 128)
            dict(pos=uneven, dtype=dtype, H=32, KV=8, hd=160),
            dict(pos=uneven, dtype=dtype, H=32, KV=8, hd=128),
        ]
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
    d_paged = device_ms(torch, lambda: paged_decode_attention.paged_decode_attention(
        q, pool_k, pool_v, tbl16, pos))
    cluster, kind = decode_core.cluster_size(q, k), decode_core.variant(q, k)
    require(kind == "mma", f"decode_attention timed on {kind}, expected mma")

    def timed_with(attr, value):
        # the same two calls with a rule of `decode_core` swapped, for the
        # record: clusters of 16 (the non-portable size) in place of the cap
        # of 8, or the exact-FMA walk in place of the tensor cores
        saved = getattr(decode_core, attr)
        setattr(decode_core, attr, value)
        try:
            return (device_ms(torch, lambda: decode_attention.decode_attention(q, k, v, pos)),
                    device_ms(torch, lambda: paged_decode_attention.paged_decode_attention(
                        q, pool_k, pool_v, tbl16, pos)))
        finally:
            setattr(decode_core, attr, saved)

    d16, d16_paged = timed_with("MAX_CLUSTER", 16)
    d_simt, d_simt_paged = timed_with("variant", lambda q_, k_: "simt")
    zamba2 = _decode_timing(torch, gen, uneven, "zamba2-7b decode", H=32, KV=32, hd=112)
    stablelm = _decode_timing(torch, gen, uneven, "stablelm-12b decode", H=32, KV=8, hd=160)
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
        "other_timings": [zamba2, stablelm],
    }


def _decode_timing(torch, gen, pos, label, *, H, KV, hd) -> dict:
    """The dense kernel at a decode tick's shape off the tensor-core walk
    (8 slots, 1088-deep caches, a head_dim not a power of two, bf16: the
    simt walk) beside its plain version and SDPA, with the bound."""
    from repro_torch.kernels import decode_attention, decode_core, ref

    q, k, v, pos_t = _decode_case(torch, gen, pos=pos, dtype=torch.bfloat16, H=H, KV=KV, hd=hd)
    kind = decode_core.variant(q, k)
    require(kind == "simt", f"decode_attention at hd {hd} ran {kind}, expected simt")
    err, ok = _max_err_and_ok(torch, decode_attention.decode_attention(q, k, v, pos_t),
                              ref.decode_attention(q, k, v, pos_t), TOL["bfloat16"])
    require(ok, f"decode_attention ({label}) disagrees with its plain version: {err:.3e}")
    d_kernel = device_ms(torch, lambda: decode_attention.decode_attention(q, k, v, pos_t))
    d_plain = device_ms(torch, lambda: ref.decode_attention(q, k, v, pos_t))
    d_cold = cold_device_ms(
        torch, lambda k_, v_: decode_attention.decode_attention(q, k_, v_, pos_t), (k, v),
        k.nbytes + v.nbytes)
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
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    shape = (f"{label}: B={B} S={S} H={H} KV={KV} hd={hd} bf16, {n_valid} valid "
             f"positions ({kind}, cluster of {decode_core.cluster_size(q, k)})")
    log(f"[kernels] decode_attention timing {shape}: max_abs_err={err:.3e}; device time per call: kernel "
        f"{d_kernel:.4f} ms, plain {d_plain:.4f} ms, sdpa {d_lib:.4f} ms; kernel with the "
        f"caches cold in L2 {d_cold:.4f} ms; bound {max(b_bytes, b_ops) * 1e3:.3f} us "
        f"({n_bytes} B, {flops} FLOP)")
    return dict(shape=shape, variant=kind, max_abs_err=err, device_ms=d_kernel,
                plain_device_ms=d_plain, cold_device_ms=d_cold, library_device_ms=d_lib,
                bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations")


def _linear_bound_ms(M, K, N, elem, dtype_name) -> tuple:
    n_bytes = (M * K + K * N + N + M * N) * elem
    flops = 2 * M * N * K
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations"), n_bytes, flops


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
                if dtype == torch.bfloat16:  # N = 10 and K = 50 are not TMA-aligned
                    want_kind = "simt" if K % 8 or N % 8 else "wgmma"
                    require(kind == want_kind, f"fused_linear bf16 M={M} K={K} N={N} ran {kind}")
                if err > worst:
                    worst, worst_tol = err, LINEAR_TOL[name]

    def timings(M, K, N, dtype, act, iters):
        x, w, b = (0.3 * torch.randn(sh, generator=gen, device="cuda")
                   for sh in ((M, K), (K, N), (N,)))
        x, w, b = (t.to(dtype) for t in (x, w, b))
        kind = launched_variant(fused_linear, lambda: fused_linear.fused_linear(x, w, b, act=act))
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
        log(f"[kernels] fused_linear timing M={M} K={K} N={N} {name} act={act} ({kind}): kernel "
            f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, addmm {t_lib:.4f} ms (bias only; the "
            f"activation would be one more launch); device time per call: kernel "
            f"{d_kernel:.4f} ms, plain {d_plain:.4f} ms, addmm {d_lib:.4f} ms; max_abs_err vs "
            f"plain {err:.3e}; bound "
            f"{bound * 1e3:.3f} us by {by} ({n_bytes} B, {flops} FLOP); "
            f"{flops / (d_kernel * 1e-3) / 1e12:.2f} TFLOP/s on the device time")
        return dict(shape=f"M={M} K={K} N={N} {name} act={act}", variant=kind, ms=t_kernel,
                    plain_ms=t_plain, device_ms=d_kernel, plain_device_ms=d_plain,
                    library_ms=t_lib, library_device_ms=d_lib, bound_ms=bound, bound_by=by,
                    max_abs_err=err, tflops=flops / (d_kernel * 1e-3) / 1e12)

    # the Test Case 2 path: layer 1 (256 x 64 @ 64 x 32, relu), fp32
    main = timings(256, 64, 32, torch.float32, "relu", iters=100)
    large = [timings(*LARGE_GEMM, torch.float32, "none", iters=5),
             timings(*LARGE_GEMM, torch.bfloat16, "none", iters=5)]
    require(main["variant"] == "simt" and large[0]["variant"] == "simt_tiled"
            and large[1]["variant"] == "wgmma",
            f"timed fused_linear variants {main['variant']}, {large[0]['variant']}, "
            f"{large[1]['variant']}; expected simt, simt_tiled, wgmma")
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
        "other_timings": large + cut,
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


def phase_kernels(torch) -> list:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return [check_flash(torch, gen), check_paged(torch, gen), check_decode(torch, gen),
            check_fused_linear(torch, gen), check_scan(torch, gen)]


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
    # fp32 products of 256 rows: the exact-FMA variant with 64 x 64 tiles
    require_variant(variants["fused_linear"], "fused_linear", "simt", 2 * n_batches,
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
                "paged_decode_attention": 0, "fused_linear": 0}
        require(counts == want, f"zamba2 serve launches {counts}, expected {want}")
        require_variant(variants, "flash_attention", "simt", want["flash_attention"],
                        "zamba2 serve")
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
            "fused_linear": 0}
    require(serial_counts == want, f"zamba2 serial launches {serial_counts}, expected {want}")
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
#: kernels' rules: (flash, paged decode). granite's 48 query heads a KV head
#: do not divide the wgmma variant's 64 rows; stablelm's head_dim 160 is
#: neither a wgmma head dim nor a power of two
DENSE_FAMILY_VARIANTS = {"granite-20b": ("simt", "mma"), "minitron-8b": ("wgmma", "mma"),
                         "stablelm-12b": ("simt", "simt")}


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
                "decode_attention": 0, "gated_linear_scan": 0, "fused_linear": 0}
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
                    "paged_decode_attention": 0, "gated_linear_scan": 0, "fused_linear": 0}
            require(serial == want, f"{arch} serial launches {serial}, expected {want}")
            require_variant(serial_variants, "flash_attention", "simt", want["flash_attention"],
                            f"{arch} serial")
            require_variant(serial_variants, "decode_attention", "simt",
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
    the 16 synthetic requests, then a kill-and-respawn beside a plain run on
    one worker, both on 4 requests, for the card's memory. Returns the
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
            "decode_attention": 0, "gated_linear_scan": 0, "fused_linear": 0}
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
    # peak does not grow by a pool when its replacement allocates its own
    few = synthetic_requests(cfg.vocab_size, 4, prompt_range=(64, 257), steps_range=(24, 33),
                             seed=2)
    peaks, results = {}, {}
    for kill in (False, True):
        state, hook = _kill_mid_stream(2)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with _worker_schedulers(keep=False) as made:
            res = run_fleet(model, params, few, n_workers=1, respawn=kill,
                            on_forward=hook if kill else None, **fleet)
        torch.cuda.synchronize()
        peaks[kill] = torch.cuda.max_memory_allocated() - base
        gc.collect()
        left = torch.cuda.memory_allocated() - base
        results[kill] = {rid: r.get("tokens") for rid, r in res.results.items()}
        require(all(ref() is None for ref in made), "a worker's scheduler outlived its fleet")
        require(left < pool_bytes // 2, f"{left} B still allocated after the fleet")
        if kill:
            require(state["worker"] is not None and res.stats["workers_spawned"] == 2
                    and state["victim"] in res.stats["restarted"],
                    f"kill-and-respawn did not happen: {state}, {res.stats}")
    log(f"[serve-fleet] kill-and-respawn on one worker (4 requests, prompts 64-256): peak "
        f"device memory above the weights {peaks[True] / 2**20:.1f} MiB against "
        f"{peaks[False] / 2**20:.1f} MiB without the kill (one worker's pool: "
        f"{pool_bytes / 2**20:.1f} MiB); tokens equal to the run without the kill: "
        f"{results[True] == results[False]} (reported: bf16)")
    require(peaks[True] < peaks[False] + pool_bytes // 2,
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
        t_start = time.perf_counter()
        phase_device(torch)
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
                   "serve-fleet": fleet_counts}
    for k in kernels:
        k["launches_by_path"] = {path: c[k["name"]] for path, c in path_counts.items()
                                 if c[k["name"]]}
        k["launches"] = sum(k["launches_by_path"].values())
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
