#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths -- full-width gemma3-1b served by the paged and by
the dense continuous-batching scheduler and by the serial engine, the
paper's Test Case 2 (heterogeneous inference), and full-width xlstm-125m
served by the dense scheduler and the serial engine and through its
forward/loss -- and fails (non-zero exit) if any phase fails. It imports
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
   work itself, and its kernels' `-Xptxas -v` lines printed;
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
   per mLSTM block), all on the tensor-core variant.

Each path's launch counts are zeroed just before it runs and read just
after. The line before the last is one JSON object with every kernel's
numbers; the last line is the device JSON. Needs one card; the first run on
a fresh checkout builds the kernels (seconds).
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

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
        tc = name == "bfloat16" and case["hd"] in flash_attention.WGMMA_HEAD_DIMS
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
            {"shape": "B=4 Sq=Skv=512 causal", "device_ms": d_half}],
    }


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
    }


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
    }


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
               norm=False, **_):
    """Scan inputs laid out as the model paths hand them over: q, k, v are
    head-split views of (B, S, H, d) projections and log_a a view of a
    (B, S, H) gate (the mLSTM), or q and k one (B, S, dk) tensor broadcast
    over the heads (`shared_qk`: Mamba2's C and B). Scales follow
    `tests/test_kernels.py::TestGatedLinearScan`. Returns (q, k, v, log_a,
    keyword arguments of the call: initial states, the normaliser)."""
    def heads(d, shared=False):
        if shared:
            x = 0.5 * torch.randn((B, 1, S, d), generator=gen, device="cuda")
            return x.to(dtype).expand(B, H, S, d)
        x = 0.5 * torch.randn((B, S, H, d), generator=gen, device="cuda")
        return x.to(dtype).transpose(1, 2)

    q, k, v = heads(dk, shared_qk), heads(dk, shared_qk), heads(dv)
    log_a = -torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda")).transpose(1, 2)
    kw = {}
    if init:
        kw["initial_state"] = 0.5 * torch.randn((B, H, dk, dv), generator=gen, device="cuda")
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
        ("serial-prefill", 10), ("decode", 50), ("mamba2", 20), ("fp32-512", 10),
        ("fp32-decode", 50))]
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
    the served run, {rid: tokens})."""
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
    return counts, {rid: fin.tokens for rid, fin in results.items()}


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
        paged_counts, paged_tokens = run_phase("serve", phase_serve, torch, "paged")
        run_phase("reduced-dense", phase_reduced_dense, torch)
        dense_counts, dense_tokens = run_phase("serve-dense", phase_serve, torch, "dense")
        agree = sum(sum(a == b for a, b in zip(dense_tokens[rid], paged_tokens[rid]))
                    for rid in paged_tokens)
        total = sum(len(t) for t in paged_tokens.values())
        log(f"[serve-dense] tokens equal to the paged run's at the same position: {agree} of "
            f"{total} ({agree / total:.3f}; bf16 sums in another order may flip a greedy "
            f"pick, so reported, not required)")
        run_phase("serial", phase_serial, torch)
        tc2_counts = run_phase("tc2", phase_tc2, torch)
        run_phase("reduced-xlstm", phase_reduced_xlstm, torch)
        xlstm_counts = run_phase("serve-xlstm", phase_serve_xlstm, torch)
        run_phase("loss-xlstm", phase_loss_xlstm, torch)
        log(f"[time] all phases: {time.perf_counter() - t_start:.1f}s")
    except Exception as e:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # each kernel's launches on its own path: flash and paged decode on the
    # paged serve (as in earlier runs), dense decode on the dense serve,
    # fused_linear on Test Case 2's fused_linear row, the scan on the xlstm
    # serve
    path_counts = {"flash_attention": paged_counts, "paged_decode_attention": paged_counts,
                   "decode_attention": dense_counts, "fused_linear": tc2_counts,
                   "gated_linear_scan": xlstm_counts}
    for k in kernels:
        k["launches"] = path_counts[k["name"]][k["name"]]
        log(f"[kernels] {k['name']}: {k['device_ms']:.4f} ms device, {k['tflops']:.3f} TFLOP/s "
            f"at {k['timed_shape']}; library device ms {k['library_device_ms']}; "
            f"{k['launches']} launches on its path")
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
