#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path -- full-width gemma3-1b served by the paged
continuous-batching scheduler -- and fails (non-zero exit) if any phase
fails. It imports nothing of JAX or of the JAX package. Phases:

1. device: the card from `nvidia-smi` (name, power limit);
2. build: compile the CUDA kernels from `src/repro_torch/csrc` with nvcc for
   sm_90a and print the `-Xptxas -v` report (registers, shared memory,
   spills);
3. kernels: hold each CUDA kernel against its plain PyTorch version on the
   card at the serving path's shapes and at ragged / edge shapes, and time
   kernel, plain version and (flash only) the library call
   `F.scaled_dot_product_attention` with CUDA events;
4. reduced: REDUCED gemma3-1b in fp32 (TF32 off): prefill plus 16
   teacher-forced paged decode ticks on the card against the same functions
   on the CPU;
5. serve: full gemma3-1b (26 layers, d_model 1152, vocab 262144, bf16) serves
   16 synthetic requests (prompts 64-1024 tokens, 16-64 new tokens) on 8
   slots through `ContinuousBatchingScheduler.serve()`; both kernels' launch
   counts are read around that run and must be exactly what the path needs.

The line before the last is one JSON object with every kernel's numbers;
the last line is the device JSON. Needs one card; the first run on a fresh
checkout builds the kernels (seconds).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate and the rate of
# each input type's arithmetic (bf16 on the tensor cores, fp32 on CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
PAGED_TOL = {"float32": dict(atol=1e-5, rtol=0.0), "bfloat16": dict(atol=5e-2, rtol=0.0)}
REDUCED_ATOL = 1e-4


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


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


def _max_err_and_ok(torch, got, want, tol) -> tuple:
    got32, want32 = got.float(), want.float()
    diff = (got32 - want32).abs()
    ok = bool(torch.all(diff <= tol["atol"] + tol["rtol"] * want32.abs()).item())
    ok = ok and bool(torch.isfinite(got32).all().item())
    return float(diff.max().item()), ok


def _flash_case(torch, gen, *, Sq, Skv, H, KV, hd, dtype, causal=True, window=0,
                prefix_len=0, q_offset=0):
    from repro_torch.kernels import flash_attention, ref

    q = torch.randn((1, Sq, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, Skv, KV, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((1, Skv, KV, hd), generator=gen, device="cuda").to(dtype)
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
    worst, worst_tol = 0.0, None
    for case in cases:
        _, got, want = _flash_case(torch, gen, **case)
        name = str(case["dtype"]).split(".")[-1]
        err, ok = _max_err_and_ok(torch, got, want, TOL[name])
        desc = ", ".join(f"{k}={v}" for k, v in case.items() if k != "dtype")
        log(f"[kernels] flash_attention {name} {desc}: max_abs_err={err:.3e} "
            f"tol={TOL[name]} {'ok' if ok else 'FAIL'}")
        require(ok, f"flash_attention disagrees with its plain version ({desc}, {name})")
        if err > worst:
            worst, worst_tol = err, TOL[name]

    # timing at the serving path's heaviest prefill: a 1024-token prompt
    # through a global layer (causal, no window), bf16
    Sq, H, KV, hd = 1024, 4, 1, 256
    (q, k, v, kw), got, want = _flash_case(
        torch, gen, Sq=Sq, Skv=Sq, H=H, KV=KV, hd=hd, dtype=torch.bfloat16)
    t_kernel = time_ms(torch, lambda: flash_attention.flash_attention(q, k, v, **kw))
    t_plain = time_ms(torch, lambda: ref.attention(q, k, v, **kw))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_lib = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    lib_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    lib_err = float((lib_out.float() - want.float()).abs().max().item())
    # per-window timing of the local layers' shape too (printed, not in the JSON)
    (q2, k2, v2, kw2), _, _ = _flash_case(
        torch, gen, Sq=Sq, Skv=Sq, H=H, KV=KV, hd=hd, dtype=torch.bfloat16, window=512)
    t_kernel_w = time_ms(torch, lambda: flash_attention.flash_attention(q2, k2, v2, **kw2))

    pairs = int(_build_mask(Sq, Sq, causal=True, window=0, prefix_len=0, q_offset=0,
                            device="cuda").sum().item())
    elem = q.element_size()
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * elem
    flops = 4 * hd * H * pairs
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    log(f"[kernels] flash_attention timing B=1 Sq=Skv={Sq} H={H} KV={KV} hd={hd} bf16 causal: "
        f"kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, sdpa {t_lib:.4f} ms "
        f"(sdpa max_abs_err vs plain {lib_err:.3e}); window=512: kernel {t_kernel_w:.4f} ms; "
        f"bound {max(b_bytes, b_ops) * 1e3:.2f} us ({n_bytes} B, {flops} FLOP)")
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
        "bound_ms": max(b_bytes, b_ops),
        "bound_us": max(b_bytes, b_ops) * 1e3,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": t_lib,
        "timed_shape": f"B=1 Sq=Skv={Sq} H={H} KV={KV} hd={hd} bf16 causal window=0",
    }


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
    from repro_torch.kernels import paged_decode_attention, ref

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
        log(f"[kernels] paged_decode_attention {name} {desc}: max_abs_err={err:.3e} "
            f"tol={PAGED_TOL[name]} {'ok' if ok else 'FAIL'}")
        require(ok, f"paged_decode_attention disagrees with its plain version ({desc}, {name})")
        if err > worst:
            worst, worst_tol = err, PAGED_TOL[name]

    # timing at the serving path's global-layer shape: 8 slots, uneven
    # positions up to the 1088-position cache, bf16
    q, kp, vp, tbl, pos = _paged_case(torch, gen, pos=uneven, dtype=torch.bfloat16)
    t_kernel = time_ms(torch, lambda: paged_decode_attention.paged_decode_attention(
        q, kp, vp, tbl, pos), iters=100)
    t_plain = time_ms(torch, lambda: ref.paged_decode_attention(q, kp, vp, tbl, pos))
    B, H, hd = q.shape
    KV = kp.shape[2]
    n_valid = sum(p + 1 for p in uneven)
    elem = q.element_size()
    n_bytes = 2 * q.numel() * elem + 2 * n_valid * KV * hd * elem + tbl.numel() * 4 + B * 4
    flops = 4 * H * hd * n_valid
    b_bytes, b_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    log(f"[kernels] paged_decode_attention timing B={B} H={H} KV={KV} hd={hd} page=16 "
        f"n_pages=68 pos={uneven} bf16: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms; "
        f"bound {max(b_bytes, b_ops) * 1e3:.2f} us ({n_bytes} B, {flops} FLOP)")
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
        "bound_ms": max(b_bytes, b_ops),
        "bound_us": max(b_bytes, b_ops) * 1e3,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None,
        "timed_shape": f"B={B} H={H} KV={KV} hd={hd} page=16 n_pages=68 bf16 window=0",
    }


def phase_kernels(torch) -> list:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return [check_flash(torch, gen), check_paged(torch, gen)]


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

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (45, 12, 3)]
    steps = rng.integers(1, cfg.vocab_size, (16, len(prompts))).tolist()
    ops.reset_launch_counts()
    on_card = reduced_logits(torch, cfg, to(params_cpu, "cuda"), prompts, steps, "cuda")
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
# 5. serve full-width gemma3-1b
# ---------------------------------------------------------------------------


def phase_serve(torch) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.common import dtype_of
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.serve.workload import synthetic_requests

    cfg = get_config("gemma3-1b")
    model = build(cfg)
    prompt_range, steps_range, n_req = (64, 1025), (16, 65), 16
    max_len = (prompt_range[1] - 1) + (steps_range[1] - 1)
    with Runtime("torchdev") as rt:
        t0 = time.perf_counter()
        params = model.init(seed=0, device=rt.processing_unit.context,
                            dtype=dtype_of(cfg.compute_dtype))
        torch.cuda.synchronize()
        log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.num_heads}q/{cfg.num_kv_heads}kv heads x {cfg.resolved_head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.compute_dtype}; weights initialised on "
            f"the card in {time.perf_counter() - t0:.1f}s")
        sched = ContinuousBatchingScheduler(
            model, params, max_batch=8, max_len=max_len, runtime=rt, kv_mode="paged",
            page_size=16, sync_interval=8,
        )
        layout = sched.decoder.layout
        log(f"[serve] layout: cache_len {layout.cache_len}, ring {layout.ring} "
            f"(w_pages {layout.w_pages}), pool pages {layout.num_pages}")
        # warm-up: CUDA context, cuBLAS handles, kernel library
        warm = synthetic_requests(cfg.vocab_size, 2, prompt_range=(64, 65), steps_range=(9, 10),
                                  seed=1, rid_prefix="warm")
        sched.serve(warm)
        require(sched.decoder.kv.pages_used == 0, "warm-up left pages allocated")

        requests = synthetic_requests(cfg.vocab_size, n_req, prompt_range=prompt_range,
                                      steps_range=steps_range, seed=0)
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
        peak = torch.cuda.max_memory_allocated()
        ticks = sched.ticks - ticks0

    require(len(results) == n_req, f"{len(results)} of {n_req} requests finished")
    n_tok = 0
    for r in requests:
        fin = results[r.rid]
        toks = np.asarray(fin.tokens)
        require(len(toks) == r.max_new_tokens and fin.finish_reason == "length",
                f"{r.rid}: {len(toks)} tokens ({fin.finish_reason}), budget {r.max_new_tokens}")
        require(bool(np.all((toks >= 0) & (toks < cfg.vocab_size))), f"{r.rid}: token out of range")
        n_tok += len(toks)
    require(sched.decoder.kv.pages_used == 0, "pages still allocated after the drain")
    require(counts["flash_attention"] == n_req * cfg.num_layers,
            f"flash_attention launched {counts['flash_attention']} times, "
            f"expected {n_req * cfg.num_layers}")
    require(counts["paged_decode_attention"] == ticks * cfg.num_layers,
            f"paged_decode_attention launched {counts['paged_decode_attention']} times, "
            f"expected {ticks * cfg.num_layers}")
    ttft = np.asarray([admitted_at[r.rid] - t0 for r in requests])
    plens = [len(r.prompt) for r in requests]
    log(f"[serve] {n_req} requests (prompts {min(plens)}-{max(plens)} tokens, "
        f"{sum(plens)} prompt tokens), {n_tok} generated tokens in {wall:.3f}s: "
        f"{n_tok / wall:.1f} tok/s; TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms, "
        f"p90 {np.percentile(ttft, 90) * 1e3:.1f} ms (from a common start, queueing included); "
        f"{ticks} decode ticks; peak device memory {peak / 2**30:.2f} GiB; launches {counts}")
    for r in requests[:3]:
        log(f"[serve] {r.rid}: prompt {len(r.prompt)} tokens -> {results[r.rid].tokens[:8]}...")
    return counts


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
        phase_device(torch)
        phase_build()
        kernels = phase_kernels(torch)
        phase_reduced(torch)
        counts = phase_serve(torch)
    except Exception as e:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for k in kernels:
        k["launches"] = counts[k["name"]]
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
