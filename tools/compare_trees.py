"""Compare copies of the repository on one card, each in its own process, in turns.

Each DIR is a copy of the repository (e.g. `git archive <commit> | tar -x -C
devchip/parent`, in a directory that .gitignore lists). The kernels of every
copy are built first, in parallel; then each copy runs once in the order given
and once in the reverse order (a, b, b, a), so a drift of the card's clocks
over the run falls on both sides. Modes:

* ``flash``: flash's forward (bf16) at a few ragged and masked shapes against
  its plain version, then its device time at the configs' prefill shapes;
* ``flash-bwd``: flash's backward at the training shapes (bf16, and fp32 at
  `examples/train_100m_torch.py`'s), against its plain version within 2e-2
  (bf16) or 2e-5 (fp32) of max |plain| and timed;
* ``decode``: the dense and the paged decode kernels at the configs' ticks
  (B=8, 3026 valid positions, bf16), against their plain versions and
  timed;
* ``serves``: `chip_smoke.py`'s serve-dense-family and serve-zamba2 phases
  (tok/s, TTFT; full-width weights, minutes a copy); ``serves-moe``: its
  serve-moe phase (grok-1 at 8 layers, kimi-k2 at 1);
* ``train-100m``: `chip_smoke.py`'s example-train-100m phase (ms a step).
* ``flash-bwd-bits``: the fp32 flash backward (`tf32x3`) on inputs made on
  the CPU from fixed seeds (out and lse from the plain version there), a
  SHA-256 digest of every gradient's bytes: equal digests, the same bits.

Device times are `chip_smoke.device_ms` (profiler device time). The last line
is the card's name and power limit. Run on the card from the repository's
root: `python3 tools/compare_trees.py flash devchip/parent devchip/change`.
"""
import os
import subprocess
import sys

FLASH_CHECKS = [dict(B=2, Sq=77, H=32, KV=32, hd=112),
                dict(B=1, Sq=300, H=8, KV=2, hd=160, window=64),
                dict(B=2, Sq=257, H=6, KV=1, hd=80),
                dict(B=1, Sq=1024, H=48, KV=1, hd=128),
                dict(B=8, Sq=512, H=4, KV=1, hd=256, window=512),
                dict(B=1, Sq=1024, H=4, KV=1, hd=256),
                dict(B=2, Sq=288, H=8, KV=1, hd=256, prefix_len=256),
                dict(B=1, Sq=1500, H=12, KV=12, hd=64, causal=False),
                dict(B=1, Sq=50, Skv=20, H=6, KV=1, hd=160, window=8)]
FLASH_TIMED = [("zamba2", dict(B=1, Sq=1024, H=32, KV=32, hd=112)),
               ("stablelm", dict(B=1, Sq=1024, H=32, KV=8, hd=160)),
               ("granite", dict(B=1, Sq=1024, H=48, KV=1, hd=128)),
               ("grok", dict(B=1, Sq=1024, H=48, KV=8, hd=128)),
               ("kimi", dict(B=1, Sq=1024, H=64, KV=8, hd=112)),
               ("minitron", dict(B=1, Sq=1024, H=32, KV=8, hd=128)),
               ("gemma3 B=1", dict(B=1, Sq=1024, H=4, KV=1, hd=256)),
               ("gemma3 B=8x512", dict(B=8, Sq=512, H=4, KV=1, hd=256)),
               ("gemma3 local B=8x512", dict(B=8, Sq=512, H=4, KV=1, hd=256, window=512)),
               ("paligemma B=8", dict(B=8, Sq=288, H=8, KV=1, hd=256, prefix_len=256)),
               ("whisper enc B=8", dict(B=8, Sq=1500, H=12, KV=12, hd=64, causal=False)),
               ("zamba2 B=2 train", dict(B=2, Sq=1024, H=32, KV=32, hd=112))]
BWD_TIMED = [("zamba2 train", dict(B=2, Sq=1024, H=32, KV=32, hd=112)),
             ("gemma3 global", dict(B=4, Sq=1024, H=4, KV=1, hd=256)),
             ("gemma3 local", dict(B=4, Sq=1024, H=4, KV=1, hd=256, window=512)),
             ("hd112 S400", dict(B=1, Sq=400, H=32, KV=32, hd=112)),
             ("granite", dict(B=1, Sq=1024, H=48, KV=1, hd=128)),
             ("grok", dict(B=1, Sq=1024, H=48, KV=8, hd=128)),
             ("minitron B=2", dict(B=2, Sq=1024, H=32, KV=8, hd=128)),
             ("whisper enc B=2", dict(B=2, Sq=1500, H=12, KV=12, hd=64, causal=False)),
             ("train_100m fp32", dict(B=4, Sq=256, H=8, KV=2, hd=80, dtype="float32"))]
#: (name, H, KV, hd, paged) of the decode ticks timed: 8 slots, the serves'
#: uneven positions in 1088-deep caches (pages of 16 when paged)
DECODE_TIMED = [("stablelm dense", 32, 8, 160, False), ("stablelm paged", 32, 8, 160, True),
                ("kimi paged", 64, 8, 112, True), ("zamba2 dense", 32, 32, 112, False),
                ("grok dense", 48, 8, 128, False), ("grok paged", 48, 8, 128, True),
                ("minitron paged", 32, 8, 128, True), ("granite paged", 48, 1, 128, True),
                ("gemma3 paged", 4, 1, 256, True)]
UNEVEN = [0, 15, 16, 100, 511, 512, 777, 1087]
#: (B, S, H, KV, hd, masks) of the fp32 backward's bit comparison
BITS_CASES = [(4, 256, 8, 2, 80, {}), (4, 256, 8, 2, 80, {"window": 64}),
              (2, 77, 6, 1, 160, {}), (1, 130, 4, 1, 256, {"prefix_len": 50}),
              (2, 45, 4, 1, 16, {"window": 16}), (1, 40, 4, 1, 112, {"q_offset": 30, "window": 8})]
MODES = ("flash", "flash-bwd", "decode", "serves", "serves-moe", "train-100m", "flash-bwd-bits")


def _flash(cs, torch, tag):
    from repro_torch.kernels import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(1)
    bad = 0
    for case in FLASH_CHECKS:
        case = {"Skv": case["Sq"], **case}
        _, got, want = cs._flash_case(torch, gen, dtype=torch.bfloat16, **case)
        err, ok = cs._max_err_and_ok(torch, got, want, cs.TOL["bfloat16"])
        if not ok:
            bad += 1
            print(tag, "FAIL", case, err, flush=True)
    print(tag, "checks", f"{bad} FAILED" if bad else "ok", flush=True)
    out = []
    for name, case in FLASH_TIMED:
        case = {"Skv": case["Sq"], **case}
        (q, k, v, kw), _, _ = cs._flash_case(torch, gen, dtype=torch.bfloat16, **case)
        ms = cs.device_ms(torch, lambda: flash_attention.flash_attention(q, k, v, **kw), iters=30)
        out.append(f"{name} {ms:.4f}")
    print(tag, "TIMES", " | ".join(out), flush=True)
    return bad == 0


def _flash_bwd(cs, torch, tag):
    from repro_torch.kernels import flash_attention, ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    out, ok = [], True
    for name, case in BWD_TIMED:
        case = {"dtype": "bfloat16", **case}
        tol = 2e-5 if case["dtype"] == "float32" else cs.BWD_REL_TOL["bfloat16"]
        q, k, v, o, lse, do, kw = cs._bwd_case(torch, gen, **case)
        got = flash_attention.flash_attention_backward(q, k, v, o, lse, do, **kw)
        want = ref.attention_backward(q, k, v, o, lse, do, **kw)
        rel = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                  for a, b in zip(got, want))
        ok &= rel <= tol
        ms = cs.device_ms(torch, lambda: flash_attention.flash_attention_backward(
            q, k, v, o, lse, do, **kw), iters=20)
        out.append(f"{name} {ms:.4f}{'' if rel <= tol else ' FAIL'}")
        del q, k, v, o, lse, do, got, want
    print(tag, "BWD", " | ".join(out), flush=True)
    return ok


def _flash_bwd_bits(cs, torch, tag):
    import hashlib

    import numpy as np

    from repro_torch.kernels import flash_attention, ref

    digest = hashlib.sha256()
    for i, (B, S, H, KV, hd, kw) in enumerate(BITS_CASES):
        rng = np.random.default_rng(100 + i)
        Skv = S + kw.get("q_offset", 0)
        q, do = (torch.from_numpy(rng.standard_normal((B, S, H, hd), dtype=np.float32))
                 for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal((B, Skv, KV, hd), dtype=np.float32))
                for _ in range(2))
        out, lse = ref.attention_with_lse(q, k, v, **kw)
        args = [t.contiguous().cuda() for t in (q, k, v, out, lse, do)]
        assert flash_attention.backward_variant(*args[:4], args[5]) == "tf32x3"
        for g in flash_attention.flash_attention_backward(*args, **kw):
            digest.update(g.cpu().numpy().tobytes())
    print(tag, "BWD-BITS", digest.hexdigest(), flush=True)
    return True


def _decode(cs, torch, tag):
    from repro_torch.kernels import decode_attention, paged_decode_attention, ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    out, ok = [], True
    for name, H, KV, hd, paged in DECODE_TIMED:
        q, k, v, pos = cs._decode_case(torch, gen, pos=UNEVEN, dtype=torch.bfloat16, H=H, KV=KV,
                                       hd=hd)
        if paged:
            B, S = k.shape[:2]
            k, v = (x.view(B * S // 16, 16, KV, hd) for x in (k, v))
            tbl = torch.arange(B * S // 16, dtype=torch.int32, device="cuda").view(B, S // 16)
            call = lambda: paged_decode_attention.paged_decode_attention(  # noqa: E731
                q, k, v, tbl, pos)
            want = ref.paged_decode_attention(q, k, v, tbl, pos)
        else:
            call = lambda: decode_attention.decode_attention(q, k, v, pos)  # noqa: E731
            want = ref.decode_attention(q, k, v, pos)
        err, good = cs._max_err_and_ok(torch, call(), want, cs.PAGED_TOL["bfloat16"])
        ok &= good
        ms = cs.device_ms(torch, call, iters=50)
        out.append(f"{name} {ms:.4f}{'' if good else ' FAIL'}")
        del q, k, v, want
    print(tag, "DECODE", " | ".join(out), flush=True)
    return ok


def _serves(cs, torch, tag):
    cs.log = lambda msg: print(f"<{tag}> {msg}", flush=True)
    cs.run_phase("serve-dense-family", cs.phase_serve_dense_family, torch)
    cs.run_phase("serve-zamba2", cs.phase_serve_zamba2, torch)
    return True


def _serves_moe(cs, torch, tag):
    cs.log = lambda msg: print(f"<{tag}> {msg}", flush=True)
    cs.run_phase("serve-moe", cs.phase_serve_moe, torch)
    return True


def _train_100m(cs, torch, tag):
    cs.log = lambda msg: print(f"<{tag}> {msg}", flush=True)
    cs.run_phase("example-train-100m", cs.phase_example_train_100m, torch, tag)
    return True


def _one(mode: str, tree: str, build_only: bool) -> int:
    """One copy's run, in this process: its `chip_smoke.py` and package."""
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    assert cs.__file__.startswith(tree), cs.__file__
    cs._load_spec()
    tag = os.path.basename(tree)
    if build_only:
        build.load(verbose=True)
        print(tag, "built; ptxas C7515:", "C7515" in build.build_log(), flush=True)
        return 0
    run = {"flash": _flash, "flash-bwd": _flash_bwd, "decode": _decode, "serves": _serves,
           "serves-moe": _serves_moe, "train-100m": _train_100m,
           "flash-bwd-bits": _flash_bwd_bits}[mode]
    return 0 if run(cs, torch, tag) else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) >= 3 and argv[0] == "--one":
        return _one(argv[1], os.path.abspath(argv[2]), build_only=argv[3:] == ["build"])
    if len(argv) < 2 or argv[0] not in MODES:
        print(__doc__, file=sys.stderr)
        return 2
    mode, trees = argv[0], [os.path.abspath(t) for t in argv[1:]]
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--one", mode, t, "build"]) for t in trees]
    rc = max(p.wait() for p in builds)
    if rc == 0:
        rc = max(subprocess.call([sys.executable, me, "--one", mode, t])
                 for t in trees + trees[::-1])
    subprocess.call(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return rc


if __name__ == "__main__":
    sys.exit(main())
