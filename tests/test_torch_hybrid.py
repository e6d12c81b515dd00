"""The port's zamba2-7b (hybrid family) against the JAX reference.

REDUCED zamba2-7b in fp32 (7 Mamba2 layers, the shared attention block after
every 3) with the reference's `init_lm(PRNGKey(0))` weights bridged in, on the
CPU:

* the config copy, the group structure, the bridge and the full-width
  shapes on the ``meta`` device;
* the SwiGLU FFN, the causal conv and the Mamba2 block at S in {1, 7, 45}
  (ragged lengths the reference scans with chunk 1), from the zero state
  and from a carried one, states included, within 1e-5 of their scale;
* prefill plus teacher-forced decode ticks, batched over slots, against the
  reference's B=1 decode vmapped over the slots, within 1e-4 with equal
  greedy tokens;
* the dense scheduler (mixed lengths, against the reference with its
  oracle and with its Pallas kernels in interpret mode) and the serial
  engine, token-identical;
* flash attention's plain version at zamba2's head_dim 112 against the
  reference's Pallas flash in interpret mode, and the kernel wrapper's
  head-dim rule (112 and 160 taken);
* the serving CLI with ``--arch zamba2-7b`` on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import flash_attention as jflash  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import hybrid as jhy  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.configs import PORTED_ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.kernels import flash_attention, ops, ref  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import ffn as tffn  # noqa: E402
from repro_torch.models import hybrid as thy  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request  # noqa: E402

ARCH = "zamba2-7b"
BLOCK_TOL = 1e-5
DECODE_ATOL = 1e-4


@pytest.fixture(scope="module")
def bundle():
    jcfg = jax_get_config(ARCH, reduced=True)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, reduced=True)
    tparams = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, (jcfg, jmodel, jparams), (build(cfg), tparams)


@pytest.fixture(scope="module")
def runtime():
    with Runtime("torchdev", device="cpu") as rt:
        yield rt


def _close(got, want, tol=BLOCK_TOL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0), err_msg=what)


# ---------------------------------------------------------------------------
# config, structure, bridge
# ---------------------------------------------------------------------------


def test_config_copy_and_group_structure_match_reference():
    assert ARCH in PORTED_ARCH_IDS
    for reduced in (False, True):
        cfg, jcfg = get_config(ARCH, reduced=reduced), jax_get_config(ARCH, reduced=reduced)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert thy.group_structure(cfg) == jhy.group_structure(jcfg)
    full = get_config(ARCH)
    assert thy.group_structure(full) == (6, 13, 3)
    assert full.resolved_head_dim == 112 and full.ssm_expand * full.d_model // full.num_heads == 224


def test_bridge_unstacks_the_mamba_layers(bundle):
    cfg, (_, _, jparams), (model, tparams) = bundle
    g, n_groups, n_tail = thy.group_structure(cfg)
    assert len(tparams["mamba"]) == n_groups * g and len(tparams["mamba_tail"]) == n_tail
    np.testing.assert_array_equal(tparams["mamba"][4]["w_xbc"].numpy(),
                                  np.asarray(jparams["mamba"]["w_xbc"][4]))
    np.testing.assert_array_equal(tparams["mamba_tail"][0]["conv_w"].numpy(),
                                  np.asarray(jparams["mamba_tail"]["conv_w"][0]))
    bridged = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu",
                              dtype=torch.bfloat16)
    own = model.init(seed=0, device="cpu", dtype=torch.bfloat16)
    fp32 = {"norm", "out_norm", "A_log", "dt_bias"}
    for got, mine in zip(bridged["mamba"] + bridged["mamba_tail"], own["mamba"] + own["mamba_tail"]):
        assert set(got) == set(mine)
        for key in got:
            assert got[key].shape == mine[key].shape, key
            want = torch.float32 if key in fp32 else torch.bfloat16
            assert got[key].dtype == mine[key].dtype == want, key
    assert set(bridged["shared_attn"]["ffn"]) == {"w_up", "w_gate", "w_down"}
    assert bridged["shared_attn"]["ln1"].dtype == torch.float32


def test_full_width_shapes_on_meta_match_reference():
    cfg = get_config(ARCH)
    meta = thy.init_lm(cfg, device="meta")
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(meta))
    abstract = jax.eval_shape(lambda: jax_build(jax_get_config(ARCH)).init(jax.random.PRNGKey(0))[0])
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(abstract))
    assert 6.5e9 < n < 7.5e9
    assert tuple(meta["mamba"][0]["w_xbc"].shape) == (3584, 7296)
    assert tuple(meta["shared_attn"]["attn"]["wq"].shape) == (3584, 32, 112)
    state = thy.init_states(cfg, 1, 1088, device="meta")
    assert tuple(state["mamba"][0]["S"].shape) == (1, 32, 64, 224)
    assert tuple(state["mamba"][0]["conv"].shape) == (1, 3, 7296)
    assert len(state["attn"]) == 13 and tuple(state["attn"][0][0].shape) == (1, 1088, 32, 112)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def test_swiglu_ffn_matches_reference(bundle):
    cfg, (jcfg, _, jparams), (_, tparams) = bundle
    x = np.random.default_rng(0).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    got = tffn.ffn(cfg, tparams["shared_attn"]["ffn"], torch.from_numpy(x))
    want = jffn.ffn(jcfg, jparams["shared_attn"]["ffn"], jnp.asarray(x))
    _close(got, want)


@pytest.mark.parametrize("state", [False, True], ids=["zero-state", "carried-state"])
@pytest.mark.parametrize("S", [1, 7, 45])
def test_mamba_block_and_conv_match_reference(bundle, S, state):
    cfg, (jcfg, _, jparams), (_, tparams) = bundle
    rng = np.random.default_rng(S + 100 * state)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    di = cfg.ssm_expand * cfg.d_model
    H = cfg.num_heads
    st = None
    if state:
        st = {"S": 0.3 * rng.standard_normal((2, H, cfg.ssm_state, di // H)).astype(np.float32),
              "conv": rng.standard_normal((2, cfg.ssm_conv_width - 1, di + 2 * cfg.ssm_state)
                                          ).astype(np.float32)}
    jp = jax.tree_util.tree_map(lambda a: a[2], jparams["mamba"])
    tp = tparams["mamba"][2]
    # the conv alone
    xbc = rng.standard_normal((2, S, di + 2 * cfg.ssm_state)).astype(np.float32)
    gy, gs = tssm._causal_conv(torch.from_numpy(xbc), tp["conv_w"], tp["conv_b"],
                               state=None if st is None else torch.from_numpy(st["conv"]))
    wy, ws = jssm._causal_conv(jnp.asarray(xbc), jp["conv_w"], jp["conv_b"],
                               state=None if st is None else jnp.asarray(st["conv"]))
    _close(gy, wy, what="conv y")
    _close(gs, ws, what="conv state")
    # the block
    got, got_st = tssm.mamba_forward(
        cfg, tp, torch.from_numpy(x),
        state=None if st is None else {k: torch.from_numpy(v) for k, v in st.items()})
    want, want_st = jssm.mamba_forward(
        jcfg, jp, jnp.asarray(x), state=None if st is None else {k: jnp.asarray(v)
                                                                for k, v in st.items()})
    _close(got, want, what="block output")
    for key in ("S", "conv"):
        _close(got_st[key], want_st[key], what=key)
    assert got_st["S"].dtype == torch.float32


def test_mamba_makes_one_scan_call_with_c_broadcast(bundle, monkeypatch):
    """One scan call a layer; q is C broadcast over the heads (a stride-0
    view of the projection, no copy)."""
    cfg, _, (_, tparams) = bundle
    seen = []
    real = ops.gated_linear_scan
    monkeypatch.setattr(ops, "gated_linear_scan",
                        lambda q, *a, **kw: seen.append(q.stride()) or real(q, *a, **kw))
    x = torch.randn((2, 5, cfg.d_model))
    tssm.mamba_forward(cfg, tparams["mamba"][0], x)
    assert len(seen) == 1 and seen[0][1] == 0


# ---------------------------------------------------------------------------
# prefill + decode carrying the mixed state
# ---------------------------------------------------------------------------


def test_prefill_and_decode_ticks_match_reference_vmapped_decode(bundle):
    cfg, (jcfg, jmodel, jparams), (model, tparams) = bundle
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (45, 12, 7)]
    steps = rng.integers(1, cfg.vocab_size, (8, len(prompts))).astype(np.int32)
    jprefill, tprefill = jmodel.make_prefill(64), model.make_prefill(64)
    jstates, tstates = [], []
    for prompt in prompts:
        jl, js = jprefill(jparams, {"tokens": jnp.asarray([prompt], jnp.int32)})
        tl, ts = tprefill(tparams, {"tokens": torch.as_tensor([prompt], dtype=torch.int32)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=DECODE_ATOL, rtol=0)
        jstates.append(js)
        tstates.append(ts)
    jstacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jstates)
    jdecode = jax.vmap(lambda s, t, p: jmodel.decode_step(jparams, s, {"tokens": t, "pos": p}))

    def cat(*leaves):
        if isinstance(leaves[0], dict):
            return {k: cat(*(x[k] for x in leaves)) for k in leaves[0]}
        if isinstance(leaves[0], (list, tuple)):
            return type(leaves[0])(cat(*xs) for xs in zip(*leaves))
        return torch.cat(leaves)

    tbatch = cat(*tstates)
    pos = np.asarray([len(p) for p in prompts], np.int32)
    for tick in steps:
        jl, jstacked = jdecode(jstacked, jnp.asarray(tick)[:, None, None], jnp.asarray(pos))
        tl, tbatch = model.decode_step(tparams, tbatch, {"tokens": torch.from_numpy(tick)[:, None],
                                                         "pos": torch.from_numpy(pos)})
        want = np.asarray(jl)[:, 0]
        np.testing.assert_allclose(tl.numpy(), want, atol=DECODE_ATOL, rtol=0)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), want.argmax(-1))
        pos = pos + 1
    g, n_groups, n_tail = thy.group_structure(cfg)
    for layer in range(n_groups * g):
        grp, i = divmod(layer, g)
        for key in ("S", "conv"):
            np.testing.assert_allclose(tbatch["mamba"][layer][key].numpy(),
                                       np.asarray(jstacked["mamba"][key])[:, grp, i, 0],
                                       atol=DECODE_ATOL, rtol=0, err_msg=f"layer {layer} {key}")
    for grp in range(n_groups):
        np.testing.assert_allclose(tbatch["attn"][grp][0].numpy(),
                                   np.asarray(jstacked["attn_k"])[:, grp, 0],
                                   atol=DECODE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

DENSE = dict(max_batch=4, max_len=64)


def _workload(vocab, n, *, seed=0, lo_p=3, hi_p=30, lo_s=2, hi_s=14):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(lo_p, hi_p))
        steps = int(rng.integers(lo_s, hi_s))
        out.append((f"h{seed}-{i}", rng.integers(1, vocab, (plen,)).tolist(), steps))
    return out


@pytest.fixture(scope="module")
def dense_port_results(bundle, runtime):
    cfg, _, (model, params) = bundle
    reqs = _workload(cfg.vocab_size, 6)
    sched = ContinuousBatchingScheduler(model, params, runtime=runtime, **DENSE)
    ops.reset_launch_counts()
    results = sched.serve([Request(*r) for r in reqs])
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel
    assert sched.active_count == 0 and sched.decoder.cache_capacity == DENSE["max_len"]
    return reqs, results


@pytest.mark.parametrize("use_pallas", [False, True], ids=["oracle", "pallas-interpret"])
def test_dense_mixed_lengths_token_identical_to_reference(bundle, dense_port_results,
                                                          use_pallas):
    _, (jcfg, jmodel, jparams), _ = bundle
    if use_pallas:
        jmodel = jax_build(jcfg.replace(use_pallas=True))
    reqs, got = dense_port_results
    want = JaxScheduler(jmodel, jparams, kv_mode="dense", **DENSE).serve(
        [JaxRequest(*r) for r in reqs])
    assert len({len(r[1]) for r in reqs}) > 1
    for rid, _, steps in reqs:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason == "length"
        assert len(got[rid].tokens) == steps


def test_serve_engine_token_identical_to_reference(bundle, runtime):
    cfg, (_, jmodel, jparams), (model, params) = bundle
    prompts = np.random.default_rng(5).integers(1, cfg.vocab_size, (3, 9)).astype(np.int32)
    got = ServeEngine(model, params, max_len=40, runtime=runtime).generate(prompts, steps=12)
    want = JaxServeEngine(jmodel, jparams, max_len=40).generate(prompts, steps=12)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.prefill_logits, np.asarray(want.prefill_logits, np.float32),
                               atol=DECODE_ATOL, rtol=0)


def test_paged_mode_refused_as_in_reference(bundle, runtime):
    _, (_, jmodel, jparams), (model, params) = bundle
    with pytest.raises(ValueError, match="no paged KV-cache path") as got:
        ContinuousBatchingScheduler(model, params, runtime=runtime, max_batch=2, max_len=32,
                                    kv_mode="paged")
    with pytest.raises(ValueError, match="no paged KV-cache path") as want:
        JaxScheduler(jmodel, jparams, max_batch=2, max_len=32, kv_mode="paged")
    assert str(got.value) == str(want.value)
    # the training slice has landed: the loss is the reference's
    tokens = np.random.default_rng(3).integers(1, model.cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    want_loss, _ = jmodel.loss(jparams, {"tokens": tokens, "labels": labels})
    got_loss, _ = model.loss(params, {"tokens": torch.from_numpy(tokens),
                                      "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)


# ---------------------------------------------------------------------------
# flash attention at head_dim 112 and 160
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,H,KV,window,dtype,tol", [
    (112, 4, 4, 0, "float32", 2e-5),
    (112, 4, 2, 32, "float32", 2e-5),
    (112, 4, 4, 0, "bfloat16", 2e-2),
    (160, 8, 2, 0, "float32", 2e-5),
], ids=["hd112", "hd112-gqa-window", "hd112-bf16", "hd160-gqa"])
def test_flash_plain_version_matches_reference_pallas_at_wide_heads(hd, H, KV, window, dtype, tol):
    rng = np.random.default_rng(hd + H + window)
    B, S = 1, 128
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32) for n in (H, KV, KV))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jflash.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=True,
                                  window=window, block_q=64, block_k=64, interpret=True)
    got = ops.attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=True,
                        window=window)  # on the CPU: the plain version the kernel is held to
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(got, ref.attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                                  causal=True, window=window), rtol=0, atol=0)


def test_flash_kernel_takes_head_dims_112_and_160():
    assert {112, 160} <= set(flash_attention.SUPPORTED_HEAD_DIMS)
    for hd in (112, 160):
        q = torch.zeros((1, 4, 4, hd), dtype=torch.bfloat16)
        assert flash_attention.variant(q, q, q) == "wgmma"  # tiles padded to 128 / 192 columns
        assert flash_attention.variant(q.float(), q.float(), q.float()) == "simt"
        with pytest.raises(ValueError, match="CUDA device"):  # the head dim passes the checks
            flash_attention.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 4, 100))
    with pytest.raises(ValueError, match="head_dim 100"):
        flash_attention.flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [[], ["--mode", "serial"]], ids=["continuous", "serial"])
def test_launch_serve_zamba2_on_cpu(capsys, argv):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                "--prompt-len", "12", "--steps", "5", "--max-batch", "2", *argv])
    out = capsys.readouterr().out
    mode = "serial" if argv else "continuous"
    assert "served 3 requests" in out and f"mode={mode}" in out
    assert set(ops.launch_counts().values()) == {0}
