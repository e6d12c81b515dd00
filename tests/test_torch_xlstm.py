"""The port's xlstm-125m against the JAX reference through the weight bridge.

REDUCED xlstm-125m in fp32 (3 mLSTM blocks and 1 sLSTM block) with the
reference's `init_lm(PRNGKey(0))` weights bridged into the port, on the CPU:

* the stateless forward and `ModelBundle.loss` against the reference with
  its Pallas scan (interpret mode) and with its oracle: the loss within 1e-5,
  the logits within 1e-5 of their scale (XLA and torch sum the projections
  and the scan's products in different orders);
* prefill from zero states plus teacher-forced decode ticks carrying the
  states, batched over slots, against the reference's B=1 decode vmapped
  over the slots (its `SlotDecoder` form), within 1e-4 with equal greedy
  tokens;
* `ContinuousBatchingScheduler(kv_mode="dense")` (mixed lengths, admission
  mid-decode) and `ServeEngine.generate` token-identical to the reference;
* the paged mode refused with the reference's message, and the serving CLI
  on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.runtime import Runtime as JaxRuntime  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm_model as jxm  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.backends import hostcpu  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import xlstm_model as txm  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request  # noqa: E402

ARCH = "xlstm-125m"
LOSS_TOL = 1e-5
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


def _workload(vocab, n, *, seed=0, lo_p=3, hi_p=12, lo_s=2, hi_s=14):
    """`tests/test_serve.py::_workload`: (rid, prompt, max_new_tokens)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(lo_p, hi_p))
        steps = int(rng.integers(lo_s, hi_s))
        prompt = rng.integers(1, vocab, (plen,)).tolist()
        out.append((f"r{seed}-{i}", prompt, steps))
    return out


# ---------------------------------------------------------------------------
# config, structure, bridge
# ---------------------------------------------------------------------------


def test_config_and_block_structure_match_reference():
    for reduced in (False, True):
        cfg, jcfg = get_config(ARCH, reduced=reduced), jax_get_config(ARCH, reduced=reduced)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert txm.block_kinds(cfg) == jxm.block_kinds(jcfg)
    kinds = txm.block_kinds(get_config(ARCH))
    assert [i for i, k in enumerate(kinds) if k == "slstm"] == [3, 7, 11]
    full = get_config(ARCH)
    assert full.ssm_expand * full.d_model // full.num_heads == 384  # mLSTM head_dim


def test_bridge_keeps_the_tree_and_norms_in_fp32(bundle):
    cfg, (_, _, jparams), (model, tparams) = bundle
    own = model.init(seed=0, device="cpu")
    bridged = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu",
                              dtype=torch.bfloat16)
    assert len(bridged["blocks"]) == len(own["blocks"]) == cfg.num_layers
    for got, mine, ref in zip(bridged["blocks"], own["blocks"], jparams["blocks"]):
        assert set(got) == set(mine) == set(ref)
        for key in got:
            assert tuple(got[key].shape) == tuple(mine[key].shape) == tuple(ref[key].shape)
            want = torch.float32 if key == "norm" else torch.bfloat16
            assert got[key].dtype == want, key
    assert bridged["final_norm"].dtype == torch.float32
    assert set(bridged["embed"]) == {"embedding", "unembed"}  # untied
    np.testing.assert_array_equal(tparams["blocks"][0]["w_qkv"].numpy(),
                                  np.asarray(jparams["blocks"][0]["w_qkv"]))


def test_init_is_seeded_and_on_the_device_asked():
    cfg = get_config(ARCH, reduced=True)
    a = txm.init_lm(cfg, seed=3, device="cpu")
    b = txm.init_lm(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    torch.testing.assert_close(a["blocks"][0]["w_qkv"].to(torch.bfloat16),
                               b["blocks"][0]["w_qkv"], rtol=0, atol=0)
    assert b["blocks"][0]["norm"].dtype == torch.float32
    assert float(a["blocks"][0]["b_gates"].min()) == 1.0  # forget/input gate bias
    meta = txm.init_lm(get_config(ARCH), device="meta")
    assert tuple(meta["blocks"][0]["w_qkv"].shape) == (768, 3 * 1536)
    assert tuple(meta["blocks"][3]["w_rec"].shape) == (768, 4 * 768)


# ---------------------------------------------------------------------------
# stateless forward and loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True], ids=["oracle", "pallas-interpret"])
def test_forward_and_loss_match_reference(bundle, use_pallas):
    cfg, (jcfg, jmodel, jparams), (model, tparams) = bundle
    if use_pallas:
        jcfg = jcfg.replace(use_pallas=True)
        jmodel = jax_build(jcfg)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    want_logits, _ = jxm.lm_forward(jcfg, jparams, jnp.asarray(tokens))
    want_loss, want_metrics = jmodel.loss(jparams, {"tokens": jnp.asarray(tokens),
                                                    "labels": jnp.asarray(labels)})
    ops.reset_launch_counts()
    logits, aux = txm.lm_forward(cfg, tparams, torch.from_numpy(tokens))
    loss, metrics = model.loss(tparams, {"tokens": torch.from_numpy(tokens),
                                         "labels": torch.from_numpy(labels)})
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel
    assert logits.dtype == torch.float32 and logits.shape == (2, 64, cfg.vocab_size)
    want = np.asarray(want_logits)
    np.testing.assert_allclose(logits.numpy(), want, rtol=LOSS_TOL,
                               atol=LOSS_TOL * np.abs(want).max())
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(float(metrics["ce_loss"]), float(want_metrics["ce_loss"]),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    assert float(aux) == 0.0 and float(metrics["moe_aux"]) == 0.0


@pytest.mark.parametrize("S,state", [(64, False), (45, True), (1, True)],
                         ids=["forward", "prefill-carried-state", "decode-step"])
def test_mlstm_block_one_scan_call_matches_reference(bundle, monkeypatch, S, state):
    """The port's mLSTM block makes one scan call (y and the normaliser
    together) where the reference makes two; block output and both states
    equal the reference block's."""
    cfg, (jcfg, _, jparams), (_, tparams) = bundle
    i = txm.block_kinds(cfg).index("mlstm")
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    hd = cfg.ssm_expand * cfg.d_model // cfg.num_heads
    st = None
    if state:
        st = {"S": 0.1 * rng.standard_normal((2, cfg.num_heads, hd, hd)).astype(np.float32),
              "n": rng.standard_normal((2, cfg.num_heads, hd, 1)).astype(np.float32)}
    calls = []
    real = ops.gated_linear_scan
    monkeypatch.setattr(ops, "gated_linear_scan",
                        lambda *a, **kw: calls.append(kw.get("normaliser")) or real(*a, **kw))
    got, got_st = tssm.mlstm_forward(cfg, tparams["blocks"][i], torch.from_numpy(x),
                                     state=None if st is None else
                                     {k: torch.from_numpy(v) for k, v in st.items()})
    assert calls == [True]
    want, want_st = jssm.mlstm_forward(jcfg, jparams["blocks"][i], jnp.asarray(x),
                                       state=None if st is None else
                                       {k: jnp.asarray(v) for k, v in st.items()})
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_TOL,
                               atol=LOSS_TOL * np.abs(want).max())
    for key in ("S", "n"):
        w = np.asarray(want_st[key])
        np.testing.assert_allclose(got_st[key].numpy(), w, rtol=LOSS_TOL,
                                   atol=LOSS_TOL * max(np.abs(w).max(), 1.0))


def test_bare_runtime_builds_the_hostcpu_managers_as_the_reference():
    """`Runtime()` names the reference's default backend, `hostcpu`; the
    port's serving entry points name `torchdev` themselves."""
    with Runtime() as rt, JaxRuntime() as jrt:
        assert rt.backend == jrt.backend == "hostcpu"
        assert isinstance(rt.compute_manager, hostcpu.HostComputeManager)
        assert isinstance(rt.memory_manager, hostcpu.HostMemoryManager)
        assert isinstance(rt.communication_manager, hostcpu.HostCommunicationManager)
        assert isinstance(rt.instance_manager, hostcpu.HostInstanceManager)
        assert isinstance(rt.managers.topology_managers[0], hostcpu.HostTopologyManager)
        assert type(rt.compute_manager).__name__ == type(jrt.compute_manager).__name__


def test_transformer_loss_is_not_ported_yet():
    model = build(get_config("gemma3-1b", reduced=True))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        model.loss({}, {})


# ---------------------------------------------------------------------------
# prefill + decode carrying the recurrent states
# ---------------------------------------------------------------------------


def test_prefill_and_decode_ticks_match_reference_vmapped_decode(bundle):
    cfg, (jcfg, jmodel, jparams), (model, tparams) = bundle
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (45, 12, 3)]
    steps = rng.integers(1, cfg.vocab_size, (8, len(prompts))).astype(np.int32)

    jprefill = jmodel.make_prefill(64)
    jstates, tstates, logits = [], [], []
    tprefill = model.make_prefill(64)
    for prompt in prompts:
        jl, js = jprefill(jparams, {"tokens": jnp.asarray([prompt], jnp.int32)})
        tl, ts = tprefill(tparams, {"tokens": torch.as_tensor([prompt], dtype=torch.int32)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=DECODE_ATOL, rtol=0)
        jstates.append(js)
        tstates.append(ts)
    # reference: B=1 states stacked on a slot axis, decode vmapped over it
    jstacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jstates)

    def one(state, tok, pos):
        return jmodel.decode_step(jparams, state, {"tokens": tok, "pos": pos})

    jdecode = jax.vmap(one)
    # port: the slots are the batch
    tbatch = [{k: torch.cat([st[i][k] for st in tstates]) for k in tstates[0][i]}
              for i in range(cfg.num_layers)]
    pos = np.asarray([len(p) for p in prompts], np.int32)
    for tick in steps:
        jl, jstacked = jdecode(jstacked, jnp.asarray(tick)[:, None, None], jnp.asarray(pos))
        tl, tbatch = model.decode_step(tparams, tbatch, {"tokens": torch.from_numpy(tick)[:, None],
                                                         "pos": torch.from_numpy(pos)})
        want = np.asarray(jl)[:, 0]
        np.testing.assert_allclose(tl.numpy(), want, atol=DECODE_ATOL, rtol=0)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), want.argmax(-1))
        pos = pos + 1
    for i, (tst, jst) in enumerate(zip(tbatch, jstacked)):
        for key in tst:
            np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key])[:, 0],
                                       atol=DECODE_ATOL, rtol=0, err_msg=f"block {i} {key}")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

DENSE = dict(max_batch=4, max_len=64)


@pytest.fixture(scope="module")
def dense_port_results(bundle, runtime):
    cfg, _, (model, params) = bundle
    reqs = _workload(cfg.vocab_size, 6)
    sched = ContinuousBatchingScheduler(model, params, runtime=runtime, **DENSE)
    assert sched.kv_mode == "dense"
    ops.reset_launch_counts()
    results = sched.serve([Request(*r) for r in reqs])
    assert set(ops.launch_counts().values()) == {0}
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


def _drive_admission_mid_decode(sched, make_request, vocab):
    """Two requests decode one tick, a third joins the running batch."""
    early = [make_request(*r) for r in _workload(vocab, 2, seed=1, lo_s=8, hi_s=9)]
    late = make_request(*_workload(vocab, 1, seed=2, lo_s=4, hi_s=5)[0])
    trace = [sched.try_admit(r) for r in early]
    results = {fin.rid: fin.tokens for fin in sched.step()}
    trace += [sched.try_admit(late), sched.active_count]
    while len(results) < 3:
        for fin in sched.step():
            results[fin.rid] = fin.tokens
    return trace, results


def test_dense_admission_mid_decode_token_identical_to_reference(bundle, runtime):
    cfg, (_, jmodel, jparams), (model, params) = bundle
    trace, got = _drive_admission_mid_decode(
        ContinuousBatchingScheduler(model, params, runtime=runtime, **DENSE), Request,
        cfg.vocab_size)
    ref_trace, want = _drive_admission_mid_decode(
        JaxScheduler(jmodel, jparams, kv_mode="dense", **DENSE), JaxRequest, cfg.vocab_size)
    assert trace == ref_trace == [True, True, True, 3]
    assert got == want


def test_serve_engine_token_identical_to_reference(bundle, runtime):
    cfg, (_, jmodel, jparams), (model, params) = bundle
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, cfg.vocab_size, (3, 9)).astype(np.int32)
    port = ServeEngine(model, params, max_len=40, runtime=runtime)
    got = port.generate(prompts, steps=12)
    want = JaxServeEngine(jmodel, jparams, max_len=40).generate(prompts, steps=12)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.prefill_logits, np.asarray(want.prefill_logits, np.float32),
                               atol=DECODE_ATOL, rtol=0)
    # batching leaks nothing across rows; the serial chain equals the scheduler's
    solo = port.generate(prompts[1:2], steps=12).tokens[0]
    np.testing.assert_array_equal(got.tokens[1], solo)
    sched = ContinuousBatchingScheduler(model, params, runtime=runtime, max_batch=2, max_len=40)
    assert sched.serve([Request("s", prompts[1].tolist(), 12)])["s"].tokens == solo.tolist()


def test_paged_mode_refused_as_in_reference(bundle, runtime):
    _, (_, jmodel, jparams), (model, params) = bundle
    with pytest.raises(ValueError, match="no paged KV-cache path") as got:
        ContinuousBatchingScheduler(model, params, runtime=runtime, max_batch=2, max_len=32,
                                    kv_mode="paged")
    with pytest.raises(ValueError, match="no paged KV-cache path") as want:
        JaxScheduler(jmodel, jparams, max_batch=2, max_len=32, kv_mode="paged")
    assert str(got.value) == str(want.value)


def test_runtime_run_keeps_no_result_alive(runtime):
    """Each xlstm tick returns fresh recurrent states; `Runtime.run` must not
    keep them alive in its list of in-flight futures (it held 64 ticks of
    slot states before)."""
    import weakref

    unit = runtime.create_execution_unit(lambda: torch.zeros(4), name="fresh")
    out = runtime.run(unit)
    alive = weakref.ref(out)
    del out
    runtime.run(unit)  # the processing unit keeps its current state only
    assert alive() is None
    fut = runtime.submit(unit)  # submit() still tracks its future for drive()
    assert runtime.drive(timeout=5) and fut.result().shape == (4,)


@pytest.mark.parametrize("argv", [[], ["--mode", "serial"]], ids=["continuous", "serial"])
def test_launch_serve_xlstm_on_cpu(capsys, argv):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                "--prompt-len", "12", "--steps", "5", "--max-batch", "2", *argv])
    out = capsys.readouterr().out
    mode = "serial" if argv else "continuous"
    assert "served 3 requests" in out and f"mode={mode}" in out
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel
    with pytest.raises(ValueError, match="no paged KV-cache path"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--kv-mode", "paged",
                    "--requests", "1", "--prompt-len", "4", "--steps", "2"])
