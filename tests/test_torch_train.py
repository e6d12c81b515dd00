"""The port's training against the JAX reference, on the CPU.

REDUCED fp32 configs with the reference's `init_train_state(PRNGKey(0))`
weights bridged into the port (`params_from_jax`) and batches from the
numpy `SyntheticTokenStream` (the same draws in both packages):

* one AdamW step of gemma3-1b (sliding window + global, tied), minitron-8b
  (untied, SwiGLU, all global) and grok-1-314b (MoE, load-balance loss)
  against the reference's jitted `make_train_step`: loss, ce_loss,
  moe_aux, grad_norm and lr within rtol 1e-5; every gradient against
  `jax.grad` of the reference's `model.loss` within rtol 1e-4 / atol 1e-6
  (XLA and torch sum in other orders); the updated parameters within rtol
  1e-4 / atol 1e-5, the reference's own microbatch tolerance;
* microbatches=4 against 1; Adafactor and int8 error feedback against the
  reference (two steps); the reference's optimizer and compression cases;
* the data stream and its prefetcher; checkpoint save / restore, resume
  (4 steps = 2, save, restore, 2 more, within rtol 1e-6 / atol 1e-7), a
  reference checkpoint of params and AdamW state resumed in the port, the
  DataObject route; the launcher.
"""
import os

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # missing dep: property tests skip, the rest still run
    from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models.common import moe_load_balance_loss as jax_lb_loss  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.bridge import (  # noqa: E402
    opt_state_from_jax,
    params_from_jax,
    stack_params,
    unstack_layers,
    unstack_params,
)
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import compression as tcomp  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train.tree import tree_leaves, tree_map  # noqa: E402

SHAPE = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
JSHAPE = JShapeConfig("t", seq_len=32, global_batch=4, kind="train")
ARCHS = ("gemma3-1b", "minitron-8b", "grok-1-314b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pairs(port, ref, path=""):
    """(path, port leaf, reference leaf) over two trees of one structure."""
    if isinstance(port, dict):
        assert set(port) == set(ref), (path, sorted(port), sorted(ref))
        for k in port:
            yield from _pairs(port[k], ref[k], f"{path}/{k}")
    elif isinstance(port, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, port, ref


def _close(port, ref, *, rtol, atol, what=""):
    n = 0
    for path, a, b in _pairs(port, ref):
        a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=rtol, atol=atol,
                                   err_msg=f"{what}{path}")
        n += 1
    assert n > 0


def _setup(arch, opt_cfg, train_cfg=jts.TrainConfig()):
    """Reference and port models, the reference's initial state and the
    bridged port state, and the first two batches of the stream."""
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jmodel, model = jax_build(jcfg), build(cfg)
    jparams, _, jopt_state, jef = jts.init_train_state(jmodel, opt_cfg, jax.random.PRNGKey(0),
                                                       train_cfg=train_cfg)
    params = params_from_jax(cfg, _np(jparams), device="cpu")
    stream = jdata.SyntheticTokenStream(jcfg, JSHAPE)
    batches = [stream.next_batch() for _ in range(2)]
    return jcfg, cfg, jmodel, model, jparams, jopt_state, jef, params, batches


def _port_opt(opt_cfg: jopt.OptimizerConfig) -> topt.OptimizerConfig:
    import dataclasses

    return topt.OptimizerConfig(**dataclasses.asdict(opt_cfg))


#: the reference's `TestMicrobatching` optimizer (warmup over 100 steps):
#: Adam's first step is g / (|g| + eps) elementwise, so where a gradient is
#: within the two frameworks' summation noise of 0 its sign decides a whole
#: lr of update; `test_optimizer_update_matches_reference` holds the
#: optimizers' arithmetic alone at lr 1e-3 on the reference's gradients
ADAMW = jopt.OptimizerConfig(name="adamw", learning_rate=1e-3)


# ---------------------------------------------------------------------------
# one step against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_reference(arch):
    jcfg, cfg, jmodel, model, jparams, jopt_state, _, params, batches = _setup(arch, ADAMW)
    batch = batches[0]
    jstep = jax.jit(jts.make_train_step(jmodel, ADAMW, jts.TrainConfig()))
    jp1, jo1, _, jm = jstep(jparams, jopt_state, None, batch)
    jgrads = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))(jparams, batch)

    ocfg = _port_opt(ADAMW)
    seen = []
    step = tts.make_train_step(model, ocfg, tts.TrainConfig(), grads_hook=seen.append)
    p1, o1, _, m = step(params, topt.init(ocfg, params), None, batch)

    for key in ("loss", "ce_loss", "moe_aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    if cfg.is_moe:
        assert float(m["moe_aux"]) > 0
    _close(seen[0], unstack_layers(cfg, _np(jgrads)), rtol=1e-4, atol=1e-6, what="grad ")
    _close(p1, unstack_layers(cfg, _np(jp1)), rtol=1e-4, atol=1e-5, what="param ")
    _close(o1["mu"], unstack_layers(cfg, _np(jo1["mu"])), rtol=1e-4, atol=1e-6, what="mu ")
    assert int(o1["count"]) == int(jo1["count"]) == 1
    # the step is functional: the parameters it was given are unchanged
    _close(params, unstack_layers(cfg, _np(jparams)), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(name):
    """The optimizers' arithmetic alone: the reference's gradients through
    the port's `update` (clip, then the step) against the reference's, at a
    full learning rate from step 1, two steps."""
    jcfg = jax_get_config("gemma3-1b", reduced=True)
    cfg = get_config("gemma3-1b", reduced=True)
    jocfg = jopt.OptimizerConfig(name=name, learning_rate=1e-3, warmup_steps=0)
    ocfg = _port_opt(jocfg)
    jmodel = jax_build(jcfg)
    jparams, _, jstate, _ = jts.init_train_state(jmodel, jocfg, jax.random.PRNGKey(0))
    stream = jdata.SyntheticTokenStream(jcfg, JSHAPE)
    stacked = name == "adafactor"
    layout = (lambda t: stack_params(cfg, t)) if stacked else (lambda t: t)
    params = params_from_jax(cfg, _np(jparams), device="cpu")
    state = topt.init(ocfg, layout(params))
    grad_fn = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))
    for _ in range(2):
        jgrads = grad_fn(jparams, stream.next_batch())
        grads = layout(params_from_jax(cfg, _np(jgrads), device="cpu"))
        new, state, m = topt.update(ocfg, grads, state, layout(params))
        params = unstack_params(cfg, new) if stacked else new
        jparams, jstate, jm = jopt.update(jocfg, jgrads, jstate, jparams)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-6, err_msg=key)
    _close(params, unstack_layers(cfg, _np(jparams)), rtol=1e-5, atol=1e-7, what="param ")


def test_moe_load_balance_loss_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 7, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1)[..., :2].astype(np.int32)
    want = float(jax_lb_loss(jnp.asarray(probs), jnp.asarray(idx), 8))
    got = float(moe.moe_load_balance_loss(torch.from_numpy(probs), torch.from_numpy(idx), 8))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_microbatches_match_full_batch():
    """k microbatches give the full batch's update (fp32 accumulation), as
    the reference's `TestMicrobatching` holds."""
    *_, params, batches = _setup("gemma3-1b", ADAMW)
    model = build(get_config("gemma3-1b", reduced=True))
    ocfg = _port_opt(ADAMW)
    opt_state = topt.init(ocfg, params)
    p1, _, _, m1 = tts.make_train_step(model, ocfg, tts.TrainConfig(microbatches=1))(
        params, opt_state, None, batches[0])
    p4, _, _, m4 = tts.make_train_step(model, ocfg, tts.TrainConfig(microbatches=4))(
        params, opt_state, None, batches[0])
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m4["grad_norm"]), rtol=1e-4)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="split"):
        tts.make_train_step(model, ocfg, tts.TrainConfig(microbatches=3))(
            params, opt_state, None, batches[0])


@pytest.mark.parametrize("name,compression", [("adafactor", None), ("adamw", "int8_ef")])
def test_adafactor_and_int8_ef_match_reference(name, compression):
    """Two steps (Adafactor's second-moment decay starts at 0 on step 1),
    against the reference's jitted step; Adafactor's statistics in the
    reference's stacked layout."""
    jocfg = jopt.OptimizerConfig(name=name, learning_rate=1e-3)
    jtcfg = jts.TrainConfig(grad_compression=compression)
    jcfg, cfg, jmodel, model, jparams, jopt_state, jef, params, batches = _setup(
        "gemma3-1b", jocfg, jtcfg)
    jstep = jax.jit(jts.make_train_step(jmodel, jocfg, jtcfg))
    ocfg = _port_opt(jocfg)
    tcfg = tts.TrainConfig(grad_compression=compression)
    params, opt_state, ef = tts.init_train_state(model, ocfg, train_cfg=tcfg, params=params)
    step = tts.make_train_step(model, ocfg, tcfg)
    for batch in batches:
        jparams, jopt_state, jef, jm = jstep(jparams, jopt_state, jef, batch)
        params, opt_state, ef, m = step(params, opt_state, ef, batch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    _close(params, unstack_layers(cfg, _np(jparams)), rtol=1e-4, atol=1e-5, what="param ")
    if name == "adafactor":
        _close(opt_state["v"], _np(jopt_state["v"]), rtol=1e-4, atol=1e-12, what="v ")
    else:
        # the residuals, in the reference's stacked layout. A value within
        # the frameworks' summation noise of a half step of its leaf's int8
        # grid rounds the other way (its residual is the same half step with
        # the other sign) and carries that into the next step: such ties
        # differ by at most one grid step (twice the largest residual,
        # which is half a step); all else is equal
        ties = total = 0
        for path, a, b in _pairs(ef, _np(jef)):
            a, b = a.numpy(), np.asarray(b)
            off = np.abs(a - b) > 1e-6 + 1e-4 * np.abs(b)
            grid = 2 * max(np.abs(a).max(), np.abs(b).max())
            assert np.all(np.abs(a - b)[off] <= 1.01 * grid), f"ef {path}"
            ties, total = ties + int(off.sum()), total + a.size
        assert ties <= 1e-4 * total, f"{ties} of {total} residuals differ"


def test_stack_params_is_the_reference_layout():
    """`stack_params` rebuilds the reference's units / tail stacks from the
    port's per-layer list, bit for bit, and `unstack_params` undoes it."""
    jcfg = jax_get_config("gemma3-1b", reduced=True)
    cfg = get_config("gemma3-1b", reduced=True)
    jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jparams = _np(jparams)
    params = params_from_jax(cfg, jparams, device="cpu")
    stacked = stack_params(cfg, params)
    assert set(stacked) == set(jparams)
    _close(stacked, jparams, rtol=0, atol=0)
    _close(unstack_params(cfg, stacked), unstack_layers(cfg, jparams), rtol=0, atol=0)
    mcfg = get_config("minitron-8b", reduced=True)  # one homogeneous stack
    mparams = build(mcfg).init(seed=0, device="cpu")
    assert stack_params(mcfg, mparams)["layers"]["attn"]["wq"].shape[0] == mcfg.num_layers


# ---------------------------------------------------------------------------
# the reference's optimizer and compression cases, mirrored
# ---------------------------------------------------------------------------


class TestOptimizers:
    @pytest.mark.parametrize("name", ["adamw", "adafactor"])
    def test_minimizes_quadratic(self, name):
        cfg = topt.OptimizerConfig(name=name, learning_rate=0.1, warmup_steps=0,
                                   weight_decay=0.0)
        params = {"w": torch.tensor([[3.0, -2.0], [1.5, 4.0]])}
        state = topt.init(cfg, params)
        for _ in range(60):
            grads = tree_map(lambda p: 2 * p, params)  # d/dp ||p||^2
            params, state, _ = topt.update(cfg, grads, state, params)
        assert float(params["w"].abs().max()) < 0.3

    def test_warmup_schedule(self):
        cfg = topt.OptimizerConfig(name="adamw", learning_rate=1.0, warmup_steps=10)
        assert float(topt.schedule(cfg, 0)) < 0.2
        assert float(topt.schedule(cfg, 10)) == pytest.approx(1.0, rel=0.05)
        jcfg = jopt.OptimizerConfig(name="adamw", learning_rate=3e-4, warmup_steps=10,
                                    decay_steps=50)
        for step in (0, 1, 5, 10, 11, 30, 50, 80):
            np.testing.assert_allclose(float(topt.schedule(_port_opt(jcfg), step)),
                                       float(jopt.schedule(jcfg, step)), rtol=1e-6)

    def test_grad_clipping(self):
        g = {"a": torch.full((4,), 100.0)}
        clipped, norm = topt.clip_by_global_norm(g, 1.0)
        assert float(topt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)
        assert float(norm) == pytest.approx(200.0, rel=1e-4)

    def test_adafactor_state_is_factored(self):
        cfg = topt.OptimizerConfig(name="adafactor")
        state = topt.init(cfg, {"w": torch.zeros((128, 256))})
        stat_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
        assert stat_bytes < 128 * 256 * 4  # far below one full fp32 moment

    def test_weight_decay_is_decoupled(self):
        cfg = topt.OptimizerConfig(name="adamw", learning_rate=0.1, warmup_steps=0,
                                   weight_decay=0.1)
        params = {"w": torch.tensor([10.0])}
        new_params, _, _ = topt.update(cfg, {"w": torch.tensor([0.0])},
                                       topt.init(cfg, params), params)
        assert float(new_params["w"][0]) < 10.0  # decays even with zero gradient

    def test_for_arch(self):
        assert topt.for_arch(int(60e9)).name == "adafactor"
        assert topt.for_arch(int(2e9)).name == "adamw"


class TestCompression:
    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**16), scale=st.floats(1e-3, 1e3))
    def test_quantize_roundtrip_bounded_error(self, seed, scale):
        x = torch.from_numpy((np.random.default_rng(seed).normal(size=64) * scale)
                             .astype(np.float32))
        q, s = tcomp.quantize_int8(x)
        assert q.dtype == torch.int8
        err = (tcomp.dequantize_int8(q, s) - x).abs()
        assert float(err.max()) <= float(s) / 2 + 1e-6  # half-ULP of the int8 grid

    def test_error_feedback_preserves_signal_over_steps(self):
        g_true = {"w": torch.full((8,), 0.01)}
        ef = {"w": torch.zeros(8)}
        total = torch.zeros(8)
        for _ in range(50):
            g_c, ef = tcomp.compress_decompress(g_true, ef)
            total = total + g_c["w"]
        np.testing.assert_allclose(total.numpy(), 0.01 * 50, rtol=0.05)

    def test_residual_is_exact_complement_and_matches_reference(self):
        g = np.random.default_rng(3).normal(size=(4, 32)).astype(np.float32)
        e = np.random.default_rng(4).normal(size=(4, 32)).astype(np.float32) * 0.01
        g_c, ef_new = tcomp.compress_decompress({"w": [torch.from_numpy(g)]},
                                                {"w": [torch.from_numpy(e)]})
        np.testing.assert_allclose((g_c["w"][0] + ef_new["w"][0]).numpy(), g + e,
                                   rtol=1e-5, atol=1e-6)
        jg, je = jcomp.compress_decompress({"w": jnp.asarray(g)}, {"w": jnp.asarray(e)})
        np.testing.assert_allclose(g_c["w"][0].numpy(), np.asarray(jg["w"]), rtol=1e-6)
        np.testing.assert_allclose(ef_new["w"][0].numpy(), np.asarray(je["w"]), atol=1e-7)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


class TestDataPipeline:
    def test_stream_gives_the_reference_batches(self):
        cfg, jcfg = get_config("gemma3-1b", reduced=True), jax_get_config("gemma3-1b",
                                                                            reduced=True)
        for seed in (0, 5):
            mine = tdata.SyntheticTokenStream(cfg, SHAPE, state=tdata.DataState(seed, 0))
            ref = jdata.SyntheticTokenStream(jcfg, JSHAPE, state=jdata.DataState(seed, 0))
            for _ in range(3):
                a, b = mine.next_batch(), ref.next_batch()
                for key in ("tokens", "labels"):
                    assert a[key].dtype == np.int32
                    np.testing.assert_array_equal(a[key], b[key])

    def test_state_restart_continues_sequence(self):
        cfg = get_config("gemma3-1b", reduced=True)
        s1 = tdata.SyntheticTokenStream(cfg, SHAPE)
        batches = [s1.next_batch() for _ in range(3)]
        s2 = tdata.SyntheticTokenStream(cfg, SHAPE, state=tdata.DataState.from_dict(
            {"seed": s1.state.seed, "step": 2}))
        np.testing.assert_array_equal(batches[2]["tokens"], s2.next_batch()["tokens"])
        assert s1.state.to_dict() == {"seed": 0, "step": 3}

    def test_prefetch_loader_delivers_same_batches(self):
        """The Tasking-frontend prefetcher (the port's hostcpu workers and
        coroutine tasks) is a pure performance feature: the same batches,
        made ahead of time (two workers may finish them out of order)."""
        cfg = get_config("gemma3-1b", reduced=True)
        plain = tdata.SyntheticTokenStream(cfg, SHAPE)
        loader = tdata.PrefetchingLoader(tdata.SyntheticTokenStream(cfg, SHAPE), depth=2,
                                         workers=2).start()
        try:
            got = [loader.next_batch() for _ in range(4)]
        finally:
            loader.stop()
        want = [plain.next_batch() for _ in range(4)]
        assert sorted(b["tokens"].tobytes() for b in got) == sorted(
            b["tokens"].tobytes() for b in want)
        assert loader.stream.state.step == 4


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------


class TestCheckpoint:
    def _tree(self, seed=0):
        g = torch.Generator().manual_seed(seed)
        return {
            "params": {"w": torch.randn((8, 8), generator=g),
                       "layers": [{"b": torch.randn((3,), generator=g).to(torch.bfloat16)}]},
            "opt": {"m": torch.zeros((8, 8)), "count": torch.tensor(7, dtype=torch.int32)},
        }

    def _equal(self, a, b):
        for (_, x, y) in _pairs(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)

    def test_save_restore_roundtrip(self, tmp_path):
        tree = self._tree()
        path = tckpt.save(str(tmp_path), 5, tree, extra={"data": {"seed": 1, "step": 5}})
        assert path.endswith("step_00000005") and not os.path.exists(path + ".tmp")
        restored, extra = tckpt.restore(str(tmp_path))
        self._equal(restored, tree)
        assert extra == {"data": {"seed": 1, "step": 5}}

    def test_reference_restore_reads_the_port_checkpoint(self, tmp_path):
        """Same layout and key paths: the reference's `restore` reads an fp32
        checkpoint the port wrote."""
        tree = {"params": {"w": torch.arange(6.0).reshape(2, 3), "layers": [
            {"b": torch.ones(2)}]}, "opt": {"count": torch.tensor(3, dtype=torch.int32)}}
        tckpt.save(str(tmp_path), 1, tree)
        template = {"params": {"w": jnp.zeros((2, 3)), "layers": [{"b": jnp.zeros(2)}]},
                    "opt": {"count": jnp.int32(0)}}
        restored, _ = jckpt.restore(str(tmp_path), template)
        np.testing.assert_array_equal(np.asarray(restored["params"]["w"]), tree["params"]["w"])
        assert int(restored["opt"]["count"]) == 3

    def test_latest_step_ignores_uncommitted(self, tmp_path):
        tree = self._tree()
        tckpt.save(str(tmp_path), 1, tree)
        tckpt.save(str(tmp_path), 2, tree)
        os.makedirs(tmp_path / "step_00000003.tmp")
        assert tckpt.latest_step(str(tmp_path)) == 2

    def test_crash_before_commit_preserves_previous(self, tmp_path):
        tree = self._tree()
        tckpt.save(str(tmp_path), 1, tree)
        staged = tmp_path / "step_00000002.tmp"
        os.makedirs(staged)
        (staged / "shard_00000.npz").write_bytes(b"torn")
        restored, _ = tckpt.restore(str(tmp_path))
        self._equal(restored, tree)

    def test_shards_split_by_size(self, tmp_path):
        tree = self._tree()
        path = tckpt.save(str(tmp_path), 1, tree, shard_bytes=64)
        assert len([f for f in os.listdir(path) if f.startswith("shard_")]) > 1
        self._equal(tckpt.restore(str(tmp_path))[0], tree)

    def test_publish_fetch_over_localsim(self, tmp_path):
        """Distributed restore: a checkpoint's files published as DataObjects
        on one instance are fetched byte-identical on another."""
        from repro_torch.backends.localsim import LocalSimWorld
        from repro_torch.frontends.dataobject import DataObjectEngine

        tree = self._tree(seed=9)
        path = tckpt.save(str(tmp_path / "src"), 3, tree)
        box = {}

        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            engine = DataObjectEngine(cm, mm, instance_rank=rank)
            if rank == 0:
                box["ids"] = tckpt.publish_checkpoint(engine, mm, path)
                cm.exchange_global_memory_slots(1, {})
                cm.exchange_global_memory_slots(2, {})
                return "published"
            cm.exchange_global_memory_slots(1, {})
            dst = str(tmp_path / "fetched" / "step_00000003")
            tckpt.fetch_checkpoint(engine, box["ids"], dst)
            cm.exchange_global_memory_slots(2, {})
            return dst

        world = LocalSimWorld(2)
        try:
            world.launch(prog)
        finally:
            world.shutdown()
        self._equal(tckpt.restore(str(tmp_path / "fetched"))[0], tree)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_resume_reproduces_trajectory(tmp_path, optimizer):
    """4 steps, or 2 steps, a checkpoint, a restart from it and 2 more:
    the same parameters (the data stream's state rides along)."""
    cfg = get_config("gemma3-1b", reduced=True)
    model = build(cfg)
    ocfg = topt.OptimizerConfig(name=optimizer, learning_rate=1e-3)
    step = tts.make_train_step(model, ocfg)

    def run(params, opt_state, stream, n):
        for _ in range(n):
            params, opt_state, _, _ = step(params, opt_state, None, stream.next_batch())
        return params, opt_state

    params, opt_state, _ = tts.init_train_state(model, ocfg, device="cpu")
    p_cont, _ = run(params, opt_state, tdata.SyntheticTokenStream(cfg, SHAPE), 4)

    params, opt_state, _ = tts.init_train_state(model, ocfg, device="cpu")
    stream = tdata.SyntheticTokenStream(cfg, SHAPE)
    p_mid, o_mid = run(params, opt_state, stream, 2)
    tckpt.save(str(tmp_path), 2, {"params": p_mid, "opt": o_mid},
               extra={"data": stream.state.to_dict()})
    restored, extra = tckpt.restore(str(tmp_path))
    stream2 = tdata.SyntheticTokenStream(cfg, SHAPE,
                                         state=tdata.DataState.from_dict(extra["data"]))
    p_resumed, o_resumed = run(restored["params"], restored["opt"], stream2, 2)
    assert int(o_resumed["count"]) == 4
    for a, b in zip(tree_leaves(p_cont), tree_leaves(p_resumed)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains a step and checkpoints params and AdamW state;
    the port reads it (its own reader), bridges both and takes the next
    step: the reference's next step, within the one-step tolerances."""
    ocfg = jopt.OptimizerConfig(name="adamw", learning_rate=1e-3, warmup_steps=2)
    jcfg, cfg, jmodel, model, jparams, jopt_state, _, _, batches = _setup("gemma3-1b", ocfg)
    jstep = jax.jit(jts.make_train_step(jmodel, ocfg, jts.TrainConfig()))
    jparams, jopt_state, _, _ = jstep(jparams, jopt_state, None, batches[0])
    jckpt.save(str(tmp_path), 1, {"params": jparams, "opt": jopt_state},
               extra={"data": {"seed": 0, "step": 1}, "step": 1})
    jp2, jo2, _, jm = jstep(jparams, jopt_state, None, batches[1])

    restored, extra = tckpt.restore(str(tmp_path))
    params = params_from_jax(cfg, restored["params"], device="cpu")
    opt_state = opt_state_from_jax(cfg, restored["opt"], device="cpu")
    assert int(opt_state["count"]) == 1 and extra["step"] == 1
    stream = tdata.SyntheticTokenStream(cfg, SHAPE, state=tdata.DataState.from_dict(extra["data"]))
    p2, o2, _, m = tts.make_train_step(model, _port_opt(ocfg))(params, opt_state, None,
                                                             stream.next_batch())
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    _close(p2, unstack_layers(cfg, _np(jp2)), rtol=1e-4, atol=1e-5, what="param ")
    _close(o2["nu"], unstack_layers(cfg, _np(jo2["nu"])), rtol=1e-4, atol=1e-9, what="nu ")


def test_adafactor_state_bridges_in_the_reference_layout():
    ocfg = jopt.OptimizerConfig(name="adafactor")
    jcfg = jax_get_config("gemma3-1b", reduced=True)
    cfg = get_config("gemma3-1b", reduced=True)
    jparams, _, jstate, _ = jts.init_train_state(jax_build(jcfg), ocfg, jax.random.PRNGKey(0))
    state = opt_state_from_jax(cfg, _np(jstate), device="cpu")
    port = topt.init(_port_opt(ocfg), stack_params(cfg, params_from_jax(
        cfg, _np(jparams), device="cpu")))
    for (_, a, b) in _pairs(state["v"], port["v"]):
        assert a.shape == b.shape
    assert state["count"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    ckpt_dir = str(tmp_path / "run")
    argv = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu", "--batch", "4", "--seq",
            "32", "--log-every", "1", "--ckpt-dir", ckpt_dir, "--ckpt-every", "2"]
    train_cli.main(argv + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and "tok/s=" in out and "training complete" in out
    assert tckpt.latest_step(ckpt_dir) == 2
    params = train_cli.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step     3 loss=" in out
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))
