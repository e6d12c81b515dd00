"""One training step of every family in the port against the JAX reference,
on the CPU: the torch twin of `tests/test_arch_smoke.py`'s train step.

For every config of `ARCH_IDS`, REDUCED (fp32): the reference's
`init_train_state(PRNGKey(0))` weights bridged into the port
(`params_from_jax`), one batch of the reference's `model.make_batch` (patches
for the VLM, frames for the audio model), one AdamW step through the port's
`make_train_step` against the reference's jitted step, with
`tests/test_torch_train.py`'s tolerances: loss, ce_loss, moe_aux, grad_norm
and lr within rtol 1e-5; every gradient against `jax.grad` of the
reference's `model.loss` within rtol 1e-4 / atol 1e-6; the updated
parameters within rtol 1e-4 / atol 1e-5. One exception, zamba2's
gradients: there the reference's own jitted and eager `jax.grad` differ by
more than rtol 1e-4 / atol 1e-6 (the gradient of the chunked scan's log
decay cancels large terms in fp32; 3.6e-5 of each leaf's largest value at
this shape), which the test asserts, and the port is held to max |d| / max
|ref| <= 1e-4 per leaf instead. The batch is `tests/test_arch_smoke.py`'s
train shape (B=2, S=64) and key. Then the port alone: the three
`remat_policy` values give the same gradients, `make_batch` draws the
reference's shapes and `param_count` counts the reference's parameters.

Every family's tree stacks into the reference's layout (`stack_params`),
so Adafactor and int8 error feedback step on all of them: two steps of
zamba2 and whisper with each equal the reference's (Adafactor's statistics
and the residuals compared in that layout). With int8 compression on
zamba2, whose reference gradient is noisy (above), a value within that
noise of a half step of its leaf's int8 grid rounds the other way: such
ties are allowed in at most twice that noise over a grid step (2.54e-2)
of the residuals and 1e-4 of the parameters, each parameter off by at most
the learning rates' sum; the other residuals
are held within the gradient's noise (1e-4 of the leaf's largest value),
and Adafactor's statistics, squared gradients, per leaf to 2e-4 of its
largest value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models.model_zoo import param_count as jax_param_count  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import ARCH_IDS, ShapeConfig, get_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.models.model_zoo import param_count  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train.tree import tree_leaves, tree_unflatten  # noqa: E402

SHAPE = ShapeConfig("t", seq_len=64, global_batch=2, kind="train")
JSHAPE = JShapeConfig("t", seq_len=64, global_batch=2, kind="train")
#: the reference's `TestMicrobatching` AdamW, as `tests/test_torch_train.py`
ADAMW = jopt.OptimizerConfig(name="adamw", learning_rate=1e-3)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
#: families whose reference gradient is not reproducible within GRAD_TOL
#: by the reference itself (jitted against eager), see the module note
NOISY_REFERENCE = ("hybrid",)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pairs(port, ref, path=""):
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
        np.testing.assert_allclose(a.detach().float().numpy(), b.detach().float().numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"{what}{path}")
        n += 1
    assert n > 0


@pytest.fixture(scope="module", params=ARCH_IDS)
def step(request):
    """The reference's step and gradient on its `make_batch` batch, and the
    same step in the port from the bridged weights."""
    arch = request.param
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch, reduced=True)
    jmodel, model = jax_build(jcfg), build(cfg)
    jparams, _, jopt_state, _ = jts.init_train_state(jmodel, ADAMW, jax.random.PRNGKey(0))
    batch = _np(jmodel.make_batch(jax.random.PRNGKey(2), JSHAPE))
    jp1, _, _, jm = jax.jit(jts.make_train_step(jmodel, ADAMW, jts.TrainConfig()))(
        jparams, jopt_state, None, batch)
    loss_fn = lambda p, b: jmodel.loss(p, b)[0]  # noqa: E731
    jgrads = jax.jit(jax.grad(loss_fn))(jparams, batch)
    eager = _np(jax.grad(loss_fn)(jparams, batch)) if cfg.family in NOISY_REFERENCE else None

    params = params_from_jax(cfg, _np(jparams), device="cpu")
    ocfg = topt.OptimizerConfig(name="adamw", learning_rate=1e-3)
    seen = []
    p1, o1, _, m = tts.make_train_step(model, ocfg, grads_hook=seen.append)(
        params, topt.init(ocfg, params), None, batch)
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, model=model, jmodel=jmodel, jparams=jparams,
                params=params, batch=batch, want=(_np(jp1), jm, _np(jgrads)), eager=eager,
                got=(p1, o1, m, seen[0]))


def test_one_adamw_step_matches_reference(step):
    cfg = step["cfg"]
    jp1, jm, jgrads = step["want"]
    p1, o1, m, grads = step["got"]
    for key in ("loss", "ce_loss", "moe_aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                   err_msg=f"{step['arch']} {key}")
    bridge = lambda t: params_from_jax(cfg, t, device="cpu")  # noqa: E731
    if cfg.family in NOISY_REFERENCE:
        # the premise: the reference's eager gradient misses its jitted one
        # by more than GRAD_TOL; the port is held to the leaves' scale
        with pytest.raises(AssertionError):
            _close(bridge(step["eager"]), bridge(jgrads), **GRAD_TOL)
        for path, a, b in _pairs(grads, bridge(jgrads)):
            err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            assert err <= GRAD_TOL["rtol"], f"{step['arch']} grad {path}: {err:.2e}"
    else:
        _close(grads, bridge(jgrads), **GRAD_TOL, what=f"{step['arch']} grad ")
    _close(p1, bridge(jp1), rtol=1e-4, atol=1e-5, what=f"{step['arch']} param ")
    assert int(o1["count"]) == 1
    for leaf in tree_leaves(p1):
        assert bool(torch.isfinite(leaf).all())


def _grads(cfg, params, batch):
    model = build(cfg)
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    batch = tts.batch_to(batch, "cpu")
    loss, _ = model.loss(tree_unflatten(params, live), batch)
    return torch.autograd.grad(loss, live)


@pytest.mark.parametrize("policy", ["minimal", "full"])
def test_remat_policies_give_the_same_gradients(step, policy):
    """`remat_policy` recomputes, it does not change a number: the
    gradients under "minimal" and "full" equal those under "none"."""
    cfg = step["cfg"]
    want = _grads(cfg.replace(remat_policy="none"), step["params"], step["batch"])
    got = _grads(cfg.replace(remat_policy=policy), step["params"], step["batch"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_make_batch_draws_the_reference_shapes(step):
    """The port's `make_batch` gives the reference's keys, shapes and
    dtypes (its numbers are torch's draws), on the generator's device."""
    cfg, jmodel, model = step["cfg"], step["jmodel"], step["model"]
    for kind in ("train", "prefill", "decode"):
        want = _np(jmodel.make_batch(jax.random.PRNGKey(3), JShapeConfig("s", 40, 3, kind)))
        got = model.make_batch(torch.Generator().manual_seed(3), ShapeConfig("s", 40, 3, kind))
        assert set(got) == set(want), kind
        for key, w in want.items():
            g = got[key]
            assert tuple(g.shape) == w.shape, (kind, key)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (kind, key)
            assert g.device.type == "cpu"
        if "tokens" in got:
            assert 0 <= int(got["tokens"].min()) and int(got["tokens"].max()) < cfg.vocab_size
    if cfg.family == "audio":
        frames = model.make_batch(7, SHAPE, device="cpu")["frames"]
        assert 0.015 < float(frames.std()) < 0.025  # standard normal x 0.02


def test_param_count_matches_reference(step):
    assert param_count(step["params"]) == jax_param_count(step["jparams"])



@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stack_params_is_the_reference_layout(arch):
    """`stack_params` rebuilds every family's reference stacks from the
    port's per-layer lists bit for bit (the hybrid's Mamba2 stacks, the
    encoder-decoder's encoder and decoder stacks too), and `unstack_params`
    undoes it: Adafactor and int8 compression step on every family."""
    from repro_torch.models.bridge import stack_params, unstack_params

    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch, reduced=True)
    jparams = _np(jax_build(jcfg).init(jax.random.PRNGKey(0))[0])
    params = params_from_jax(cfg, jparams, device="cpu")
    stacked = stack_params(cfg, params)
    got = dict(jax.tree_util.tree_flatten_with_path(stacked)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert set(map(jax.tree_util.keystr, got)) == set(map(jax.tree_util.keystr, want))
    by_key = {jax.tree_util.keystr(k): v for k, v in want.items()}
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), by_key[jax.tree_util.keystr(k)], err_msg=str(k))
    back = unstack_params(cfg, stacked)
    assert len(tree_leaves(back)) == len(tree_leaves(params))
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-small"])
@pytest.mark.parametrize("name,compression", [("adafactor", None), ("adamw", "int8_ef")],
                         ids=["adafactor", "int8_ef"])
def test_adafactor_and_int8_ef_match_reference(arch, name, compression):
    """Two steps of the hybrid and the encoder-decoder with Adafactor and
    with int8 error feedback against the reference's jitted step, on its
    `make_batch` batches, with `tests/test_torch_train.py`'s tolerances;
    Adafactor's statistics and the residuals in the reference's stacked
    layout."""
    import dataclasses

    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch, reduced=True)
    jmodel, model = jax_build(jcfg), build(cfg)
    jocfg = jopt.OptimizerConfig(name=name, learning_rate=1e-3)
    jtcfg = jts.TrainConfig(grad_compression=compression)
    jparams, _, jopt_state, jef = jts.init_train_state(jmodel, jocfg, jax.random.PRNGKey(0),
                                                       train_cfg=jtcfg)
    batches = [_np(jmodel.make_batch(jax.random.PRNGKey(k), JSHAPE)) for k in (2, 3)]
    jstep = jax.jit(jts.make_train_step(jmodel, jocfg, jtcfg))
    ocfg = topt.OptimizerConfig(**dataclasses.asdict(jocfg))
    tcfg = tts.TrainConfig(grad_compression=compression)
    params, opt_state, ef = tts.init_train_state(
        model, ocfg, train_cfg=tcfg, params=params_from_jax(cfg, _np(jparams), device="cpu"))
    step = tts.make_train_step(model, ocfg, tcfg)
    for batch in batches:
        jparams, jopt_state, jef, jm = jstep(jparams, jopt_state, jef, batch)
        params, opt_state, ef, m = step(params, opt_state, ef, batch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=f"{arch} {key}")
    want = params_from_jax(cfg, _np(jparams), device="cpu")
    if compression and cfg.family in NOISY_REFERENCE:
        # a gradient within the reference's own noise of a half step of its
        # leaf's int8 grid rounds the other way (the residual ties below);
        # Adam then moves that element by up to a learning rate a step
        lr_sum = sum(float(topt.schedule(ocfg, s)) for s in (1, 2))
        off = total = 0
        for path, a, b in _pairs(params, want):
            d = (a - b).abs()
            bad = d > 1e-5 + 1e-4 * b.abs()
            assert float(d.max()) <= 1.01 * lr_sum * (1 + ocfg.weight_decay), f"param {path}"
            off, total = off + int(bad.sum()), total + a.numel()
        assert off <= 1e-4 * total, f"{off} of {total} parameters differ"
    else:
        _close(params, want, rtol=1e-4, atol=1e-5, what=f"{arch} param ")
    stacked_ref = lambda t: tree_map_np(t)  # noqa: E731  (the reference's stacked layout)
    noisy = cfg.family in NOISY_REFERENCE
    if name == "adafactor" and noisy:
        # the statistics are squared gradients: twice the gradients' noise
        for path, a, b in _pairs(opt_state["v"], stacked_ref(jopt_state["v"])):
            err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            assert err <= 2 * GRAD_TOL["rtol"], f"{arch} v {path}: {err:.2e}"
    elif name == "adafactor":
        _close(opt_state["v"], stacked_ref(jopt_state["v"]), rtol=1e-4, atol=1e-12,
               what=f"{arch} v ")
    else:
        ties = total = 0
        for path, a, b in _pairs(ef, stacked_ref(jef)):
            a, b = a.numpy(), b.numpy()
            grid = 2 * max(np.abs(a).max(), np.abs(b).max())
            # a residual moves with its gradient: by the gradient's noise
            # (1e-4 of the leaf's largest value, 127 grid steps) where that
            # is noisy
            slack = GRAD_TOL["rtol"] * 127 * grid if noisy else 0.0
            off = np.abs(a - b) > 1e-6 + 1e-4 * np.abs(b) + slack
            assert np.all(np.abs(a - b)[off] <= 1.01 * grid), f"ef {path}"
            ties, total = ties + int(off.sum()), total + a.size
        # ties: under a noisy gradient, a value within the noise of a
        # grid boundary (a share of at most twice the noise over the step)
        share = 2 * GRAD_TOL["rtol"] * 127 if noisy else 1e-4
        assert ties <= share * total, f"{ties} of {total} residuals differ"


def tree_map_np(tree):
    """A reference tree (its stacked layout) as CPU tensors, as it is."""
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
