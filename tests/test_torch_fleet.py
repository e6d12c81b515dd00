"""The port's multi-instance serving fleet (`repro_torch/serve/router.py`)
against the JAX reference.

The cases of `tests/test_fleet.py` (`TestFleetServe`, `TestFaultInjection`,
`TestPrefixFleet`, `TestFleetConfigPlumbing`) run on the port: a router
instance spawns localsim worker instances, each serving the port's
scheduler on REDUCED fp32 gemma3-1b weights bridged from the reference's
`init_lm`, on a CPU `torchdev` Runtime (``device="cpu"``). Their baseline
is the **reference's** single-instance `ContinuousBatchingScheduler` on the
same weights, so a two-worker fleet, a fleet that lost a worker mid-stream
and a prefix-cache fleet are each token-identical to the JAX package. After
every drain each surviving worker's pool holds only what its prefix cache
keeps (nothing without the cache), and a killed worker's scheduler is freed
when its thread ends.

Kills are triggered from the router's `on_forward` hook when observed state
(forwarded-token counts) reaches the scenario's condition, never from a
timer, so every scenario is deterministic with respect to the client stream.
"""
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.serve.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.serve import router  # noqa: E402
from repro_torch.serve.router import FleetConfig, run_fleet  # noqa: E402
from repro_torch.serve.scheduler import Request  # noqa: E402
from repro_torch.serve.workload import synthetic_requests  # noqa: E402


@pytest.fixture(scope="module")
def bundle():
    jcfg = jax_get_config("gemma3-1b", reduced=True)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("gemma3-1b", reduced=True)
    tparams = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, (jmodel, jparams), (build(cfg), tparams)


@pytest.fixture
def schedulers(monkeypatch):
    """Every worker scheduler the fleets of one test build, held strongly
    so that their pools can be read after the drain."""
    made = []

    class Recording(router.ContinuousBatchingScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(router, "ContinuousBatchingScheduler", Recording)
    return made


def _workload(cfg, n, *, steps=(6, 14), prompts=(3, 9), seed=0):
    return synthetic_requests(cfg.vocab_size, n, prompt_range=prompts, steps_range=steps, seed=seed)


def _reference_tokens(bundle, requests, *, max_len):
    """The reference's single-instance continuous-batching tokens."""
    _, (jmodel, jparams), _ = bundle
    sched = JaxScheduler(jmodel, jparams, max_batch=4, max_len=max_len)
    jreqs = [JaxRequest(r.rid, list(r.prompt), r.max_new_tokens, r.eos_id) for r in requests]
    return {rid: fin.tokens for rid, fin in sched.serve(jreqs).items()}


def _fleet(bundle, requests, **kw):
    _, _, (model, params) = bundle
    kw.setdefault("launch_timeout", 420)
    return run_fleet(model, params, requests, device="cpu", **kw)


def _assert_pools_back(schedulers, out):
    """Every worker that ended cleanly holds no request and, in paged mode,
    no page beyond what its prefix cache keeps."""
    dead = len(out.stats["worker_errors"])
    live = [s for s in schedulers if s.active_count == 0]
    assert len(live) == len(schedulers) - dead
    for s in live:
        prog = s.active_progress()
        if s.kv_mode == "paged":
            cached = prog.prefix["cached_pages"] if prog.prefix is not None else 0
            assert prog.pages_used == cached, (prog.pages_used, cached)


def _kill_when_forwarded(at, *, mid_stream=True):
    """on_forward hook killing the worker of the first request observed at
    `at` forwarded tokens (before its terminal chunk when `mid_stream`)."""
    state = {"killed_worker": None, "victim": None}

    def hook(router_, rid, chunk):
        if state["killed_worker"] is not None or "error" in chunk:
            return
        fl = router_._flights.get(rid)
        if fl and fl.worker is not None and fl.forwarded >= at and not (mid_stream and chunk["done"]):
            state["killed_worker"] = fl.worker
            state["victim"] = rid
            router_.kill_worker(fl.worker)

    return state, hook


class TestFleetServe:
    def test_two_workers_token_identical_to_single_instance(self, bundle, schedulers):
        cfg = bundle[0]
        reqs = _workload(cfg, 8)
        ref = _reference_tokens(bundle, reqs, max_len=32)
        out = _fleet(bundle, reqs, n_workers=2, max_batch=2, max_len=32)
        assert set(out.results) == set(ref)
        for rid, expect in ref.items():
            assert out.results[rid]["tokens"] == expect, rid
            assert out.results[rid]["finish_reason"] == "length"
            assert out.results[rid]["restarted"] is False
        assert out.stats["workers_spawned"] == 2
        assert out.stats["worker_errors"] == {}
        _assert_pools_back(schedulers, out)

    def test_admissions_spread_across_workers(self, bundle):
        cfg = bundle[0]
        reqs = _workload(cfg, 8, seed=1)
        out = _fleet(bundle, reqs, n_workers=2, max_batch=2, max_len=32)
        settled = out.stats["per_worker_settled"]
        assert sum(settled.values()) == len(reqs)
        assert all(n >= 1 for n in settled.values()), settled

    def test_streamed_chunks_reassemble_in_order(self, bundle):
        cfg = bundle[0]
        reqs = _workload(cfg, 6, steps=(8, 14), seed=2)
        ref = _reference_tokens(bundle, reqs, max_len=32)
        out = _fleet(bundle, reqs, n_workers=2, max_batch=2, max_len=32, stream_interval=1)
        terminal, counts = set(), {}
        for chunk in out.chunks:
            rid = chunk["id"]
            assert rid not in terminal, "chunk after terminal chunk"
            counts[rid] = counts.get(rid, 0) + 1
            if chunk["done"]:
                terminal.add(rid)
        assert terminal == {r.rid for r in reqs}
        assert max(counts.values()) >= 3  # long requests streamed, not one-shot
        for rid, expect in ref.items():
            assert [t for c in out.chunks if c["id"] == rid for t in c["delta"]] == expect, rid

    def test_fleet_paged_kv_mode(self, bundle, schedulers):
        cfg = bundle[0]
        reqs = _workload(cfg, 4, steps=(6, 10), seed=3)
        ref = _reference_tokens(bundle, reqs, max_len=32)
        out = _fleet(bundle, reqs, n_workers=2, max_batch=2, max_len=32, kv_mode="paged",
                     page_size=16, sync_interval=2)
        for rid, expect in ref.items():
            assert out.results[rid]["tokens"] == expect, rid
        assert all(s.kv_mode == "paged" for s in schedulers) and len(schedulers) == 2
        _assert_pools_back(schedulers, out)

    def test_duplicate_rids_rejected_up_front(self, bundle):
        twins = [Request(rid="same", prompt=[1, 2, 3], max_new_tokens=2),
                 Request(rid="same", prompt=[4, 5, 6], max_new_tokens=2)]
        with pytest.raises(Exception, match="already in flight"):
            _fleet(bundle, twins, n_workers=1, max_batch=2, max_len=32, launch_timeout=240)

    def test_oversize_wire_request_settles_without_killing_fleet(self, bundle):
        cfg = bundle[0]
        good = _workload(cfg, 2, steps=(4, 6), seed=10)
        fat = Request(rid="fat-wire", prompt=[100] * 25, max_new_tokens=2)
        out = _fleet(bundle, list(good) + [fat], n_workers=2, max_batch=2, max_len=32,
                     msg_size=128)
        assert "exceeds fleet msg_size" in out.results["fat-wire"]["error"]
        for r in good:
            assert out.results[r.rid]["finish_reason"] == "length"
        assert out.stats["worker_errors"] == {}

    def test_unservable_request_settles_with_error_reply(self, bundle):
        cfg = bundle[0]
        good = _workload(cfg, 2, steps=(4, 6), seed=4)
        bad = Request(rid="too-big", prompt=[1] * 30, max_new_tokens=30)
        out = _fleet(bundle, list(good) + [bad], n_workers=2, max_batch=2, max_len=32)
        assert "cache positions" in out.results["too-big"]["error"]
        for r in good:
            assert out.results[r.rid]["finish_reason"] == "length"


class TestFaultInjection:
    def test_worker_kill_mid_stream_requeues_token_identical(self, bundle, schedulers):
        cfg = bundle[0]
        reqs = _workload(cfg, 5, steps=(16, 25), prompts=(3, 7), seed=5)
        ref = _reference_tokens(bundle, reqs, max_len=48)
        state, hook = _kill_when_forwarded(2)
        out = _fleet(bundle, reqs, n_workers=2, max_batch=2, max_len=48, stream_interval=1,
                     on_forward=hook)
        assert state["killed_worker"] is not None, "kill never triggered"
        assert out.stats["workers_killed"] == 1
        restarted = set(out.stats["restarted"])
        assert state["victim"] in restarted
        for rid, expect in ref.items():
            assert out.results[rid]["tokens"] == expect, rid
            assert out.results[rid]["restarted"] == (rid in restarted)
        terminal = {c["id"]: c for c in out.chunks if c.get("done")}
        assert terminal[state["victim"]].get("restarted") is True
        assert any("terminated with" in e for e in out.stats["worker_errors"].values())
        _assert_pools_back(schedulers, out)

    def test_restarted_stream_has_no_duplicate_or_missing_tokens(self, bundle):
        cfg = bundle[0]
        reqs = _workload(cfg, 4, steps=(18, 22), prompts=(3, 6), seed=6)
        ref = _reference_tokens(bundle, reqs, max_len=48)
        state, hook = _kill_when_forwarded(3)
        out = _fleet(bundle, reqs, n_workers=2, max_batch=2, max_len=48, stream_interval=1,
                     on_forward=hook)
        assert state["killed_worker"] is not None
        for rid in ref:
            deltas = [t for c in out.chunks if c["id"] == rid and "error" not in c
                      for t in c["delta"]]
            assert deltas == ref[rid], rid

    def test_all_workers_down_refuses_instead_of_hanging(self, bundle):
        cfg = bundle[0]
        reqs = _workload(cfg, 3, steps=(12, 16), prompts=(3, 6), seed=7)
        state = {"killed": False}

        def kill_the_only_worker(router_, rid, chunk):
            if not state["killed"] and "error" not in chunk:
                state["killed"] = True
                router_.kill_worker(0)

        out = _fleet(bundle, reqs, n_workers=1, max_batch=2, max_len=32, stream_interval=1,
                     on_forward=kill_the_only_worker)
        assert state["killed"]
        errored = [rid for rid, r in out.results.items() if "error" in r]
        assert errored, "refusal must surface as error replies"
        for rid in errored:
            assert "no live workers" in out.results[rid]["error"]
        assert set(out.results) == {r.rid for r in reqs}

    def test_respawn_from_template_completes_everything(self, bundle):
        cfg = bundle[0]
        reqs = _workload(cfg, 3, steps=(14, 18), prompts=(3, 6), seed=8)
        ref = _reference_tokens(bundle, reqs, max_len=48)
        state, hook = _kill_when_forwarded(2, mid_stream=False)
        out = _fleet(bundle, reqs, n_workers=1, max_batch=2, max_len=48, stream_interval=1,
                     respawn=True, on_forward=hook)
        assert state["killed_worker"] is not None
        assert out.stats["workers_spawned"] == 2  # original + replacement
        for rid, expect in ref.items():
            assert out.results[rid]["tokens"] == expect, rid
        assert set(out.stats["restarted"]), "kill mid-flight must requeue"

    def test_killed_worker_frees_its_scheduler_when_its_thread_ends(self, bundle, monkeypatch):
        """The world keeps a dead worker's error and, through its traceback,
        the worker's frame: the scheduler (its caches and pool) must not be
        kept with it. Watched through weak references only."""
        cfg = bundle[0]
        refs = []

        class Watched(router.ContinuousBatchingScheduler):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                refs.append(weakref.ref(self))

        monkeypatch.setattr(router, "ContinuousBatchingScheduler", Watched)
        reqs = _workload(cfg, 3, steps=(14, 18), prompts=(3, 6), seed=8)
        state, hook = _kill_when_forwarded(2)
        seen = {}

        def kill_then_look(router_, rid, chunk):
            hook(router_, rid, chunk)
            if state["killed_worker"] is not None and "freed" not in seen:
                if not router_.workers[state["killed_worker"]].alive:
                    # the router has joined the dead worker's thread
                    seen["freed"] = refs[state["killed_worker"]]() is None

        out = _fleet(bundle, reqs, n_workers=1, max_batch=2, max_len=48, stream_interval=1,
                     respawn=True, on_forward=kill_then_look)
        assert out.stats["workers_spawned"] == 2 and out.stats["worker_errors"]
        assert seen["freed"] is True, "the dead worker's scheduler is still alive"


class TestPrefixFleet:
    def test_affinity_routes_shared_head_to_one_worker(self, bundle, schedulers):
        head = [7, 7, 3, 9, 1, 2, 8, 4, 6, 6, 5, 1, 2, 3, 4, 5]  # one page
        reqs = [Request(rid=f"aff-{i}", prompt=head + [50 + i, 60 + i], max_new_tokens=4 + i)
                for i in range(3)]
        ref = _reference_tokens(bundle, reqs, max_len=48)
        out = _fleet(bundle, reqs, n_workers=2, max_batch=1, max_len=48, kv_mode="paged",
                     page_size=16, sync_interval=2, prefix_cache=True)
        for rid, expect in ref.items():
            assert out.results[rid]["tokens"] == expect, rid
        settled = out.stats["per_worker_settled"]
        assert sorted(settled.values()) == [0, 3], settled
        warm_idx = max(settled, key=settled.get)
        prefix_stats = out.stats["per_worker_prefix"][warm_idx]
        assert prefix_stats is not None and prefix_stats["hits"] >= 1
        _assert_pools_back(schedulers, out)

    def test_prefix_cache_requires_paged_kv_up_front(self):
        with pytest.raises(ValueError, match="prefix_cache requires"):
            FleetConfig(prefix_cache=True)  # default kv_mode is dense

    def test_kill_mid_stream_with_prefix_cache_token_identical(self, bundle, schedulers):
        head = [9, 8, 7, 6, 5, 4, 3, 2, 1, 2, 3, 4, 5, 6, 7, 8]
        reqs = [Request(rid=f"kp-{i}", prompt=head + [30 + 7 * i], max_new_tokens=16)
                for i in range(4)]
        ref = _reference_tokens(bundle, reqs, max_len=48)
        state, hook = _kill_when_forwarded(2)
        out = _fleet(bundle, reqs, n_workers=2, max_batch=2, max_len=48, kv_mode="paged",
                     page_size=16, sync_interval=2, prefix_cache=True, stream_interval=1,
                     on_forward=hook)
        assert state["killed_worker"] is not None, "kill never triggered"
        restarted = set(out.stats["restarted"])
        assert state["victim"] in restarted
        for rid, expect in ref.items():
            assert out.results[rid]["tokens"] == expect, rid
            assert out.results[rid]["restarted"] == (rid in restarted)
        _assert_pools_back(schedulers, out)


class TestFleetConfigPlumbing:
    def test_cfg_object_with_overrides(self, bundle):
        cfg = bundle[0]
        base = FleetConfig(n_workers=1, max_batch=2, max_len=32, device="cpu")
        reqs = _workload(cfg, 2, steps=(3, 5), seed=9)
        _, _, (model, params) = bundle
        out = run_fleet(model, params, reqs, cfg=base, n_workers=2, launch_timeout=240)
        assert out.stats["workers_spawned"] == 2
        assert len(out.results) == 2

    def test_workers_default_to_torchdev_on_the_card(self, bundle, monkeypatch):
        """Workers run `torchdev`; with no `device` they bind to the current
        CUDA device, and where there is none every worker fails instead of
        falling back to the CPU."""
        assert FleetConfig().worker_backend == "torchdev"
        assert FleetConfig().device is None
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = bundle[0]
        _, _, (model, params) = bundle
        reqs = _workload(cfg, 1, steps=(2, 3), seed=11)
        out = run_fleet(model, params, reqs, n_workers=1, max_batch=1, max_len=32,
                        launch_timeout=240)
        assert "no live workers" in out.results[reqs[0].rid]["error"]
        assert any("no CUDA device" in e for e in out.stats["worker_errors"].values())


@pytest.mark.parametrize("argv", [[], ["--kv-mode", "paged", "--prefix-cache", "--prefix-share",
                                       "0.5", "--prompt-len", "24"]], ids=["dense", "prefix"])
def test_launch_serve_fleet_on_cpu(capsys, argv):
    """`--mode fleet` on the CLI: a router and two workers serve the
    workload, the reference's default `msg_size` fits its requests, and the
    tokens equal the CLI's continuous mode on the same seed."""
    from repro_torch.launch import serve

    common = ["--reduced", "--device", "cpu", "--requests", "6", "--prompt-len", "8",
              "--steps", "8", "--max-batch", "2", *argv]
    serve.main(common + ["--mode", "fleet", "--workers", "2"])
    fleet = capsys.readouterr().out
    assert "served 6 requests" in fleet and "mode=fleet" in fleet and "workers=2" in fleet
    assert "fleet: 2 workers" in fleet and "ERROR" not in fleet
    serve.main(common)
    single = capsys.readouterr().out

    def chains(out):
        return sorted(line for line in out.splitlines()
                      if line.split(":")[0].startswith(("req-", "sp-")))

    assert chains(fleet) == chains(single) and len(chains(fleet)) == 6
    if "--prefix-cache" in argv:
        assert "prefix cache: hit_rate=" in fleet
