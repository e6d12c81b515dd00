"""The port's channel front door (`repro_torch/serve/server.py`) against the
JAX reference.

The cases of `tests/test_serve.py`'s `TestChannelServer`,
`TestServeIngestDiscipline` and `TestStreamingReplies` run on the port's
`ChannelServer` over the port's scheduler and localsim fabric, on REDUCED
fp32 gemma3-1b weights bridged from the reference's `init_lm` (CPU
`torchdev` Runtime). Where a case decodes, its tokens equal the reference
scheduler's on the same weights; the wire body of `workload.to_wire` equals
the reference's.
"""
import json
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.serve.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro.serve.workload import to_wire as jax_to_wire  # noqa: E402
from repro_torch.backends.localsim import LocalSimWorld  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.frontends.channels import (  # noqa: E402
    ChannelMessageTooLargeError,
    MPSCNonLockingConsumer,
    MPSCNonLockingProducer,
    SPSCConsumer,
    SPSCProducer,
)
from repro_torch.models import build  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler,
    FinishedRequest,
    Request,
)
from repro_torch.serve.server import ChannelServer  # noqa: E402
from repro_torch.serve.workload import synthetic_requests, to_wire  # noqa: E402


@pytest.fixture(scope="module")
def bundle():
    jcfg = jax_get_config("gemma3-1b", reduced=True)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("gemma3-1b", reduced=True)
    tparams = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, (jmodel, jparams), (build(cfg), tparams)


@pytest.fixture(scope="module")
def runtime():
    with Runtime("torchdev", device="cpu") as rt:
        yield rt


def _sched(bundle, runtime, **kw):
    _, _, (model, params) = bundle
    return ContinuousBatchingScheduler(model, params, runtime=runtime, **kw)


def _reference_tokens(bundle, bodies, *, max_len=32):
    _, (jmodel, jparams), _ = bundle
    sched = JaxScheduler(jmodel, jparams, max_batch=4, max_len=max_len)
    reqs = [JaxRequest(b["id"], b["prompt"], b["steps"]) for b in bodies]
    return {rid: fin.tokens for rid, fin in sched.serve(reqs).items()}


class FakeConsumer:
    def __init__(self, msgs):
        self.msgs = deque(msgs)

    def try_pop(self):
        return self.msgs.popleft() if self.msgs else None


class FakeReply:
    def __init__(self):
        self.out = []

    def push(self, data):
        self.out.append(json.loads(bytes(data).rstrip(b"\0").decode()))


def _wire(body, size=256):
    return json.dumps(body).encode().ljust(size, b"\0")


class TestChannelServer:
    def test_requests_over_mpsc_channel_continuous(self, bundle, runtime):
        """Two producer instances send 2 requests each over an MPSC channel;
        one server instance decodes them as one continuously batched stream
        and replies per request: the reference's tokens."""
        MSG, PER_CLIENT = 512, 2
        bodies = {rank: [{"id": f"c{rank}-{j}", "prompt": [1 + rank, 2, 3, 4 + j], "steps": 3 + j}
                         for j in range(PER_CLIENT)] for rank in (1, 2)}

        def prog(mgrs, rank):
            # slot exchange is collective: every instance joins tags 1, 10, 11 in order
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            if rank == 0:
                req_cons = MPSCNonLockingConsumer(cm, mm, tag=1, capacity=4, msg_size=MSG,
                                                  n_producers=2)
                rep_prods = {"c1": SPSCProducer(cm, mm, tag=10, capacity=4, msg_size=MSG),
                             "c2": SPSCProducer(cm, mm, tag=11, capacity=4, msg_size=MSG)}

                class Router:
                    def push(self, msg):
                        rep = json.loads(bytes(msg).rstrip(b"\0").decode())
                        rep_prods[rep["id"].split("-")[0]].push(msg)

                server = ChannelServer(_sched(bundle, runtime, max_batch=4, max_len=32),
                                       req_cons, Router(), msg_size=MSG)
                server.serve(n_requests=2 * PER_CLIENT)
                return "served"
            prod = MPSCNonLockingProducer(cm, mm, tag=1, capacity=4, msg_size=MSG,
                                          producer_index=rank - 1)
            if rank == 1:
                rep_cons = SPSCConsumer(cm, mm, tag=10, capacity=4, msg_size=MSG)
                cm.exchange_global_memory_slots(11, {})
            else:
                cm.exchange_global_memory_slots(10, {})
                rep_cons = SPSCConsumer(cm, mm, tag=11, capacity=4, msg_size=MSG)
            for body in bodies[rank]:
                prod.push(json.dumps(body).encode().ljust(MSG, b"\0"))
            got = {}
            while len(got) < PER_CLIENT:
                rep = json.loads(rep_cons.pop(timeout=240).rstrip(b"\0").decode())
                got[rep["id"]] = rep["tokens"]
            return got

        w = LocalSimWorld(3)
        try:
            results = w.launch(prog, timeout=300)
        finally:
            w.shutdown()
        assert results[0] == "served"
        ref = _reference_tokens(bundle, bodies[1] + bodies[2])
        for rank in (1, 2):
            assert results[rank] == {b["id"]: ref[b["id"]] for b in bodies[rank]}

    def test_oversized_reply_raises(self, bundle, runtime):
        server = ChannelServer(_sched(bundle, runtime, max_batch=2, max_len=64),
                               consumer=None, reply_sender=None, msg_size=32)
        fin = FinishedRequest(rid="big", prompt=[1], tokens=list(range(100)), finish_reason="length")
        with pytest.raises(ChannelMessageTooLargeError, match="msg_size"):
            server.encode_reply(fin)

    def test_reply_fits_is_padded(self, bundle, runtime):
        server = ChannelServer(_sched(bundle, runtime, max_batch=2, max_len=64),
                               consumer=None, reply_sender=None, msg_size=128)
        wire = server.encode_reply(FinishedRequest(rid="ok", prompt=[1], tokens=[1, 2, 3],
                                                   finish_reason="length"))
        assert len(wire) == 128
        assert json.loads(wire.rstrip(b"\0").decode()) == \
            {"id": "ok", "tokens": [1, 2, 3], "finish_reason": "length"}

    def test_request_decode_roundtrip_and_wire_equals_reference(self):
        raw = _wire({"id": "x", "prompt": [1, 2], "steps": 4, "eos": 7}, 64)
        req = ChannelServer.decode_request(raw)
        assert (req.rid, list(req.prompt), req.max_new_tokens, req.eos_id) == ("x", [1, 2], 4, 7)
        reqs = synthetic_requests(512, 4, prompt_range=(3, 40), steps_range=(2, 9), seed=3)
        for r in reqs + [Request("e", [5, 6], 3, eos_id=9)]:
            jr = JaxRequest(r.rid, list(r.prompt), r.max_new_tokens, r.eos_id)
            assert to_wire(r) == jax_to_wire(jr)
            back = ChannelServer.decode_request(_wire(to_wire(r), 4096))
            assert (back.rid, list(back.prompt), back.max_new_tokens, back.eos_id) == \
                (r.rid, list(r.prompt), r.max_new_tokens, r.eos_id)

    def test_engine_re_exports_the_channel_server(self):
        assert engine.ChannelServer is ChannelServer

    def test_bad_requests_get_error_replies_not_crashes(self, bundle, runtime):
        msgs = [
            b"}{garbage".ljust(128, b"\0"),
            _wire({"id": "huge", "prompt": [1] * 10, "steps": 10}, 128),
            _wire({"id": "good", "prompt": [1, 2, 3], "steps": 2}, 128),
        ]
        reply = FakeReply()
        ChannelServer(_sched(bundle, runtime, max_batch=2, max_len=16), FakeConsumer(msgs), reply,
                      msg_size=128).serve(3)
        by_id = {r["id"]: r for r in reply.out}
        assert "bad request" in by_id[None]["error"]
        assert "cache positions" in by_id["huge"]["error"]
        assert by_id["good"]["tokens"] == \
            _reference_tokens(bundle, [{"id": "good", "prompt": [1, 2, 3], "steps": 2}])["good"]


class TestServeIngestDiscipline:
    def test_full_backlog_does_not_consume_channel_messages(self, bundle, runtime):
        msgs = [_wire({"id": f"q{i}", "prompt": [1, 2, 3], "steps": 4}) for i in range(3)]
        cons = FakeConsumer(msgs)
        ChannelServer(_sched(bundle, runtime, max_batch=1, max_len=32), cons, FakeReply(),
                      msg_size=256).serve(1)
        assert len(cons.msgs) >= 1, "undrained requests were consumed and lost"

    def test_idle_timeout_surfaces_instead_of_hanging(self, bundle, runtime):
        class EmptyConsumer:
            def try_pop(self):
                return None

        server = ChannelServer(_sched(bundle, runtime, max_batch=1, max_len=32), EmptyConsumer(),
                               None, idle_timeout=0.05)
        with pytest.raises(TimeoutError, match="no request arrived"):
            server.serve(1)


class TestStreamingReplies:
    def test_streaming_over_localsim_fabric(self, bundle, runtime):
        """One client, one server over the localsim fabric, an 18-token
        request streamed every 4 ticks: >= 2 delta chunks before the
        terminal one, reassembling to the reference's tokens."""
        MSG, STEPS = 512, 18
        body = {"id": "s-0", "prompt": [1, 2, 3, 4], "steps": STEPS}

        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            if rank == 0:
                req_cons = SPSCConsumer(cm, mm, tag=1, capacity=4, msg_size=MSG)
                rep_prod = SPSCProducer(cm, mm, tag=10, capacity=16, msg_size=MSG)
                ChannelServer(_sched(bundle, runtime, max_batch=2, max_len=32), req_cons, rep_prod,
                              msg_size=MSG, stream_interval=4).serve(n_requests=1)
                return "served"
            req_prod = SPSCProducer(cm, mm, tag=1, capacity=4, msg_size=MSG)
            rep_cons = SPSCConsumer(cm, mm, tag=10, capacity=16, msg_size=MSG)
            req_prod.push(json.dumps(body).encode().ljust(MSG, b"\0"))
            chunks = []
            while True:
                chunk = json.loads(rep_cons.pop(timeout=240).rstrip(b"\0").decode())
                chunks.append(chunk)
                if chunk["done"]:
                    return chunks

        w = LocalSimWorld(2)
        try:
            results = w.launch(prog, timeout=300)
        finally:
            w.shutdown()
        chunks = results[1]
        assert results[0] == "served"
        assert all(c["id"] == "s-0" for c in chunks)
        assert [c["done"] for c in chunks[:-1]] == [False] * (len(chunks) - 1)
        assert chunks[-1]["done"] is True and chunks[-1]["finish_reason"] == "length"
        assert len(chunks) - 1 >= 2, f"want >=2 deltas before terminal: {chunks}"
        assert [t for c in chunks for t in c["delta"]] == _reference_tokens(bundle, [body])["s-0"]

    def test_stream_reassembly_matches_terse_protocol(self, bundle, runtime):
        bodies = [{"id": "a", "prompt": [1, 2, 3], "steps": 9},
                  {"id": "b", "prompt": [4, 5, 6, 7], "steps": 6}]
        msgs = [_wire(b) for b in bodies]
        terse = FakeReply()
        ChannelServer(_sched(bundle, runtime, max_batch=2, max_len=32), FakeConsumer(list(msgs)),
                      terse, msg_size=256).serve(2)
        expected = {r["id"]: r["tokens"] for r in terse.out}
        assert expected == _reference_tokens(bundle, bodies)
        streamed = FakeReply()
        ChannelServer(_sched(bundle, runtime, max_batch=2, max_len=32), FakeConsumer(list(msgs)),
                      streamed, msg_size=256, stream_interval=2).serve(2)
        got, finish = {}, {}
        for chunk in streamed.out:
            assert set(chunk) >= {"id", "delta", "done"}
            assert chunk["id"] not in finish, "chunk after terminal chunk"
            got.setdefault(chunk["id"], []).extend(chunk["delta"])
            if chunk["done"]:
                finish[chunk["id"]] = chunk["finish_reason"]
        assert got == expected
        assert finish == {"a": "length", "b": "length"}
        before_done = sum(1 for c in streamed.out if c["id"] == "a" and not c["done"])
        assert before_done >= 2

    def test_single_token_request_streams_terminal_only(self, bundle, runtime):
        reply = FakeReply()
        ChannelServer(_sched(bundle, runtime, max_batch=2, max_len=32),
                      FakeConsumer([_wire({"id": "one", "prompt": [5, 6], "steps": 1})]), reply,
                      msg_size=256, stream_interval=1).serve(1)
        assert len(reply.out) == 1
        assert reply.out[0]["done"] is True and len(reply.out[0]["delta"]) == 1

    def test_stream_interval_validation(self, bundle, runtime):
        with pytest.raises(ValueError, match="stream_interval"):
            ChannelServer(_sched(bundle, runtime, max_batch=2, max_len=32), None, None,
                          stream_interval=0)
