"""The port's frontends (paper §4.3): the cases of `tests/test_frontends.py`
run against `repro_torch` (Channels: SPSC + MPSC locking/non-locking,
collective and direct construction, seeded ring properties; DataObject;
RPC; Tasking — all over the port's localsim fabric), and one cross-package
case per frontend: the same seeded inputs through the reference's and the
port's frontend give equal outputs in the same order."""
import itertools
import json

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # fallback: seeded-random strategies, tests still run
    from _hypothesis_compat import given, settings, st

from repro_torch.backends import coroutine, hostcpu
from repro_torch.backends.localsim import LocalSimWorld
from repro_torch.core.definitions import FutureTimeoutError
from repro_torch.frontends.channels import (
    ChannelMessageTooLargeError,
    MPSCLockingConsumer,
    MPSCLockingProducer,
    MPSCNonLockingConsumer,
    MPSCNonLockingProducer,
    SPSCConsumer,
    SPSCProducer,
)
from repro_torch.frontends.dataobject import DataObjectEngine, DataObjectId
from repro_torch.frontends.rpc import RPCEngine
from repro_torch.frontends.tasking import TaskRuntime


# ---------------------------------------------------------------------------
# Channels
# ---------------------------------------------------------------------------


class TestSPSC:
    def test_ordered_delivery(self):
        N = 50

        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            if rank == 0:
                prod = SPSCProducer(cm, mm, tag=1, capacity=4, msg_size=16)
                for i in range(N):
                    prod.push(f"msg-{i:04d}".encode().ljust(16, b"\0"))
                return "sent"
            cons = SPSCConsumer(cm, mm, tag=1, capacity=4, msg_size=16)
            out = [cons.pop().rstrip(b"\0").decode() for _ in range(N)]
            return out

        w = LocalSimWorld(2)
        results = w.launch(prog)
        assert results[1] == [f"msg-{i:04d}" for i in range(N)]
        w.shutdown()

    def test_backpressure_when_full(self):
        """Producer may not push once capacity messages are unconsumed."""

        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            if rank == 0:
                prod = SPSCProducer(cm, mm, tag=2, capacity=2, msg_size=8)
                assert prod.try_push(b"a" * 8)
                assert prod.try_push(b"b" * 8)
                full = not prod.try_push(b"c" * 8)  # consumer hasn't popped
                # unblock the consumer-side test
                cm.exchange_global_memory_slots(3, {})
                return full
            cons = SPSCConsumer(cm, mm, tag=2, capacity=2, msg_size=8)
            cm.exchange_global_memory_slots(3, {})  # wait for producer fills
            assert cons.pop() == b"a" * 8
            assert cons.pop() == b"b" * 8
            return True

        w = LocalSimWorld(2)
        results = w.launch(prog)
        assert results[0] is True, "producer should observe a full channel"
        w.shutdown()

    def test_ping_pong_two_channels(self):
        """Bi-directional SPSC pair — the paper's TC1 communication shape."""
        rounds = 20

        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            if rank == 0:
                ping = SPSCProducer(cm, mm, tag=10, capacity=1, msg_size=8)
                pong = SPSCConsumer(cm, mm, tag=11, capacity=1, msg_size=8)
                for i in range(rounds):
                    ping.push(i.to_bytes(8, "little"))
                    echoed = int.from_bytes(pong.pop(), "little")
                    assert echoed == i
                return "pinger-ok"
            ping = SPSCConsumer(cm, mm, tag=10, capacity=1, msg_size=8)
            pong = SPSCProducer(cm, mm, tag=11, capacity=1, msg_size=8)
            for _ in range(rounds):
                pong.push(ping.pop())
            return "ponger-ok"

        w = LocalSimWorld(2)
        results = w.launch(prog)
        assert results == {0: "pinger-ok", 1: "ponger-ok"}
        w.shutdown()


class TestMPSC:
    @pytest.mark.parametrize("locking", [True, False])
    def test_multi_producer_single_consumer(self, locking):
        n_producers, per = 3, 20

        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            if rank == 0:  # consumer
                if locking:
                    cons = MPSCLockingConsumer(cm, mm, tag=5, capacity=8, msg_size=8)
                else:
                    cons = MPSCNonLockingConsumer(cm, mm, tag=5, capacity=8, msg_size=8,
                                                  n_producers=n_producers)
                got = [cons.pop() for _ in range(n_producers * per)]
                return sorted(got)
            pidx = rank - 1
            if locking:
                prod = MPSCLockingProducer(cm, mm, tag=5, capacity=8, msg_size=8)
            else:
                prod = MPSCNonLockingProducer(cm, mm, tag=5, capacity=8, msg_size=8,
                                              producer_index=pidx)
            for i in range(per):
                prod.push(bytes([pidx]) * 4 + i.to_bytes(4, "little"))
            return "done"

        w = LocalSimWorld(1 + n_producers)
        results = w.launch(prog, timeout=180)
        expected = sorted(
            bytes([p]) * 4 + i.to_bytes(4, "little")
            for p in range(n_producers)
            for i in range(per)
        )
        assert results[0] == expected, "every message from every producer exactly once"
        w.shutdown()


class TestNonblockingIntrospection:
    """try_push/try_pop never block; depth() exposes queue pressure — the
    primitives the continuous-batching ChannelServer drains with."""

    def test_depth_tracks_pushes_and_pops(self):
        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            if rank == 0:  # producer
                prod = SPSCProducer(cm, mm, tag=1, capacity=8, msg_size=8)
                for i in range(3):
                    prod.push(i.to_bytes(8, "little"))
                cm.exchange_global_memory_slots(99, {})  # pushes visible
                d_full = prod.depth()
                cm.exchange_global_memory_slots(98, {})  # consumer may now pop
                cm.exchange_global_memory_slots(97, {})  # consumer popped 2
                return (d_full, prod.depth())
            cons = SPSCConsumer(cm, mm, tag=1, capacity=8, msg_size=8)
            cm.exchange_global_memory_slots(99, {})
            d_full = cons.depth()
            cm.exchange_global_memory_slots(98, {})  # producer read its depth
            assert cons.try_pop() is not None and cons.try_pop() is not None
            d_after = cons.depth()
            cm.exchange_global_memory_slots(97, {})
            return (d_full, d_after)

        w = LocalSimWorld(2)
        results = w.launch(prog)
        assert results[0] == (3, 1), "producer-side depth (refreshes head)"
        assert results[1] == (3, 1), "consumer-side depth"
        w.shutdown()

    def test_try_pop_empty_returns_none_immediately(self):
        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            if rank == 0:
                prod = SPSCProducer(cm, mm, tag=2, capacity=4, msg_size=8)
                cm.exchange_global_memory_slots(97, {})  # let consumer probe
                prod.push(b"x" * 8)
                return "sent"
            cons = SPSCConsumer(cm, mm, tag=2, capacity=4, msg_size=8)
            empty_probe = cons.try_pop()
            cm.exchange_global_memory_slots(97, {})
            return (empty_probe, cons.pop())

        w = LocalSimWorld(2)
        results = w.launch(prog)
        assert results[1] == (None, b"x" * 8)
        w.shutdown()

    def test_mpsc_consumer_depth_sums_rings(self):
        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            if rank == 0:
                cons = MPSCNonLockingConsumer(cm, mm, tag=3, capacity=8, msg_size=8,
                                              n_producers=2)
                cm.exchange_global_memory_slots(96, {})  # all pushes landed
                depth = cons.depth()
                drained = sum(1 for _ in range(depth) if cons.try_pop() is not None)
                return (depth, drained, cons.try_pop())
            prod = MPSCNonLockingProducer(cm, mm, tag=3, capacity=8, msg_size=8,
                                          producer_index=rank - 1)
            for i in range(2):
                prod.push(bytes([rank, i]) * 4)
            cm.exchange_global_memory_slots(96, {})
            return "sent"

        w = LocalSimWorld(3)
        results = w.launch(prog)
        assert results[0] == (4, 4, None)
        w.shutdown()

    def test_locking_producer_depth_refreshes_shared_tail(self):
        """MPSC locking producers share the tail counter: depth() must
        re-read it, not trust the stale local copy (which would even go
        negative once the consumer pops)."""

        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            if rank == 0:  # consumer
                cons = MPSCLockingConsumer(cm, mm, tag=6, capacity=8, msg_size=8)
                cm.exchange_global_memory_slots(95, {})  # A pushed 3
                assert cons.try_pop() is not None
                cm.exchange_global_memory_slots(94, {})  # popped 1
                return "ok"
            if rank == 1:  # producer A: does the pushing
                prod = MPSCLockingProducer(cm, mm, tag=6, capacity=8, msg_size=8)
                for i in range(3):
                    prod.push(i.to_bytes(8, "little"))
                cm.exchange_global_memory_slots(95, {})
                cm.exchange_global_memory_slots(94, {})
                return "ok"
            # producer B: never pushed, local tail cache is stale (0)
            prod = MPSCLockingProducer(cm, mm, tag=6, capacity=8, msg_size=8)
            cm.exchange_global_memory_slots(95, {})
            cm.exchange_global_memory_slots(94, {})
            return prod.depth()

        w = LocalSimWorld(3)
        results = w.launch(prog)
        assert results[2] == 2, "3 pushed - 1 popped, seen from the idle producer"
        w.shutdown()

    @pytest.mark.parametrize("locking", [True, False])
    def test_oversized_message_raises(self, locking):
        """Satellite bugfix: a payload larger than msg_size raises instead of
        corrupting the ring."""

        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            if rank == 0:
                if locking:
                    prod = MPSCLockingProducer(cm, mm, tag=4, capacity=4, msg_size=8)
                else:
                    prod = SPSCProducer(cm, mm, tag=4, capacity=4, msg_size=8)
                try:
                    prod.try_push(b"y" * 9)
                    outcome = "no error"
                except ChannelMessageTooLargeError:
                    outcome = "raised"
                prod.push(b"z" * 8)  # channel still usable afterwards
                return outcome
            if locking:
                cons = MPSCLockingConsumer(cm, mm, tag=4, capacity=4, msg_size=8)
            else:
                cons = SPSCConsumer(cm, mm, tag=4, capacity=4, msg_size=8)
            return cons.pop()

        w = LocalSimWorld(2)
        results = w.launch(prog)
        assert results[0] == "raised"
        assert results[1] == b"z" * 8
        w.shutdown()


#: fresh exchange tags so every (property) example gets its own ring
_TAGS = itertools.count(50_000)


@pytest.fixture(scope="module")
def direct_world():
    w = LocalSimWorld(1)
    yield w
    w.shutdown()


@pytest.fixture(scope="module")
def direct_mgrs(direct_world):
    return direct_world.managers_for(0)


class TestDirectChannels:
    """`connect_direct`: non-collective channel construction over directly
    registered slots — what lets an elastically created fleet worker attach
    to the router without joining launch-time collectives."""

    def test_direct_pair_roundtrip_single_instance(self, direct_mgrs):
        cm, mm = direct_mgrs.communication_manager, direct_mgrs.memory_manager
        tag = next(_TAGS)
        cons = SPSCConsumer.connect_direct(cm, mm, tag=tag, capacity=4, msg_size=8)
        prod = SPSCProducer.connect_direct(cm, mm, tag=tag, capacity=4, msg_size=8)
        for i in range(10):  # wraps the 4-deep ring twice
            assert prod.try_push(i.to_bytes(8, "little"))
            assert int.from_bytes(cons.pop(timeout=10), "little") == i

    def test_direct_producer_rendezvous_across_instances(self):
        """The producer may connect BEFORE the consumer exists: the bounded
        rendezvous retry resolves once registration lands, regardless of
        thread interleaving."""

        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            if rank == 0:
                prod = SPSCProducer.connect_direct(cm, mm, tag=91000, capacity=2,
                                                   msg_size=8, timeout=30.0)
                prod.push(b"direct!!")
                return "sent"
            cons = SPSCConsumer.connect_direct(cm, mm, tag=91000, capacity=2, msg_size=8)
            return cons.pop(timeout=30)

        w = LocalSimWorld(2)
        results = w.launch(prog)
        assert results[1] == b"direct!!"
        w.shutdown()

    def test_direct_connect_times_out_without_peer(self, direct_mgrs):
        cm, mm = direct_mgrs.communication_manager, direct_mgrs.memory_manager
        with pytest.raises(FutureTimeoutError, match="did not register"):
            SPSCProducer.connect_direct(cm, mm, tag=next(_TAGS), capacity=2,
                                        msg_size=8, timeout=0.05)

    def test_direct_consumer_duplicate_tag_rejected(self, direct_mgrs):
        from repro_torch.core.definitions import HiCRError

        cm, mm = direct_mgrs.communication_manager, direct_mgrs.memory_manager
        tag = next(_TAGS)
        SPSCConsumer.connect_direct(cm, mm, tag=tag, capacity=2, msg_size=8)
        with pytest.raises(HiCRError, match="already registered"):
            SPSCConsumer.connect_direct(cm, mm, tag=tag, capacity=2, msg_size=8)


class TestChannelRingProperties:
    """Seeded ring-buffer properties of the channels frontend (these run with
    or without hypothesis — the fallback shim draws deterministic examples).

    The ring invariants under test are the paper's §4.3 channel semantics:
    fixed-size slots, FIFO order across wraparound, tail-head depth
    accounting, try_push backpressure exactly at capacity."""

    def _pair(self, mgrs, capacity, msg_size=8):
        cm, mm = mgrs.communication_manager, mgrs.memory_manager
        tag = next(_TAGS)
        cons = SPSCConsumer.connect_direct(cm, mm, tag=tag, capacity=capacity,
                                           msg_size=msg_size)
        prod = SPSCProducer.connect_direct(cm, mm, tag=tag, capacity=capacity,
                                           msg_size=msg_size)
        return prod, cons

    @settings(max_examples=10, deadline=None)
    @given(
        capacity=st.sampled_from([1, 2, 3, 4, 8]),
        n=st.integers(1, 24),
        seed=st.integers(0, 2**16),
    )
    def test_fifo_order_under_random_schedule(self, direct_mgrs, capacity, n, seed):
        """Any interleaving of pushes and pops preserves total FIFO order."""
        rng = np.random.default_rng(seed)
        prod, cons = self._pair(direct_mgrs, capacity)
        sent = popped = 0
        got = []
        while popped < n:
            if sent < n and (sent - popped == 0 or rng.random() < 0.5):
                if prod.try_push(sent.to_bytes(8, "little")):
                    sent += 1
                continue
            data = cons.try_pop()
            if data is not None:
                got.append(int.from_bytes(data, "little"))
                popped += 1
        assert got == list(range(n))

    @settings(max_examples=10, deadline=None)
    @given(capacity=st.sampled_from([1, 2, 4]), rounds=st.integers(1, 5))
    def test_backpressure_exactly_at_capacity(self, direct_mgrs, capacity, rounds):
        """try_push accepts exactly `capacity` unconsumed messages, refuses
        the next, and recovers after a pop — every round (wraparound)."""
        prod, cons = self._pair(direct_mgrs, capacity)
        for _ in range(rounds):
            for i in range(capacity):
                assert prod.try_push(bytes([i]) * 8)
            assert not prod.try_push(b"x" * 8)  # full: refused
            assert cons.try_pop() is not None
            assert prod.try_push(b"y" * 8)  # freed one slot: accepted
            for _ in range(capacity):
                assert cons.try_pop() is not None
            assert cons.try_pop() is None  # drained

    @settings(max_examples=10, deadline=None)
    @given(
        capacity=st.sampled_from([2, 4, 8]),
        n=st.integers(1, 20),
        seed=st.integers(0, 2**16),
    )
    def test_depth_equals_pushed_minus_popped(self, direct_mgrs, capacity, n, seed):
        """Both ends' depth() equal (pushed - popped) at every step of a
        random schedule."""
        rng = np.random.default_rng(seed)
        prod, cons = self._pair(direct_mgrs, capacity)
        sent = popped = 0
        for _ in range(3 * n):
            if rng.random() < 0.5 and sent - popped < capacity:
                assert prod.try_push(sent.to_bytes(8, "little"))
                sent += 1
            elif sent > popped:
                assert cons.try_pop() is not None
                popped += 1
            assert cons.depth() == sent - popped
            assert prod.depth() == sent - popped

    @settings(max_examples=10, deadline=None)
    @given(extra=st.integers(1, 64), msg_size=st.sampled_from([4, 8, 16]))
    def test_oversize_always_rejected_exact_fit_accepted(self, direct_mgrs, extra, msg_size):
        prod, cons = self._pair(direct_mgrs, 2, msg_size=msg_size)
        with pytest.raises(ChannelMessageTooLargeError):
            prod.try_push(b"z" * (msg_size + extra))
        assert prod.try_push(b"f" * msg_size)  # exact fit is legal
        assert cons.try_pop() == b"f" * msg_size


# ---------------------------------------------------------------------------
# DataObject
# ---------------------------------------------------------------------------


class TestDataObject:
    def test_publish_handle_get(self):
        payload = np.random.default_rng(1).integers(0, 255, 4096, dtype=np.uint8)
        box = {}

        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            space = mm.memory_spaces()[0]
            engine = DataObjectEngine(cm, mm, instance_rank=rank)
            if rank == 0:
                slot = mm.allocate_local_memory_slot(space, payload.nbytes)
                slot.handle[:] = payload
                ident = engine.publish(slot)
                box["ident"] = ident.serialize()  # ships over a channel IRL
                cm.exchange_global_memory_slots(1, {})  # publish barrier
                cm.exchange_global_memory_slots(2, {})  # fetch barrier
                return "published"
            cm.exchange_global_memory_slots(1, {})
            ident = DataObjectId.deserialize(box["ident"])
            got = engine.fetch(ident)
            cm.exchange_global_memory_slots(2, {})
            return bytes(got.handle[: got.size_bytes])

        w = LocalSimWorld(2)
        results = w.launch(prog)
        assert results[1] == payload.tobytes()
        w.shutdown()

    def test_get_requires_fitting_destination(self):
        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            space = mm.memory_spaces()[0]
            engine = DataObjectEngine(cm, mm, instance_rank=rank)
            slot = mm.allocate_local_memory_slot(space, 64)
            ident = engine.publish(slot)
            handle = engine.get_handle(ident)
            small = mm.allocate_local_memory_slot(space, 8)
            with pytest.raises(ValueError):
                engine.get(handle, small)
            return True

        w = LocalSimWorld(1)
        w.launch(prog)
        w.shutdown()

    def test_unpublish_makes_object_unreachable(self):
        from repro_torch.core.definitions import HiCRError

        def prog(mgrs, rank):
            cm, mm = mgrs.communication_manager, mgrs.memory_manager
            space = mm.memory_spaces()[0]
            engine = DataObjectEngine(cm, mm, instance_rank=rank)
            slot = mm.allocate_local_memory_slot(space, 16)
            ident = engine.publish(slot)
            engine.unpublish(ident)
            with pytest.raises(HiCRError):
                engine.get_handle(ident)
            return True

        w = LocalSimWorld(1)
        w.launch(prog)
        w.shutdown()


# ---------------------------------------------------------------------------
# RPC
# ---------------------------------------------------------------------------


class TestRPC:
    def test_call_with_return_value(self):
        def prog(mgrs, rank):
            rpc = RPCEngine(mgrs.instance_manager)
            if rank == 1:
                rpc.register("add", lambda a, b: a + b)
                rpc.listen(timeout=10)
                return "served"
            target = mgrs.instance_manager.get_instances()[1]
            return rpc.call(target, "add", 2, 40)

        w = LocalSimWorld(2)
        results = w.launch(prog)
        assert results[0] == 42
        w.shutdown()

    def test_remote_error_propagates(self):
        def prog(mgrs, rank):
            rpc = RPCEngine(mgrs.instance_manager)
            if rank == 1:
                def boom():
                    raise ValueError("remote-boom")
                rpc.register("boom", boom)
                rpc.listen(timeout=10)
                return "served"
            target = mgrs.instance_manager.get_instances()[1]
            with pytest.raises(RuntimeError, match="remote-boom"):
                rpc.call(target, "boom")
            return "caught"

        w = LocalSimWorld(2)
        results = w.launch(prog)
        assert results[0] == "caught"
        w.shutdown()

    def test_unregistered_rpc_reports_error(self):
        def prog(mgrs, rank):
            rpc = RPCEngine(mgrs.instance_manager)
            if rank == 1:
                rpc.listen(timeout=10)
                return "served"
            target = mgrs.instance_manager.get_instances()[1]
            with pytest.raises(RuntimeError, match="no RPC named"):
                rpc.call(target, "nope")
            return "caught"

        w = LocalSimWorld(2)
        assert w.launch(prog)[0] == "caught"
        w.shutdown()

    def test_topology_exchange_over_rpc(self):
        """The paper's stated RPC use: exchanging instance topology info."""

        def prog(mgrs, rank):
            from repro_torch.core.stateless import Topology

            rpc = RPCEngine(mgrs.instance_manager)
            topo = mgrs.query_full_topology()
            if rank == 1:
                rpc.register("topology", lambda: topo.serialize().decode())
                rpc.listen(timeout=10)
                return "served"
            target = mgrs.instance_manager.get_instances()[1]
            remote = Topology.deserialize(rpc.call(target, "topology").encode())
            return len(remote.all_compute_resources())

        w = LocalSimWorld(2)
        results = w.launch(prog)
        assert results[0] >= 1
        w.shutdown()


# ---------------------------------------------------------------------------
# Tasking
# ---------------------------------------------------------------------------


class TestTasking:
    def _make_runtime(self, n_workers=2, *, coroutine_tasks=False):
        topo = hostcpu.HostTopologyManager().query_topology()
        resources = (topo.all_compute_resources() * n_workers)[:n_workers]
        tcm = coroutine.CoroutineComputeManager() if coroutine_tasks else hostcpu.HostComputeManager()
        return TaskRuntime(
            worker_compute_manager=hostcpu.HostComputeManager(),
            task_compute_manager=tcm,
            worker_resources=resources,
        )

    def test_all_tasks_execute(self):
        rt = self._make_runtime(3)
        tasks = [rt.submit(lambda i=i: i * 2, name=f"t{i}") for i in range(40)]
        stats = rt.run_until_complete()
        assert stats["total"] == 40
        assert [t.get() for t in tasks] == [i * 2 for i in range(40)]
        # work was load-balanced across workers (every worker saw tasks)
        assert sum(stats["executed"]) == 40

    def test_callbacks_fire(self):
        rt = self._make_runtime(1)
        events = []
        t = rt.submit(lambda: "x")
        t.on_start = lambda task: events.append("start")
        t.on_finish = lambda task: events.append("finish")
        rt.run_until_complete()
        assert events == ["start", "finish"]

    def test_task_error_captured(self):
        rt = self._make_runtime(1)

        def bad():
            raise RuntimeError("task-fail")

        t = rt.submit(bad)
        rt.run_until_complete()
        with pytest.raises(RuntimeError, match="task-fail"):
            t.get()

    def test_suspendable_tasks_interleave(self):
        """Generator tasks on the coroutine manager suspend at yields, so one
        worker interleaves many tasks — the fine-grained Fibonacci shape."""
        rt = self._make_runtime(1, coroutine_tasks=True)
        trace = []

        def gen_task(tag):
            trace.append(f"{tag}-a")
            yield
            trace.append(f"{tag}-b")
            return tag

        t1 = rt.submit(gen_task, "x")
        t2 = rt.submit(gen_task, "y")
        rt.run_until_complete()
        assert t1.get() == "x" and t2.get() == "y"
        # interleaving: both -a entries precede both -b entries
        assert trace.index("y-a") < trace.index("x-b")

    def test_custom_pull_function_priority(self):
        """pull() is the user-defined scheduler (paper: 'a user-defined
        scheduling function that should return the next task')."""
        order = []

        def lifo_pull(rt, worker):
            with rt._qlock:
                return rt._queue.pop() if rt._queue else None

        topo = hostcpu.HostTopologyManager().query_topology()
        rt = TaskRuntime(
            worker_compute_manager=hostcpu.HostComputeManager(),
            task_compute_manager=hostcpu.HostComputeManager(),
            worker_resources=topo.all_compute_resources()[:1],
            pull_fn=lifo_pull,
        )
        for i in range(5):
            rt.submit(lambda i=i: order.append(i))
        rt.run_until_complete()
        assert order == [4, 3, 2, 1, 0]


# ---------------------------------------------------------------------------
# the port against the reference, one case per frontend
# ---------------------------------------------------------------------------


def _package(name):
    """The frontends and backends of one package, by the names both use."""
    import importlib
    import types

    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        channels=mod("frontends.channels"),
        dataobject=mod("frontends.dataobject"),
        rpc=mod("frontends.rpc"),
        tasking=mod("frontends.tasking"),
        localsim=mod("backends.localsim"),
        hostcpu=mod("backends.hostcpu"),
        coroutine=mod("backends.coroutine"),
    )


PACKAGES = ("repro", "repro_torch")


def _payloads(seed, n, msg_size):
    """Seeded messages of random length <= msg_size, NUL-padded to it."""
    rng = np.random.default_rng(seed)
    return [
        rng.integers(1, 256, int(rng.integers(1, msg_size + 1)), dtype=np.uint8)
        .tobytes().ljust(msg_size, b"\0")
        for _ in range(n)
    ]


class TestAgainstReference:
    @staticmethod
    def _both(run):
        """`run(pkg)` on the reference and on the port: (reference, port)."""
        return tuple(run(_package(name)) for name in PACKAGES)

    @pytest.mark.parametrize("capacity", [1, 3, 8])
    def test_spsc_collective_rings_deliver_the_same_bytes(self, capacity):
        sent = _payloads(capacity, 40, 24)

        def run(pkg):
            def prog(mgrs, rank):
                cm, mm = mgrs.communication_manager, mgrs.memory_manager
                if rank == 0:
                    prod = pkg.channels.SPSCProducer(cm, mm, tag=1, capacity=capacity, msg_size=24)
                    for m in sent:
                        prod.push(m)
                    return None
                cons = pkg.channels.SPSCConsumer(cm, mm, tag=1, capacity=capacity, msg_size=24)
                return [bytes(cons.pop()) for _ in sent]

            w = pkg.localsim.LocalSimWorld(2)
            try:
                return w.launch(prog)[1]
            finally:
                w.shutdown()

        ref, port = self._both(run)
        assert port == ref == sent

    @pytest.mark.parametrize("seed", [0, 1])
    def test_spsc_direct_rings_under_one_schedule(self, seed):
        """The same seeded interleaving of try_push/try_pop on a direct pair:
        the same accept/refuse pattern and the same bytes out, in order."""
        sent = _payloads(100 + seed, 60, 16)
        ops_rng = np.random.default_rng(seed)
        schedule = ops_rng.random(200) < 0.55  # True: try_push, False: try_pop

        def run(pkg):
            w = pkg.localsim.LocalSimWorld(1)
            try:
                mgrs = w.managers_for(0)
                cm, mm = mgrs.communication_manager, mgrs.memory_manager
                cons = pkg.channels.SPSCConsumer.connect_direct(cm, mm, tag=7, capacity=3, msg_size=16)
                prod = pkg.channels.SPSCProducer.connect_direct(cm, mm, tag=7, capacity=3, msg_size=16)
                trace, nxt = [], 0
                for push in schedule:
                    if push and nxt < len(sent):
                        ok = prod.try_push(sent[nxt])
                        nxt += bool(ok)
                        trace.append(("push", bool(ok), cons.depth()))
                    else:
                        got = cons.try_pop()
                        trace.append(("pop", None if got is None else bytes(got), cons.depth()))
                return trace
            finally:
                w.shutdown()

        ref, port = self._both(run)
        assert port == ref
        assert any(t[0] == "push" and not t[1] for t in port), "the schedule must fill the ring"

    @pytest.mark.parametrize("locking", [True, False])
    def test_mpsc_delivers_each_producers_bytes_in_order(self, locking):
        n_producers, per = 3, 12
        sent = {p: _payloads(200 + p, per, 8) for p in range(n_producers)}

        def run(pkg):
            ch = pkg.channels

            def prog(mgrs, rank):
                cm, mm = mgrs.communication_manager, mgrs.memory_manager
                if rank == 0:
                    if locking:
                        cons = ch.MPSCLockingConsumer(cm, mm, tag=5, capacity=4, msg_size=8)
                    else:
                        cons = ch.MPSCNonLockingConsumer(cm, mm, tag=5, capacity=4, msg_size=8,
                                                         n_producers=n_producers)
                    return [bytes(cons.pop()) for _ in range(n_producers * per)]
                p = rank - 1
                if locking:
                    prod = ch.MPSCLockingProducer(cm, mm, tag=5, capacity=4, msg_size=8)
                else:
                    prod = ch.MPSCNonLockingProducer(cm, mm, tag=5, capacity=4, msg_size=8,
                                                     producer_index=p)
                for m in sent[p]:
                    prod.push(m)
                return None

            w = pkg.localsim.LocalSimWorld(1 + n_producers)
            try:
                got = w.launch(prog, timeout=180)[0]
            finally:
                w.shutdown()
            # producers interleave by thread timing; each one's stream is ordered
            return {p: [m for m in got if m in set(sent[p])] for p in sent}

        ref, port = self._both(run)
        assert port == ref == sent

    def test_dataobject_fetch_returns_the_published_bytes(self):
        payload = np.random.default_rng(3).integers(0, 256, 3000, dtype=np.uint8)

        def run(pkg):
            box = {}

            def prog(mgrs, rank):
                cm, mm = mgrs.communication_manager, mgrs.memory_manager
                space = mm.memory_spaces()[0]
                engine = pkg.dataobject.DataObjectEngine(cm, mm, instance_rank=rank)
                if rank == 0:
                    slot = mm.allocate_local_memory_slot(space, payload.nbytes)
                    slot.handle[:] = payload
                    box["ident"] = engine.publish(slot).serialize()
                    cm.exchange_global_memory_slots(1, {})
                    cm.exchange_global_memory_slots(2, {})
                    return box["ident"]
                cm.exchange_global_memory_slots(1, {})
                got = engine.fetch(pkg.dataobject.DataObjectId.deserialize(box["ident"]))
                cm.exchange_global_memory_slots(2, {})
                return bytes(got.handle[: got.size_bytes])

            w = pkg.localsim.LocalSimWorld(2)
            try:
                out = w.launch(prog)
            finally:
                w.shutdown()
            return out[0], out[1]

        (ref_ident, ref_bytes), (port_ident, port_bytes) = self._both(run)
        assert port_bytes == ref_bytes == payload.tobytes()
        # the same wire identifier: tag and key come from a per-process
        # counter of each package, so only the layout and the size compare
        ref_id, port_id = json.loads(ref_ident), json.loads(port_ident)
        assert sorted(port_id) == sorted(ref_id) == ["key", "size_bytes", "tag"]
        assert port_id["size_bytes"] == ref_id["size_bytes"] == payload.nbytes

    def test_rpc_returns_the_same_values(self):
        calls = [("digest", (bytes(range(i, i + 9)).hex(),)) for i in range(5)] + \
            [("add", (2, 40)), ("nope", ())]

        def run(pkg):
            import hashlib

            def prog(mgrs, rank):
                rpc = pkg.rpc.RPCEngine(mgrs.instance_manager)
                if rank == 1:
                    rpc.register("add", lambda a, b: a + b)
                    rpc.register("digest", lambda h: hashlib.sha256(bytes.fromhex(h)).hexdigest())
                    for _ in calls:
                        rpc.listen(timeout=10)
                    return None
                target = mgrs.instance_manager.get_instances()[1]
                out = []
                for name, args in calls:
                    try:
                        out.append(rpc.call(target, name, *args))
                    except RuntimeError as e:
                        out.append(f"error: {e}")
                return out

            w = pkg.localsim.LocalSimWorld(2)
            try:
                return w.launch(prog)[0]
            finally:
                w.shutdown()

        ref, port = self._both(run)
        assert port == ref
        assert port[5] == 42 and "no RPC named" in port[6]

    @pytest.mark.parametrize("coroutine_tasks", [False, True])
    def test_tasking_runs_the_same_schedule(self, coroutine_tasks):
        """One worker, a LIFO pull function and (on the coroutine manager)
        suspending tasks: the same execution trace and the same results."""

        def run(pkg):
            trace = []

            def lifo_pull(rt, worker):
                with rt._qlock:
                    return rt._queue.pop() if rt._queue else None

            def suspending(i):
                trace.append(f"{i}-a")
                yield
                trace.append(f"{i}-b")
                return i * i

            def plain(i):
                trace.append(f"{i}-a")
                trace.append(f"{i}-b")
                return i * i

            body = suspending if coroutine_tasks else plain
            topo = pkg.hostcpu.HostTopologyManager().query_topology()
            tcm = (pkg.coroutine.CoroutineComputeManager() if coroutine_tasks
                   else pkg.hostcpu.HostComputeManager())
            rt = pkg.tasking.TaskRuntime(
                worker_compute_manager=pkg.hostcpu.HostComputeManager(),
                task_compute_manager=tcm,
                worker_resources=topo.all_compute_resources()[:1],
                pull_fn=lifo_pull,
            )
            tasks = [rt.submit(body, i) for i in range(6)]
            rt.run_until_complete()
            return trace, [t.get() for t in tasks]

        ref, port = self._both(run)
        assert port == ref
        assert port[1] == [i * i for i in range(6)]

