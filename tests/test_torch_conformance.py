"""Cross-backend manager conformance matrix (paper §3.1 / §4.1), over the
port's backends: the matrix of `tests/test_conformance.py` with `torchdev`
(on the CPU, ``device="cpu"``) in `jaxdev`'s row.

Every backend derives the same five abstract manager roles, so every backend
must honor the same contracts — including the *negative* ones: a role a
backend does not implement must be absent from the registry and surface as
`UnsupportedOperationError` (or a None manager in the `ManagerSet`), never
as silent misbehavior. Each test below is one contract, parametrized over
the four conformance backends; a future backend inherits the whole suite by
adding itself to `BACKENDS`/`CAPS` and a `_managers` harness entry.

Contracts covered:
  topology non-empty + mergeable · execute() returns a resolving Future ·
  execution-state single use · memcpy returns a landing Event · fence(tag)
  coverage · global-slot exchange capability · channel FIFO · channel
  oversize rejection · instance root/current semantics · lifecycle
  UnsupportedOperationError paths · memory alloc/register/free · suspension
  capability flag honesty.
"""
import itertools

import numpy as np
import pytest

from repro_torch.core.definitions import (
    HiCRError,
    LifetimeError,
    UnsupportedOperationError,
)
from repro_torch.core.managers import ManagerSet
from repro_torch.core.registry import get_backend
from repro_torch.core.stateless import ComputeResource, Topology

BACKENDS = ("hostcpu", "torchdev", "localsim", "coroutine")

#: roles each conformance harness exposes in its ManagerSet (localsim's
#: managers_for() composes hostcpu memory/compute/topology around its own
#: instance+communication managers, as its launcher does for applications)
CAPS = {
    "hostcpu": {"topology", "instance", "communication", "memory", "compute"},
    "torchdev": {"topology", "communication", "memory", "compute"},
    "localsim": {"topology", "instance", "communication", "memory", "compute"},
    "coroutine": {"compute"},
}

#: roles the backend itself registers (the paper's Table 1 row)
REGISTRY_CAPS = {
    "hostcpu": {"topology", "instance", "communication", "memory", "compute"},
    "torchdev": {"topology", "communication", "memory", "compute"},
    "localsim": {"instance", "communication"},
    "coroutine": {"compute"},
}

#: supports multi-instance global memory slots (and hence channels)
MULTI_INSTANCE = {"localsim"}

_TAGS = itertools.count(70_000)


@pytest.fixture(scope="module")
def _localsim_world():
    from repro_torch.backends.localsim import LocalSimWorld

    w = LocalSimWorld(1)
    yield w
    w.shutdown()


@pytest.fixture(scope="module")
def _all_mgrs(_localsim_world):
    from repro_torch.backends import coroutine, hostcpu, torchdev

    host = hostcpu.make_managers()
    return {
        "hostcpu": ManagerSet(
            instance_manager=host["instance"],
            topology_managers=(host["topology"],),
            memory_manager=host["memory"],
            communication_manager=host["communication"],
            compute_manager=host["compute"],
        ),
        "torchdev": ManagerSet(
            topology_managers=(torchdev.TorchTopologyManager(device="cpu"),),
            memory_manager=torchdev.TorchMemoryManager(device="cpu"),
            communication_manager=torchdev.TorchCommunicationManager(device="cpu"),
            compute_manager=torchdev.TorchComputeManager(device="cpu"),
        ),
        "localsim": _localsim_world.managers_for(0),
        "coroutine": ManagerSet(compute_manager=coroutine.CoroutineComputeManager()),
    }


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


@pytest.fixture
def mgrs(_all_mgrs, backend):
    return _all_mgrs[backend]


def _pu_resource(backend, mgrs) -> ComputeResource:
    """A compute resource valid for the backend's compute manager."""
    if "topology" in CAPS[backend]:
        return mgrs.query_full_topology().all_compute_resources()[0]
    # descriptive stand-in: compute-only backends accept any resource
    return ComputeResource(kind="cpu_core", index=0, device_id="conf-0")


def _run(backend, mgrs, fn, *args):
    """submit-and-wait through the backend's own compute manager."""
    cm = mgrs.compute_manager
    pu = cm.create_processing_unit(_pu_resource(backend, mgrs))
    cm.initialize(pu)
    try:
        unit = cm.create_execution_unit(fn, name="conformance")
        state = cm.create_execution_state(unit, *args)
        future = cm.execute(pu, state)
        return future, state
    finally:
        cm.finalize(pu)


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


class TestTopologyContract:
    def test_topology_nonempty_and_mergeable(self, backend, mgrs):
        if "topology" not in CAPS[backend]:
            assert not mgrs.topology_managers
            assert len(mgrs.query_full_topology().get_devices()) == 0
            return
        topo = mgrs.query_full_topology()
        assert len(topo.get_devices()) >= 1
        assert len(topo.all_compute_resources()) >= 1
        assert len(topo.all_memory_spaces()) >= 1
        # merge is deduplicating and identity-preserving
        merged = topo.merge(topo).merge(Topology())
        assert {d.device_id for d in merged.get_devices()} == \
            {d.device_id for d in topo.get_devices()}

    def test_topology_serializes_for_broadcast(self, backend, mgrs):
        """The paper requires topologies to serialize so instances can
        exchange them; an absent role is absent from the registry too."""
        if "topology" not in CAPS[backend]:
            assert "topology" not in REGISTRY_CAPS[backend]
            assert "topology" not in get_backend(backend).factories
            return
        topo = mgrs.query_full_topology()
        again = Topology.deserialize(topo.serialize())
        assert len(again.all_compute_resources()) == len(topo.all_compute_resources())


# ---------------------------------------------------------------------------
# compute
# ---------------------------------------------------------------------------


class TestComputeContract:
    def test_execute_returns_resolving_future(self, backend, mgrs):
        future, _ = _run(backend, mgrs, lambda x: x + 1, np.int32(41))
        assert future.wait(30), "completion Future never resolved"
        assert int(future.result()) == 42
        assert future.done()

    def test_execute_propagates_errors_through_future(self, backend, mgrs):
        def boom(_x):
            raise ValueError("conformance-boom")

        future, state = _run(backend, mgrs, boom, np.int32(0))
        assert future.wait(30)
        with pytest.raises(ValueError, match="conformance-boom"):
            future.result()
        assert state.error is not None

    def test_execution_state_single_use(self, backend, mgrs):
        cm = mgrs.compute_manager
        pu = cm.create_processing_unit(_pu_resource(backend, mgrs))
        cm.initialize(pu)
        try:
            unit = cm.create_execution_unit(lambda: 1, name="once")
            state = cm.create_execution_state(unit)
            cm.execute(pu, state).wait(30)
            with pytest.raises(LifetimeError):
                cm.execute(pu, state)
        finally:
            cm.finalize(pu)

    def test_suspension_capability_is_honest(self, backend, mgrs):
        """`supports_suspension` must match behavior: True means suspendable
        execution states exist (coroutine), False means suspend/resume raise
        UnsupportedOperationError."""
        cm = mgrs.compute_manager
        pu = cm.create_processing_unit(_pu_resource(backend, mgrs))
        cm.initialize(pu)
        try:
            if cm.supports_suspension:
                def gen():
                    yield
                    return "resumed"

                unit = cm.create_execution_unit(gen, name="susp")
                state = cm.create_execution_state(unit)
                assert not cm.step(state)  # suspended at the yield
                assert cm.step(state)      # ran to completion
                assert state.get_result() == "resumed"
            else:
                with pytest.raises(UnsupportedOperationError):
                    cm.suspend(pu)
                with pytest.raises(UnsupportedOperationError):
                    cm.resume(pu)
        finally:
            cm.finalize(pu)


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------


class TestMemoryContract:
    def test_alloc_register_free(self, backend, mgrs):
        mm = mgrs.memory_manager
        if "memory" not in CAPS[backend]:
            assert mm is None
            assert "memory" not in get_backend(backend).factories
            return
        space = mm.memory_spaces()[0]
        slot = mm.allocate_local_memory_slot(space, 64)
        assert slot.size_bytes == 64
        ext = np.arange(64, dtype=np.uint8)
        reg = mm.register_tensor_slot(space, ext)
        assert reg.registered and reg.size_bytes == 64
        mm.free_local_memory_slot(slot)
        with pytest.raises(LifetimeError):
            slot.check_alive()
        with pytest.raises(LifetimeError):  # double free is a lifetime error
            mm.free_local_memory_slot(slot)

    def test_nonpositive_allocation_rejected(self, backend, mgrs):
        mm = mgrs.memory_manager
        if mm is None:
            pytest.skip("no memory role (covered by test_alloc_register_free)")
        with pytest.raises(ValueError):
            mm.allocate_local_memory_slot(mm.memory_spaces()[0], 0)


# ---------------------------------------------------------------------------
# communication
# ---------------------------------------------------------------------------


class TestCommunicationContract:
    def test_memcpy_returns_event_that_lands(self, backend, mgrs):
        cm, mm = mgrs.communication_manager, mgrs.memory_manager
        if "communication" not in CAPS[backend]:
            assert cm is None
            assert "communication" not in get_backend(backend).factories
            return
        space = mm.memory_spaces()[0]
        payload = np.arange(64, dtype=np.uint8)
        src = mm.register_tensor_slot(space, payload)
        dst = mm.allocate_local_memory_slot(space, 64)
        event = cm.memcpy(dst, 0, src, 0, 64)
        assert event.wait(30), "transfer Event never completed"
        assert event.done()
        got = np.asarray(dst.handle).view(np.uint8).reshape(-1)[:64]
        np.testing.assert_array_equal(got, payload)

    def test_fence_tag_coverage(self, backend, mgrs):
        """fence(tag) returns once the tag's transfers completed, and a tag
        with no recorded transfers fences vacuously (no hang)."""
        cm, mm = mgrs.communication_manager, mgrs.memory_manager
        if cm is None:
            pytest.skip("no communication role (covered above)")
        cm.fence(424242)  # vacuous fence: returns immediately
        space = mm.memory_spaces()[0]
        src = mm.register_tensor_slot(space, np.full(32, 7, dtype=np.uint8))
        dst = mm.allocate_local_memory_slot(space, 32)
        cm.memcpy(dst, 0, src, 0, 32)
        cm.fence(0)  # local-to-local transfers belong to tag 0
        got = np.asarray(dst.handle).view(np.uint8).reshape(-1)[:32]
        np.testing.assert_array_equal(got, np.full(32, 7, dtype=np.uint8))

    def test_global_slot_exchange_capability(self, backend, mgrs):
        cm, mm = mgrs.communication_manager, mgrs.memory_manager
        if cm is None:
            pytest.skip("no communication role (covered above)")
        if backend not in MULTI_INSTANCE:
            with pytest.raises(UnsupportedOperationError):
                cm.exchange_global_memory_slots(next(_TAGS), {})
            return
        tag = next(_TAGS)
        slot = mm.allocate_local_memory_slot(mm.memory_spaces()[0], 16)
        gslots = cm.exchange_global_memory_slots(tag, {3: slot})
        assert set(gslots) == {3}
        assert gslots[3].tag == tag and gslots[3].key == 3
        assert gslots[3].size_bytes == 16


# ---------------------------------------------------------------------------
# channels (frontend contract over the backend's comm capability)
# ---------------------------------------------------------------------------


class TestChannelContract:
    def test_channel_fifo(self, backend, mgrs):
        from repro_torch.frontends.channels import SPSCConsumer, SPSCProducer

        cm, mm = mgrs.communication_manager, mgrs.memory_manager
        if cm is None or backend not in MULTI_INSTANCE:
            if cm is not None:
                with pytest.raises(UnsupportedOperationError):
                    SPSCConsumer(cm, mm, tag=next(_TAGS), capacity=2, msg_size=8)
            return
        tag = next(_TAGS)
        cons = SPSCConsumer.connect_direct(cm, mm, tag=tag, capacity=4, msg_size=8)
        prod = SPSCProducer.connect_direct(cm, mm, tag=tag, capacity=4, msg_size=8)
        for i in range(9):  # wraps the ring twice
            assert prod.try_push(i.to_bytes(8, "little"))
            assert int.from_bytes(cons.try_pop(), "little") == i
        assert cons.try_pop() is None

    def test_channel_oversize_rejected(self, backend, mgrs):
        from repro_torch.frontends.channels import (
            ChannelMessageTooLargeError,
            SPSCConsumer,
            SPSCProducer,
        )

        cm, mm = mgrs.communication_manager, mgrs.memory_manager
        if cm is None or backend not in MULTI_INSTANCE:
            if cm is not None:
                with pytest.raises(UnsupportedOperationError):
                    SPSCProducer(cm, mm, tag=next(_TAGS), capacity=2, msg_size=8)
            return
        tag = next(_TAGS)
        cons = SPSCConsumer.connect_direct(cm, mm, tag=tag, capacity=2, msg_size=8)
        prod = SPSCProducer.connect_direct(cm, mm, tag=tag, capacity=2, msg_size=8)
        with pytest.raises(ChannelMessageTooLargeError):
            prod.try_push(b"x" * 9)
        assert prod.try_push(b"y" * 8)  # ring uncorrupted afterwards
        assert cons.try_pop() == b"y" * 8


# ---------------------------------------------------------------------------
# instances
# ---------------------------------------------------------------------------


class TestInstanceContract:
    def test_root_current_semantics(self, backend, mgrs):
        im = mgrs.instance_manager
        if "instance" not in CAPS[backend]:
            assert im is None
            assert "instance" not in get_backend(backend).factories
            return
        instances = im.get_instances()
        assert len(instances) >= 1
        roots = [i for i in instances if i.is_root()]
        assert len(roots) == 1, "exactly one root instance (tie-break)"
        assert im.get_root_instance() is roots[0]
        current = im.get_current_instance()
        assert current in instances
        assert current in im.live_instances()

    def test_unimplemented_lifecycle_ops_raise(self, backend, mgrs):
        im = mgrs.instance_manager
        if im is None:
            pytest.skip("no instance role (covered above)")
        template = im.create_instance_template(min_compute_resources=1)
        if backend == "hostcpu":
            # template-validated stub path: satisfiable template -> clean
            # capability error; unsatisfiable template -> validation error
            with pytest.raises(UnsupportedOperationError, match="template validated"):
                im.create_instances(1, template)
            bad = im.create_instance_template(min_memory_bytes=1 << 62)
            with pytest.raises(HiCRError) as exc:
                im.create_instances(1, bad)
            assert not isinstance(exc.value, UnsupportedOperationError)
            with pytest.raises(UnsupportedOperationError):
                im.terminate_instance(im.get_current_instance())
        elif backend == "localsim":
            # the conformance world has no entry function: elastic creation
            # must refuse with the capability error, not half-create
            n_before = len(im.get_instances())
            with pytest.raises(UnsupportedOperationError):
                im.create_instances(1, template)
            assert len(im.get_instances()) == n_before

    def test_message_path_capability(self, backend, mgrs):
        im = mgrs.instance_manager
        if im is None:
            pytest.skip("no instance role (covered above)")
        if backend == "localsim":
            me = im.get_current_instance()
            im.send_message(me, b"conformance-ping")
            assert im.recv_message(timeout=10) == b"conformance-ping"
        else:
            with pytest.raises(UnsupportedOperationError):
                im.send_message(im.get_current_instance(), b"x")
            with pytest.raises(UnsupportedOperationError):
                im.recv_message(timeout=0.01)
