"""Runtime facade: a ManagerSet assembled from the backend registry by name.

The paper's usage pattern (Fig. 4) has the *launcher* instantiate concrete
backends and hand the application abstract manager references. `Runtime`
packages that pattern: callers name a backend (``"hostcpu"``, ``"jaxdev"``,
...) and receive a ready `ManagerSet` built through ``registry.build()`` —
no application-level import of concrete backend modules, so the serving and
launch layers stay backend-agnostic.

A Runtime also owns a default processing unit (first compute resource of the
queried topology) and offers the execution entry points of the unified
completion API: ``submit()`` dispatches an execution unit and returns its
`Future`; ``drive()`` is an event-driven loop multiplexing in-flight
completion objects (compute futures, transfer events, channel ops);
``run()`` is the synchronous shim (dispatch and block; not tracked for
``drive()``). A Runtime is a context manager — ``with Runtime(...) as rt:``
finalizes the default processing unit on exit, so worker threads are never
leaked.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, Mapping, Optional, Sequence

from . import registry
from .definitions import HiCRError
from .events import Event, Future
from .managers import ManagerSet
from .stateful import ProcessingUnit
from .stateless import ExecutionUnit, Topology

#: Roles a Runtime will try to build, in build order.
_ASSEMBLY_ROLES = ("topology", "memory", "communication", "compute", "instance")


class RuntimeAssemblyError(HiCRError):
    """A manager role could not be instantiated from the registry."""


class Runtime:
    """Backend-agnostic application runtime over registry-built managers.

    Parameters
    ----------
    backend:
        Registry name of the primary backend. Every role it implements is
        instantiated (roles whose factories need launch-time context, e.g.
        localsim's world handle, raise `RuntimeAssemblyError` with guidance).
    overrides:
        Optional ``role -> backend_name`` mapping that sources individual
        roles from a different backend (the paper's mix-and-match table 1
        usage, e.g. hostcpu topology + jaxdev compute).
    role_kwargs:
        Optional ``role -> kwargs`` passed to that role's factory.
    device:
        Optional device every role built from `backend` binds to (torchdev:
        ``"cuda"``, ``"cuda:1"`` or ``"cpu"``); None lets the backend choose.
    """

    def __init__(
        self,
        backend: str = "hostcpu",
        *,
        overrides: Optional[Mapping[str, str]] = None,
        role_kwargs: Optional[Mapping[str, Mapping]] = None,
        device: Optional[str] = None,
    ):
        self.backend = backend
        overrides = dict(overrides or {})
        role_kwargs = dict(role_kwargs or {})
        info = registry.get_backend(backend)
        built: dict[str, object] = {}
        for role in _ASSEMBLY_ROLES:
            src = overrides.get(role, backend if role in info.factories else None)
            if src is None:
                continue
            kwargs = dict(role_kwargs.get(role, {}))
            if device is not None and src == backend:
                kwargs.setdefault("device", device)
            try:
                built[role] = registry.build(src, role, **kwargs)
            except TypeError as e:
                raise RuntimeAssemblyError(
                    f"backend {src!r} role {role!r} needs launch-time context "
                    f"({e}); pass role_kwargs or construct the manager directly"
                ) from e
        self.managers = ManagerSet(
            instance_manager=built.get("instance"),
            topology_managers=(built["topology"],) if "topology" in built else (),
            memory_manager=built.get("memory"),
            communication_manager=built.get("communication"),
            compute_manager=built.get("compute"),
        )
        self._pu: Optional[ProcessingUnit] = None
        self._topology: Optional[Topology] = None
        self._inflight: list[Future] = []

    # -- manager access -----------------------------------------------------
    @property
    def compute_manager(self):
        if self.managers.compute_manager is None:
            raise RuntimeAssemblyError(f"backend {self.backend!r} has no compute role")
        return self.managers.compute_manager

    @property
    def memory_manager(self):
        return self.managers.memory_manager

    @property
    def communication_manager(self):
        return self.managers.communication_manager

    @property
    def instance_manager(self):
        return self.managers.instance_manager

    # -- instance lifecycle (paper §3.1.1) -----------------------------------
    def _require_instance_manager(self):
        im = self.managers.instance_manager
        if im is None:
            raise RuntimeAssemblyError(
                f"backend {self.backend!r} has no instance role; override it "
                "from a backend that does (e.g. hostcpu for the validated "
                "single-instance view, localsim for elastic instances)"
            )
        return im

    def instances(self):
        """All launch-time + runtime-created instances (paper §3.1.1)."""
        return self._require_instance_manager().get_instances()

    def live_instances(self):
        return self._require_instance_manager().live_instances()

    def create_instances(self, count: int, template=None, **requirements):
        """Create `count` instances from `template` (or from `requirements`
        via `create_instance_template`) — the template → create step of the
        paper's instance operations. Backends without elastic creation raise
        `UnsupportedOperationError` after validating the template."""
        im = self._require_instance_manager()
        if template is None:
            template = im.create_instance_template(**requirements)
        return im.create_instances(count, template)

    def terminate_instance(self, instance) -> None:
        self._require_instance_manager().terminate_instance(instance)

    def query_topology(self) -> Topology:
        if self._topology is None:
            if not self.managers.topology_managers:
                raise RuntimeAssemblyError(
                    f"backend {self.backend!r} has no topology role; override "
                    "it from a backend that does (e.g. hostcpu)"
                )
            self._topology = self.managers.query_full_topology()
        return self._topology

    # -- execution helpers --------------------------------------------------
    @property
    def processing_unit(self) -> ProcessingUnit:
        """Default PU: first compute resource of the topology, initialized."""
        if self._pu is None:
            resources = self.query_topology().all_compute_resources()
            if not resources:
                raise RuntimeAssemblyError("topology exposes no compute resources")
            cm = self.compute_manager
            self._pu = cm.create_processing_unit(resources[0])
            cm.initialize(self._pu)
        return self._pu

    def create_execution_unit(self, fn, *, name: str = "anonymous", **kwargs) -> ExecutionUnit:
        return self.compute_manager.create_execution_unit(fn, name=name, **kwargs)

    def submit(self, unit: ExecutionUnit, *args, **kwargs) -> Future:
        """Asynchronous execution: create a state for `unit`, dispatch it on
        the default processing unit, and return its completion Future. The
        future is also tracked for `drive()`."""
        cm = self.compute_manager
        state = cm.create_execution_state(unit, *args, **kwargs)
        future = cm.execute(self.processing_unit, state)
        if len(self._inflight) > 64:
            self._prune_inflight()
        self._inflight.append(future)
        return future

    def _prune_inflight(self) -> None:
        """Drop settled futures by removal, never by rebinding the list — a
        done() call may fire a completion callback that submit()s more work
        onto the same list, and a rebind/slice-assign would drop it."""
        for future in [f for f in self._inflight if f.done()]:
            try:
                self._inflight.remove(future)
            except ValueError:  # pragma: no cover - already removed
                pass

    def run(self, unit: ExecutionUnit, *args, **kwargs):
        """Synchronous shim: dispatch, block, return/raise. Unlike `submit`,
        the future is not tracked for `drive()`: it is settled when this
        returns, and tracking it would keep its arguments and result alive
        until the next prune (64 calls later) -- a recurrent model's decode
        returns fresh states every tick, so that held 64 ticks of slot
        states."""
        cm = self.compute_manager
        state = cm.create_execution_state(unit, *args, **kwargs)
        return cm.execute(self.processing_unit, state).result()

    def drive(
        self,
        events: Optional[Iterable[Event]] = None,
        *,
        until: Optional[Callable[[], bool]] = None,
        timeout: Optional[float] = None,
    ) -> bool:
        """Event-driven completion loop: repeatedly poll the given completion
        objects (default: every future submitted through this Runtime),
        firing their callbacks as they complete, until all are done — or
        `until()` turns true — or `timeout` elapses (returns False then).

        This is the multiplexing point the blocking API lacks: one loop can
        overlap compute futures, transfer events, channel pops, and RPC
        replies without prescribing an order of completion.
        """
        explicit = None if events is None else list(events)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if explicit is None:
                # prune the live list every pass: a completion callback may
                # submit() follow-up work mid-drive, and it must be driven too
                self._prune_inflight()
                pending = self._inflight
            else:
                explicit = [e for e in explicit if not e.done()]
                pending = explicit
            if until is not None:
                if until():
                    return True
            elif not pending:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0)

    def finalize(self) -> None:
        if self._pu is not None:
            self.compute_manager.finalize(self._pu)
            self._pu = None

    # -- context management: never leak the default PU -----------------------
    def __enter__(self) -> "Runtime":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finalize()
