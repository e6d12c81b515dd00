"""Coroutine backend: the Boost.Context analog (paper §4.2).

Execution units are single (generator) functions; execution states are
coroutines that can be suspended and resumed at arbitrary points without OS
scheduler intervention. This is the only built-in compute backend with
``supports_suspension = True`` — mirroring the paper, where only the Boost
backend provides suspendable execution states.

A plain (non-generator) callable is also accepted; it simply runs to
completion on the first step.
"""
from __future__ import annotations

import inspect
from typing import Sequence

from repro_torch.core.definitions import (
    ExecutionStateStatus,
    LifetimeError,
    ProcessingUnitStatus,
)
from repro_torch.core.events import Future
from repro_torch.core.managers import ComputeManager
from repro_torch.core.stateful import ExecutionState, ProcessingUnit
from repro_torch.core.stateless import ComputeResource, ExecutionUnit


class CoroutineComputeManager(ComputeManager):
    backend_name = "coroutine"
    supported_formats = ("generator", "python-callable")
    supports_suspension = True

    def create_processing_unit(self, resource: ComputeResource) -> ProcessingUnit:
        return ProcessingUnit(resource)

    def create_execution_state(self, unit: ExecutionUnit, *args, **kwargs) -> ExecutionState:
        self.check_format(unit)
        state = ExecutionState(unit, args, kwargs)
        if inspect.isgeneratorfunction(unit.fn):
            state.continuation = unit.fn(*args, **kwargs)
        else:
            state.continuation = None  # plain callable: run-to-completion
        state.status = ExecutionStateStatus.READY
        return state

    def initialize(self, pu: ProcessingUnit) -> None:
        # The caller's own context hosts the coroutine: nothing to start.
        pu.status = ProcessingUnitStatus.READY

    # -- stepping -----------------------------------------------------------
    def step(self, state: ExecutionState) -> bool:
        """Advance a coroutine to its next suspension point. Returns True when
        the execution state reached FINISHED."""
        if state.is_finished():
            raise LifetimeError("finished execution states cannot be re-used")
        if state.continuation is None:
            state.mark_executing()
            try:
                state.mark_finished(result=state.execution_unit.fn(*state.args, **state.kwargs))
            except BaseException as e:  # noqa: BLE001
                state.mark_finished(error=e)
            return True
        state.mark_executing()
        try:
            yielded = next(state.continuation)
            state.mark_suspended()
            state.last_yield = yielded
            return False
        except StopIteration as stop:
            state.mark_finished(result=stop.value)
            return True
        except BaseException as e:  # noqa: BLE001
            state.mark_finished(error=e)
            return True

    def execute(self, pu: ProcessingUnit, state: ExecutionState) -> Future:
        """Run the coroutine to completion on the caller's context (stepping
        through every suspension point). The returned Future is therefore
        already resolved — coroutines have no independent thread of control."""
        pu.check_ready()
        pu.current_state = state
        pu.status = ProcessingUnitStatus.EXECUTING
        while not self.step(state):
            pass
        pu.status = ProcessingUnitStatus.READY
        return state.future

    def execute_step(self, pu: ProcessingUnit, state: ExecutionState) -> bool:
        """Advance one suspension point only (used by tasking workers)."""
        pu.check_ready()
        pu.current_state = state
        finished = self.step(state)
        if finished:
            pu.current_state = None
        return finished

    def suspend(self, pu: ProcessingUnit) -> None:
        # Suspension happens cooperatively at yield points; marking the PU is
        # all that is needed at this level.
        pu.status = ProcessingUnitStatus.SUSPENDED

    def resume(self, pu: ProcessingUnit) -> None:
        pu.status = ProcessingUnitStatus.READY

    def await_(self, pu: ProcessingUnit) -> None:
        state = pu.current_state
        if state is not None and not state.is_finished():
            while not self.step(state):
                pass
        pu.status = ProcessingUnitStatus.READY

    def finalize(self, pu: ProcessingUnit) -> None:
        pu.status = ProcessingUnitStatus.TERMINATED
        pu.current_state = None
