"""Quickstart on the PyTorch port: a tour of the HiCR model, reproducing the
paper's Figs. 4-7 in runnable form, and the unified async completion API.
Port of `examples/quickstart.py`; a host program, as the reference's is.

    PYTHONPATH=src python examples/quickstart_torch.py
"""
from __future__ import annotations

import numpy as np

from repro_torch.backends.localsim import LocalSimWorld
from repro_torch.core import Runtime, wait_all, wait_any
from repro_torch.core.registry import build, capability_table


def fig4():
    """Fig. 4 -- backend instantiation: the application below only ever sees
    the abstract manager classes; swapping this block swaps the technology.
    Returns the (topology, memory, communication, compute) managers."""
    tm = build("hostcpu", "topology")           # HWLoc analog
    mm = build("hostcpu", "memory")             # host malloc/free
    cmm = build("hostcpu", "communication")     # memcpy + fence
    cpm = build("hostcpu", "compute")           # Pthreads analog
    print("backend capability table (paper Table 1):")
    for name, roles in capability_table().items():
        marks = " ".join(r[0].upper() if ok else "." for r, ok in roles.items())
        print(f"  {name:<10} {marks}")
    return tm, mm, cmm, cpm


def fig5(tm, mm, cmm) -> int:
    """Fig. 5 -- broadcast a message buffer into every memory space of every
    device. Returns the number of targets."""
    topology = tm.query_topology()
    message = mm.allocate_local_memory_slot(mm.memory_spaces()[0], 64)
    message.handle[:] = np.frombuffer(b"HiCR says hello".ljust(64, b"\0"), dtype=np.uint8)
    targets = []
    for device in topology.get_devices():
        for space in device.get_memory_spaces():
            dst = mm.allocate_local_memory_slot(space, 64)
            cmm.memcpy(dst, 0, message, 0, 64)
            targets.append(dst)
    cmm.fence()  # wait for all transfers to finish
    assert all(bytes(t.handle[:15]) == b"HiCR says hello" for t in targets)
    print(f"\nFig.5: message broadcast to {len(targets)} memory space(s)")
    return len(targets)


def fig6(tm, cpm) -> list:
    """Fig. 6 -- run an execution unit on every compute resource (at most 8)
    in parallel. Returns the results, i * i on resource i."""
    unit = cpm.create_execution_unit(lambda i: i * i, name="square")
    pus, states = [], []
    for i, resource in enumerate(tm.query_topology().all_compute_resources()[:8]):
        pu = cpm.create_processing_unit(resource)
        state = cpm.create_execution_state(unit, i)
        cpm.initialize(pu)
        cpm.execute(pu, state)
        pus.append(pu)
        states.append(state)
    for pu in pus:
        cpm.await_(pu)
    for pu in pus:
        cpm.finalize(pu)
    squares = [s.get_result() for s in states]
    print(f"Fig.6: parallel execution on {len(pus)} cores ->", squares)
    return squares


def async_api() -> list:
    """The unified async completion API: a context-managed Runtime (its
    default processing unit is finalized on exit, never leaked), futures
    from submit(), transfer events from memcpy(), and wait_all/wait_any to
    multiplex them. §3.1.4-3.1.5: completion is NOT guaranteed when the call
    returns; these objects are how you ask. Returns the futures' results."""
    with Runtime("hostcpu") as rt:
        square = rt.create_execution_unit(lambda i: i * i, name="square")
        futures = [rt.submit(square, i) for i in range(6)]
        first = wait_any(futures)          # whichever the OS scheduler ran first
        wait_all(futures)                  # barrier over the rest
        results = [f.result() for f in futures]
        print("\nasync API: submit -> futures -> wait_all ->", results,
              f"(first done: {first.result()})")

        mm2, cmm2 = rt.memory_manager, rt.communication_manager
        a = mm2.allocate_local_memory_slot(mm2.memory_spaces()[0], 64)
        b = mm2.allocate_local_memory_slot(mm2.memory_spaces()[0], 64)
        a.handle[:6] = np.frombuffer(b"events", dtype=np.uint8)
        transfer = cmm2.memcpy(b, 0, a, 0, 64)   # an Event, not a blind wait
        transfer.add_callback(lambda ev: print(f"async API: transfer {ev.name} completed"))
        transfer.wait()
        assert bytes(b.handle[:6]) == b"events"
    # rt.finalize() ran on exit: the default PU's worker thread is gone
    return results


def fig7(desired: int = 4) -> int:
    """Fig. 7 -- instance management: top up the world to `desired`
    instances at run time (the elastic path, the localsim backend standing in
    for a cloud API). Returns the world's size afterwards."""
    greetings = []

    def entry(mgrs, rank):
        greetings.append(rank)
        return f"instance-{rank} up"

    def ensure_instances(mgrs, rank):
        im = mgrs.instance_manager
        if not im.get_current_instance().is_root():
            return "not-root"
        current = len(im.get_instances())
        if current >= desired:
            return "enough"
        template = im.create_instance_template(min_compute_resources=1)
        im.create_instances(desired - current, template)
        return f"created {desired - current}"

    world = LocalSimWorld(2, entry_fn=entry)
    try:
        results = world.launch(ensure_instances)
        world.join_elastic()
        size = len(world.instances)
        print(f"Fig.7: root says '{results[0]}'; world now has {size} instances "
              f"(elastic ranks: {sorted(greetings)})")
    finally:
        world.shutdown()
    return size


def main(argv=None) -> None:
    tm, mm, cmm, cpm = fig4()
    fig5(tm, mm, cmm)
    fig6(tm, cpm)
    async_api()
    fig7()
    print("\nquickstart complete.")


if __name__ == "__main__":
    main()
