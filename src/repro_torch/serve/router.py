"""Data-parallel serving fleet over HiCR instance operations (paper §3.1.1).

The fleet is the serve path's use of the one manager a single-instance
serve leaves idle: a root **router** instance creates N **worker** instances at
runtime through the backend's `InstanceManager` (template → create), wires
each worker with three direct-registered channels (message), load-balances
admissions on worker-reported backpressure, merges the workers' streaming
replies into one client-facing stream, and terminates workers on drain or
kills them under fault injection (terminate). Port of
`repro/serve/router.py`: workers run the port's scheduler on a `torchdev`
Runtime bound to `FleetConfig.device`; nothing else differs.

Every worker is a thread of this process, so on a CUDA device they share
one card and its default stream: a worker's host sync also waits for the
other workers' queued kernels.

Per-worker links (all `connect_direct`, i.e. non-collective — a
runtime-created worker cannot join the launch-time world's collectives,
and a dead worker must never strand survivors in a barrier):

* request channel  — router producer → worker `ChannelServer` consumer
* reply channel    — worker streaming chunks → router consumer
* control channel  — worker `SchedulerProgress` heartbeats (free slots /
  free KV pages / settled counts) → router consumer

Failure handling: the router's liveness sweep reads `Instance.is_live()`
(a terminate or an entry-function failure both end liveness). On a death it
*joins the worker thread first* (`LocalSimWorld.wait_instance`) so the dead
worker can no longer push, drains the reply ring, and requeues every
assigned-but-unfinished request onto survivors — re-prefilled from the
prompt, which is exact because decoding is deterministic. The merge layer
deduplicates by a per-request forwarded-token high-water mark, so a client
sees a token-identical stream whether or not its request was restarted
(the terminal chunk carries ``"restarted": true`` when it was). With zero
live workers the router refuses (error replies), it does not hang.
"""
from __future__ import annotations

import dataclasses
import json
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.definitions import FutureTimeoutError, InstanceFailedError
from repro_torch.core.runtime import Runtime
from repro_torch.frontends.channels import (
    ChannelMessageTooLargeError,
    SPSCConsumer,
    SPSCProducer,
)

from .scheduler import ContinuousBatchingScheduler, Request
from .server import ChannelServer
from .workload import to_wire

#: Channel tag bases; one tag set per worker *rank*. Ranks are never reused,
#: so a respawned worker registers fresh tags and can never collide with a
#: dead predecessor's registrations.
TAG_REQ = 1000
TAG_REPLY = 2000
TAG_CTL = 3000

#: sticky-home affinity map bound (distinct prompt heads remembered)
_HOME_CAP = 4096


@dataclasses.dataclass
class FleetConfig:
    """Knobs shared by the router and every worker it spawns."""

    n_workers: int = 2
    max_batch: int = 4
    max_len: int = 64
    msg_size: int = 512
    stream_interval: int = 2
    req_capacity: int = 8
    reply_capacity: int = 16
    ctl_capacity: int = 8
    kv_mode: str = "dense"
    page_size: int = 16
    sync_interval: int = 4
    pool_pages: Optional[int] = None
    #: per-worker refcounted radix prefix cache (paged mode only); also
    #: switches the router to prefix-affinity admission — requests whose
    #: prompts share a head keep landing on the worker whose cache is warm
    prefix_cache: bool = False
    worker_backend: str = "torchdev"
    #: device every worker's Runtime binds to: None is the current CUDA
    #: device (raising where there is none); ``"cpu"`` runs on the CPU
    device: Optional[str] = None
    #: replace a dead worker with a fresh instance from the same template
    respawn: bool = False
    #: bounded idle park per worker loop — an idle strategy, not a
    #: synchronization point (kill observation is state-based, per tick)
    idle_wait: float = 0.02
    connect_timeout: float = 120.0

    def __post_init__(self):
        # fail HERE, not inside every spawned worker thread: a bad combo
        # would otherwise surface only as "no live workers in the fleet"
        # with the real ValueError buried in stats["worker_errors"]
        if self.prefix_cache and self.kv_mode != "paged":
            raise ValueError(
                "prefix_cache requires kv_mode='paged' (prefixes are shared "
                "as pool pages; dense slots own private caches)"
            )


def make_worker_entry(model, params, cfg: FleetConfig) -> Callable:
    """Entry function for worker instances (the template's prescribed work,
    paper Fig. 7): serve the worker's request channel until the router
    terminates this instance. A terminate observed while requests are in
    flight raises `InstanceFailedError` (abandon ship — the router requeues);
    a terminate observed idle returns the worker's stats cleanly."""

    def worker_main(mgrs, rank: int):
        im = mgrs.instance_manager
        cm, mm = mgrs.communication_manager, mgrs.memory_manager
        me = im.get_current_instance()
        # request consumer registers FIRST so the router's producer
        # rendezvous resolves; reply/ctl producers then wait on the
        # router-registered consumer ends (no circular wait: the router
        # registers those before polling for ours)
        req = SPSCConsumer.connect_direct(
            cm, mm, tag=TAG_REQ + rank, capacity=cfg.req_capacity, msg_size=cfg.msg_size
        )
        reply = SPSCProducer.connect_direct(
            cm, mm, tag=TAG_REPLY + rank, capacity=cfg.reply_capacity,
            msg_size=cfg.msg_size, timeout=cfg.connect_timeout,
        )
        ctl = SPSCProducer.connect_direct(
            cm, mm, tag=TAG_CTL + rank, capacity=cfg.ctl_capacity,
            msg_size=cfg.msg_size, timeout=cfg.connect_timeout,
        )
        with Runtime(cfg.worker_backend, device=cfg.device) as rt:
            sched = ContinuousBatchingScheduler(
                model, params, max_batch=cfg.max_batch, max_len=cfg.max_len,
                runtime=rt, kv_mode=cfg.kv_mode, page_size=cfg.page_size,
                pool_pages=cfg.pool_pages, sync_interval=cfg.sync_interval,
                prefix_cache=cfg.prefix_cache,
            )
            server = ChannelServer(
                sched, req, reply, msg_size=cfg.msg_size,
                stream_interval=cfg.stream_interval,
            )

            def report() -> None:
                prog = sched.active_progress()
                body = {
                    "rank": rank,
                    "free_slots": prog.free_slots,
                    "pages_free": prog.pages_free,
                    "active": sched.active_count,
                    "settled": server.settled,
                    "prefix": prog.prefix,
                }
                # heartbeat: best-effort — a full control ring just means the
                # router has fresher reports than it has drained
                ctl.try_push(json.dumps(body).encode().ljust(cfg.msg_size, b"\0"))

            report()  # initial capacity report unblocks router admission
            while True:
                if not me.is_live():
                    if sched.active_count or not server.idle:
                        err = InstanceFailedError(
                            f"worker rank {rank} terminated with "
                            f"{sched.active_count} active / "
                            f"{server.backlog_size} backlogged request(s)"
                        )
                        # the world keeps the error, and through its
                        # traceback this frame: drop the scheduler first,
                        # so its caches and KV pool are freed when this
                        # thread ends, not with the world
                        del server, sched
                        raise err
                    return {"rank": rank, "settled": server.settled}
                finished = server.tick()
                report()
                if not finished and server.idle:
                    server.wait_for_arrival(cfg.idle_wait)

    return worker_main


@dataclasses.dataclass
class _Flight:
    """Router-side state of one client request across worker attempts."""

    request: Request
    worker: Optional[int] = None  # idx of the worker currently serving it
    forwarded: int = 0            # tokens already forwarded to the client
    attempt_tokens: int = 0       # tokens received in the CURRENT attempt
    restarted: bool = False
    done: bool = False
    #: crc32 of the prompt's head page, computed once at submission — the
    #: sticky-home affinity key (the admission scan runs in the router's
    #: polling hot loop, so the key is never recomputed there)
    head_crc: int = 0


@dataclasses.dataclass
class _WorkerHandle:
    """Router-side view of one worker instance and its three channels."""

    idx: int
    rank: int
    instance: object
    req: SPSCProducer
    reply: SPSCConsumer
    ctl: SPSCConsumer
    alive: bool = True
    reported: bool = False
    free_slots: int = 0
    pages_free: Optional[int] = None
    prefix: Optional[dict] = None  # last reported radix-cache counters
    assigned_since_report: int = 0
    settled: int = 0
    inflight: Dict[str, Request] = dataclasses.field(default_factory=dict)

    def capacity_score(self) -> int:
        """Admission headroom: last reported free slots minus what the
        router has assigned since that report (stale-report guard)."""
        return self.free_slots - self.assigned_since_report


class FleetRouter:
    """Root-instance router: spawn workers, balance admissions, merge
    streams, survive worker deaths. Runs inside the root instance's entry
    function (see `run_fleet`)."""

    def __init__(self, mgrs, cfg: FleetConfig, sink, *, on_forward=None):
        self.im = mgrs.instance_manager
        self.cm = mgrs.communication_manager
        self.mm = mgrs.memory_manager
        self.cfg = cfg
        #: client-facing stream: receives merged chunk dicts via .push()
        self.sink = sink
        #: hook fired after every forwarded chunk — the deterministic
        #: trigger point fault-injection tests kill workers from
        self.on_forward = on_forward
        self.workers: List[_WorkerHandle] = []
        self._flights: Dict[str, _Flight] = {}
        #: prefix-affinity sticky homes: head crc -> worker idx that first
        #: admitted a request with that head (where its cache is warm).
        #: Bounded: oldest stickiness is dropped past _HOME_CAP entries (a
        #: long-forgotten head's pages are LRU-evicted worker-side anyway,
        #: so re-homing it costs nothing but the re-prefill a miss pays)
        self._home: Dict[int, int] = {}
        self._backlog: deque = deque()
        self._done = 0
        self._spawned = 0
        self._killed = 0

    # -- instance lifecycle ---------------------------------------------------
    def spawn_workers(self, count: int) -> None:
        """Template → create → attach: the §3.1.1 creation step."""
        template = self.im.create_instance_template(min_compute_resources=1)
        for inst in self.im.create_instances(count, template):
            self._attach(inst)
        self._spawned += count

    def respawn_worker(self) -> _WorkerHandle:
        """Create one replacement worker from the same template (the
        optional respawn path after a failure). Fresh rank, fresh tags."""
        template = self.im.create_instance_template(min_compute_resources=1)
        [inst] = self.im.create_instances(1, template)
        self._spawned += 1
        return self._attach(inst)

    def _attach(self, inst) -> _WorkerHandle:
        rank = int(inst.instance_id.split("-")[1])
        # consumer ends first (instant direct registration) so the worker's
        # reply/ctl producers can rendezvous; only then block on the
        # worker's request consumer
        reply = SPSCConsumer.connect_direct(
            self.cm, self.mm, tag=TAG_REPLY + rank,
            capacity=self.cfg.reply_capacity, msg_size=self.cfg.msg_size,
        )
        ctl = SPSCConsumer.connect_direct(
            self.cm, self.mm, tag=TAG_CTL + rank,
            capacity=self.cfg.ctl_capacity, msg_size=self.cfg.msg_size,
        )
        req = SPSCProducer.connect_direct(
            self.cm, self.mm, tag=TAG_REQ + rank,
            capacity=self.cfg.req_capacity, msg_size=self.cfg.msg_size,
            timeout=self.cfg.connect_timeout,
        )
        handle = _WorkerHandle(
            idx=len(self.workers), rank=rank, instance=inst,
            req=req, reply=reply, ctl=ctl,
        )
        self.workers.append(handle)
        return handle

    def kill_worker(self, idx: int) -> None:
        """Terminate a worker (fault injection / scale-down). The worker
        observes the status flip at its next tick; the router's liveness
        sweep then requeues whatever it was serving."""
        self.im.terminate_instance(self.workers[idx].instance)
        self._killed += 1

    def shutdown(self) -> None:
        """Clean drain: terminate every live worker (they are idle once
        serve() returned, so they exit returning stats, not raising)."""
        for h in self.workers:
            if h.alive and h.instance.is_live():
                self.im.terminate_instance(h.instance)

    def worker_of(self, rid: str) -> Optional[int]:
        flight = self._flights.get(rid)
        return None if flight is None else flight.worker

    def forwarded_tokens(self, rid: str) -> int:
        flight = self._flights.get(rid)
        return 0 if flight is None else flight.forwarded

    # -- merge layer ----------------------------------------------------------
    def _push_sink(self, chunk: dict) -> None:
        self.sink.push(chunk)
        if self.on_forward is not None:
            self.on_forward(self, chunk.get("id"), chunk)

    def _settle_error(self, rid: Optional[str], message: str) -> None:
        self._push_sink({"id": rid, "error": message})
        flight = self._flights.get(rid)
        if flight is not None and not flight.done:
            flight.done = True
            self._done += 1

    def _on_chunk(self, h: _WorkerHandle, raw: bytes) -> None:
        body = json.loads(bytes(raw).rstrip(b"\0").decode())
        rid = body.get("id")
        if "error" in body:
            # worker-side rejection (malformed/unservable): pass through
            h.inflight.pop(rid, None)
            h.settled += 1
            self._settle_error(rid, body["error"])
            return
        flight = self._flights.get(rid)
        if flight is None or flight.done:
            return  # stale chunk for an already-settled request
        delta = body.get("delta", [])
        start = flight.attempt_tokens
        flight.attempt_tokens += len(delta)
        # dedupe against the forwarded high-water mark: a restarted attempt
        # regenerates the same tokens, so only genuinely new ones pass
        skip = min(len(delta), max(0, flight.forwarded - start))
        fresh = delta[skip:]
        done = bool(body.get("done", False))
        if fresh or done:
            out = {"id": rid, "delta": fresh, "done": done}
            if done:
                out["finish_reason"] = body.get("finish_reason")
                if flight.restarted:
                    out["restarted"] = True
            flight.forwarded += len(fresh)
            if done:
                flight.done = True
                self._done += 1
                h.inflight.pop(rid, None)
                h.settled += 1
            self._push_sink(out)

    def _drain_worker(self, h: _WorkerHandle) -> bool:
        popped = False
        while True:
            raw = h.reply.try_pop()
            if raw is None:
                return popped
            popped = True
            self._on_chunk(h, raw)

    def _drain_ctl(self, h: _WorkerHandle) -> None:
        while True:
            raw = h.ctl.try_pop()
            if raw is None:
                return
            body = json.loads(bytes(raw).rstrip(b"\0").decode())
            h.free_slots = int(body.get("free_slots", 0))
            h.pages_free = body.get("pages_free")
            h.prefix = body.get("prefix")
            h.reported = True
            h.assigned_since_report = 0

    # -- failure handling ------------------------------------------------------
    def _sweep_liveness(self) -> None:
        for h in list(self.workers):  # a respawn appends mid-sweep
            if h.alive and not h.instance.is_live():
                self._handle_death(h)
                if self.cfg.respawn:
                    self.respawn_worker()

    def _handle_death(self, h: _WorkerHandle) -> None:
        h.alive = False
        # deterministic handoff: join the worker thread FIRST so it can no
        # longer push chunks, THEN drain what it did push, THEN requeue —
        # no token can be both forwarded from the old attempt and replayed
        # past the dedupe mark by the new one
        world = getattr(self.im, "world", None)
        if world is not None and hasattr(world, "wait_instance"):
            world.wait_instance(h.rank, timeout=60.0)
        self._drain_worker(h)
        self._drain_ctl(h)
        for rid, request in list(h.inflight.items()):
            flight = self._flights.get(rid)
            if flight is None or flight.done:
                continue
            flight.restarted = True
            flight.worker = None
            flight.attempt_tokens = 0
            # head of the backlog: a restarted request has waited longest
            self._backlog.appendleft(request)
        h.inflight.clear()

    # -- admission -------------------------------------------------------------
    def _head_crc(self, request: Request) -> int:
        head = ",".join(str(t) for t in request.prompt[: self.cfg.page_size])
        return zlib.crc32(head.encode())

    def _request_crc(self, request: Request) -> int:
        flight = self._flights.get(request.rid)
        return flight.head_crc if flight is not None else self._head_crc(request)

    def _least_loaded(self) -> Optional[_WorkerHandle]:
        best = None
        for h in self.workers:
            if not h.alive or not h.reported or h.capacity_score() <= 0:
                continue
            if best is None or h.capacity_score() > best.capacity_score():
                best = h
        return best

    def _pick_worker(self, request: Optional[Request] = None) -> Optional[_WorkerHandle]:
        if request is not None and self.cfg.prefix_cache:
            # sticky-home affinity: a head seen before goes back to the
            # worker that first served it — the one whose radix cache
            # actually holds it. When that home is merely at capacity we
            # WAIT (spilling would re-prefill the whole prefix cold); a
            # dead home drops its stickiness and the head re-homes. A
            # never-seen head has no cache to protect anywhere, so it
            # load-balances like plain mode — unique traffic keeps the
            # whole fleet busy (the home is recorded at admission).
            crc = self._request_crc(request)
            idx = self._home.get(crc)
            if idx is not None:
                h = self.workers[idx]
                if h.alive:
                    if h.reported and h.capacity_score() > 0:
                        return h
                    return None  # warm home busy/unreported: wait
                del self._home[crc]  # home died: re-home below
            return self._least_loaded()
        return self._least_loaded()

    def _admit(self) -> None:
        while self._backlog:
            if not any(h.alive for h in self.workers):
                # total outage: refuse rather than hang
                while self._backlog:
                    r = self._backlog.popleft()
                    self._settle_error(r.rid, "no live workers in the fleet")
                return
            # prefix-affinity mode scans PAST head-of-line requests whose
            # designated worker is busy: a different head may be admissible
            # on an idle worker right now. Same-head order is still FIFO —
            # requests of one head share a designated worker, so an
            # unadmissible head blocks only its own successors.
            if self.cfg.prefix_cache:
                candidates = list(self._backlog)
            else:
                candidates = [self._backlog[0]]
            progress = False
            settled = set()  # ids leaving the backlog this scan (one rebuild)
            for r in candidates:
                h = self._pick_worker(r)
                if h is None:
                    continue  # this head waits; try the next request
                wire = json.dumps(to_wire(r)).encode().ljust(self.cfg.msg_size, b"\0")
                try:
                    pushed = h.req.try_push(wire)
                except ChannelMessageTooLargeError as e:
                    # one unservable request must not take the fleet down:
                    # settle IT with an error reply and keep admitting the rest
                    settled.add(r.rid)
                    self._settle_error(r.rid, f"request exceeds fleet msg_size: {e}")
                    progress = True
                    continue
                if not pushed:
                    # ring full despite reported capacity (stale report):
                    # treat as no headroom until the next report refreshes
                    # it, and re-run the scan against the updated scores
                    h.assigned_since_report = h.free_slots
                    progress = True
                    continue
                settled.add(r.rid)
                h.inflight[r.rid] = r
                h.assigned_since_report += 1
                flight = self._flights[r.rid]
                flight.worker = h.idx
                flight.attempt_tokens = 0
                if self.cfg.prefix_cache:
                    self._home.setdefault(flight.head_crc, h.idx)
                    while len(self._home) > _HOME_CAP:  # drop oldest homes
                        self._home.pop(next(iter(self._home)))
                progress = True
            if settled:
                self._backlog = deque(
                    r for r in self._backlog if r.rid not in settled
                )
            if self.cfg.prefix_cache or not progress:
                # the prefix-mode scan already visited every request, and
                # admissions only consume capacity — a rescan cannot admit
                # more; plain mode keeps draining the head until it stalls
                return

    # -- main loop --------------------------------------------------------------
    def serve(self, requests: Sequence[Request], *, timeout: float = 600.0) -> dict:
        """Drive `requests` through the fleet until every one settled
        (terminal chunk or error reply forwarded). Returns router stats."""
        for r in requests:
            if r.rid in self._flights:
                raise ValueError(f"request id {r.rid!r} already in flight")
            self._flights[r.rid] = _Flight(
                request=r,
                head_crc=self._head_crc(r) if self.cfg.prefix_cache else 0,
            )
            self._backlog.append(r)
        target = self._done + len(requests)
        deadline = time.monotonic() + timeout
        while self._done < target:
            if time.monotonic() >= deadline:
                raise FutureTimeoutError(
                    f"fleet serve(): {target - self._done} request(s) "
                    f"unsettled after {timeout}s"
                )
            self._sweep_liveness()
            progress = False
            for h in self.workers:
                if h.alive:
                    self._drain_ctl(h)
                    progress |= self._drain_worker(h)
            self._admit()
            if not progress:
                time.sleep(0.001)  # idle backoff only; state drives progress
        restarted = sorted(
            rid for rid, fl in self._flights.items() if fl.restarted
        )
        return {
            "requests": len(self._flights),
            "workers_spawned": self._spawned,
            "workers_killed": self._killed,
            "restarted": restarted,
            "per_worker_settled": {h.idx: h.settled for h in self.workers},
            # last reported radix-cache counters per worker (None when the
            # prefix cache is off): the fleet's warm-cache evidence
            "per_worker_prefix": {h.idx: h.prefix for h in self.workers},
        }


class CollectingSink:
    """In-process client-facing stream: keeps every merged chunk in order."""

    def __init__(self):
        self.chunks: List[dict] = []

    def push(self, chunk: dict) -> None:
        self.chunks.append(chunk)


@dataclasses.dataclass
class FleetResult:
    """What `run_fleet` hands back: per-request reassembly, the raw merged
    stream, and router/worker stats."""

    results: Dict[str, dict]
    chunks: List[dict]
    stats: dict


def reassemble(chunks: Sequence[dict]) -> Dict[str, dict]:
    """Client-side reassembly of the merged stream: concatenate deltas per
    id (chunks of one id arrive in order), keep terminal metadata."""
    results: Dict[str, dict] = {}
    for chunk in chunks:
        rid = chunk.get("id")
        if "error" in chunk:
            results[rid] = {"error": chunk["error"]}
            continue
        entry = results.setdefault(
            rid, {"tokens": [], "finish_reason": None, "restarted": False}
        )
        entry["tokens"].extend(chunk.get("delta", []))
        if chunk.get("done"):
            entry["finish_reason"] = chunk.get("finish_reason")
            entry["restarted"] = bool(chunk.get("restarted", False))
    return results


def run_fleet(
    model,
    params,
    requests: Sequence[Request],
    *,
    cfg: Optional[FleetConfig] = None,
    on_forward=None,
    sink=None,
    launch_timeout: float = 600.0,
    **cfg_kwargs,
) -> FleetResult:
    """Assemble and drive a full fleet: a localsim world whose only
    launch-time instance is the router; workers are created at runtime from
    the instance template and reaped after the drain. The worker entry
    function comes from the world's `entry_fn` — exactly the paper's Fig. 7
    elastic-creation shape."""
    from repro_torch.backends.localsim import LocalSimWorld

    if cfg is None:
        cfg = FleetConfig(**cfg_kwargs)
    elif cfg_kwargs:
        cfg = dataclasses.replace(cfg, **cfg_kwargs)
    if sink is None:
        sink = CollectingSink()
    world = LocalSimWorld(1, entry_fn=make_worker_entry(model, params, cfg))

    def router_prog(mgrs, rank):
        router = FleetRouter(mgrs, cfg, sink, on_forward=on_forward)
        router.spawn_workers(cfg.n_workers)
        try:
            stats = router.serve(requests, timeout=launch_timeout * 0.9)
        finally:
            router.shutdown()
        return stats

    try:
        stats = world.launch(router_prog, timeout=launch_timeout)[0]
        world.join_elastic(timeout=60.0, raise_on_error=False)
        errors = world.instance_errors()
    finally:
        world.shutdown()
    stats = dict(stats)
    stats["worker_errors"] = {rank: repr(err) for rank, err in errors.items()}
    return FleetResult(
        results=reassemble(sink.chunks), chunks=list(sink.chunks), stats=stats
    )
