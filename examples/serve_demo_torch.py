"""Continuous-batching serving demo of the PyTorch port, with the request
front door on HiCR channels, in two acts. Port of `examples/serve_demo.py`.

1. **Single server, channel front door** -- two producer instances stream
   requests of different prompt/decode lengths into an MPSC channel; one
   server instance drains them per scheduler tick, interleaves
   prefill/decode across slots, and **streams** replies over per-client
   SPSC channels (localsim fabric, 3 instances) -- delta chunks every
   `STREAM_INTERVAL` decode ticks, terminal chunk on completion.
2. **Data-parallel fleet** -- a root router instance spawns 2 worker
   instances at run time through `InstanceManager.create_instances` (paper
   §3.1.1: template -> create -> message -> terminate), load-balances the
   same kind of workload across their schedulers on reported backpressure,
   and merges the worker streams into one client-facing stream.

    PYTHONPATH=src python examples/serve_demo_torch.py [--device cpu]

The model is REDUCED gemma3-1b with seeded weights; the server's and the
workers' runtimes are `torchdev` on the card (``--device cpu``: the CPU,
the kernels' plain versions standing in). `serve_channels` and
`serve_fleet` take any config's model and parameters: the full-width
gemma3-1b runs through the same functions.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.backends import torchdev
from repro_torch.backends.localsim import LocalSimWorld
from repro_torch.configs import get_config
from repro_torch.core.runtime import Runtime
from repro_torch.frontends.channels import (
    MPSCNonLockingConsumer,
    MPSCNonLockingProducer,
    SPSCConsumer,
    SPSCProducer,
)
from repro_torch.models import build
from repro_torch.serve.router import FleetResult, run_fleet
from repro_torch.serve.scheduler import ContinuousBatchingScheduler
from repro_torch.serve.server import ChannelServer
from repro_torch.serve.workload import synthetic_requests, to_wire

MSG = 512
N_CLIENTS = 2
REQS_PER_CLIENT = 3
STREAM_INTERVAL = 2  # delta chunk every 2 decode ticks
N_WORKERS = 2
MAX_BATCH = 4
MAX_LEN = 32


def client_requests(vocab_size: int, rank: int) -> list:
    """Client `rank`'s workload (wire bodies): varied prompt and decode
    lengths."""
    return [
        to_wire(r)
        for r in synthetic_requests(
            vocab_size, REQS_PER_CLIENT, prompt_range=(3, 9),
            steps_range=(2, 10), seed=rank, rid_prefix=f"c{rank}",
        )
    ]


def fleet_requests(vocab_size: int) -> list:
    """Act 2's workload."""
    return synthetic_requests(vocab_size, 6, prompt_range=(3, 9), steps_range=(2, 10), seed=7,
                              rid_prefix="fleet")


def make_program(model, params, device):
    """The localsim program of act 1: rank 0 serves, ranks 1.. are clients."""
    vocab_size = model.cfg.vocab_size

    def program(mgrs, rank):
        # Slot exchange is COLLECTIVE (paper §3.1.4): every instance takes part
        # in every tag's exchange in the same order (request tag 1, then one
        # reply tag per client), volunteering zero slots where it is not an
        # endpoint.
        cm, mm = mgrs.communication_manager, mgrs.memory_manager
        if rank == 0:  # the server instance
            req = MPSCNonLockingConsumer(cm, mm, tag=1, capacity=8, msg_size=MSG,
                                         n_producers=N_CLIENTS)
            reply_chans = {
                f"c{c + 1}": SPSCProducer(cm, mm, tag=10 + c, capacity=8, msg_size=MSG)
                for c in range(N_CLIENTS)
            }

            class Router:
                """Routes each reply to its client's SPSC channel by id prefix."""

                def push(self, msg):
                    body = json.loads(bytes(msg).rstrip(b"\0").decode())
                    reply_chans[body["id"].split("-")[0]].push(msg)

            with Runtime("torchdev", device=device) as rt:
                sched = ContinuousBatchingScheduler(model, params, max_batch=MAX_BATCH,
                                                    max_len=MAX_LEN, runtime=rt)
                server = ChannelServer(sched, req, Router(), msg_size=MSG,
                                       stream_interval=STREAM_INTERVAL)
                ticks = server.serve(n_requests=N_CLIENTS * REQS_PER_CLIENT)
            return {"requests": N_CLIENTS * REQS_PER_CLIENT, "ticks": ticks}
        # a client instance
        cidx = rank - 1
        prod = MPSCNonLockingProducer(cm, mm, tag=1, capacity=8, msg_size=MSG,
                                      producer_index=cidx)
        reply = None
        for c in range(N_CLIENTS):
            if c == cidx:
                reply = SPSCConsumer(cm, mm, tag=10 + c, capacity=8, msg_size=MSG)
            else:
                cm.exchange_global_memory_slots(10 + c, {})  # not an endpoint
        reqs = client_requests(vocab_size, rank)
        for r in reqs:
            prod.push(json.dumps(r).encode().ljust(MSG, b"\0"))
        # Streaming client: reassemble each request's tokens from delta chunks
        # (chunks of one id arrive in order; ids interleave freely).
        got, chunks, done = {}, {}, set()
        while len(done) < len(reqs):
            chunk = json.loads(reply.pop(timeout=300).rstrip(b"\0").decode())
            rid = chunk["id"]
            got.setdefault(rid, []).extend(chunk["delta"])
            chunks[rid] = chunks.get(rid, 0) + 1
            if chunk["done"]:
                done.add(rid)
        return {rid: (toks, chunks[rid]) for rid, toks in got.items()}

    return program


def serve_channels(model, params, device):
    """Act 1. Returns (the server's {"requests", "ticks"}, {rid: (tokens,
    number of chunks)} over every client)."""
    world = LocalSimWorld(1 + N_CLIENTS)
    try:
        results = world.launch(make_program(model, params, device), timeout=600)
    finally:
        world.shutdown()
    replies = {}
    for rank in range(1, 1 + N_CLIENTS):
        replies.update(results[rank])
    return results[0], replies


def serve_fleet(model, params, device) -> FleetResult:
    """Act 2: the router and `N_WORKERS` workers created at run time, each
    worker's runtime on `device`."""
    return run_fleet(model, params, fleet_requests(model.cfg.vocab_size), n_workers=N_WORKERS,
                     max_batch=MAX_BATCH, max_len=MAX_LEN, stream_interval=STREAM_INTERVAL,
                     device=str(device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = torchdev.resolve_device(args.device)  # no card: raises, unless --device cpu
    cfg = get_config("gemma3-1b", reduced=True)
    model = build(cfg)
    params = model.init(seed=0, device=device)

    print(f"continuous-batching serve: {N_CLIENTS} producers x {REQS_PER_CLIENT} "
          f"requests -> MPSC -> scheduler -> per-client streaming replies "
          f"(delta every {STREAM_INTERVAL} ticks)")
    server, replies = serve_channels(model, params, device)
    print(f"server: served {server['requests']} requests in {server['ticks']} decode ticks")
    for rid, (tokens, n_chunks) in sorted(replies.items()):
        print(f"  {rid}: {tokens} ({n_chunks} chunks)")

    print(f"\nfleet serve: router spawns {N_WORKERS} worker instances "
          f"(InstanceManager.create_instances) and merges their streams")
    out = serve_fleet(model, params, device)
    for rid, res in sorted(out.results.items()):
        print(f"  {rid}: {res['tokens']} ({res['finish_reason']})")
    print(f"fleet stats: per-worker settled {out.stats['per_worker_settled']}, "
          f"{len(out.chunks)} merged chunks, restarted={out.stats['restarted']}")
    return replies, out


if __name__ == "__main__":
    main()
