"""Serving on the port: paged KV pool (`kv_pool`), the dense and paged
decoders (`batching`), the refcounted prefix radix cache (`prefix_cache`),
the continuous-batching scheduler (`scheduler`), the serial engine
(`engine`), the HiCR-channel front door (`server`), the multi-instance
router/worker fleet over InstanceManager (`router`) and the synthetic
workload generator (`workload`)."""
from . import (  # noqa: F401
    batching,
    engine,
    kv_pool,
    prefix_cache,
    router,
    scheduler,
    server,
    workload,
)
