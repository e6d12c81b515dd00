"""Serving on the port: paged KV pool (`kv_pool`), the dense and paged
decoders (`batching`), the continuous-batching scheduler (`scheduler`), the
serial engine (`engine`) and the synthetic workload generator
(`workload`)."""
from . import batching, engine, kv_pool, scheduler, workload  # noqa: F401
