"""Serving on the port: paged KV pool (`kv_pool`), paged device-resident
decoder (`batching`), continuous-batching scheduler (`scheduler`) and the
synthetic workload generator (`workload`)."""
from . import batching, kv_pool, scheduler, workload  # noqa: F401
