"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line. Everything
that belongs to one configuration, traffic mix or per-layer metric is a file
of its own, found by the name `BENCHMARK.json` gives it:

* `configs/<config>.json`: the published sizes, the cut, what is assumed;
* `traffic/<mix>.json`: the driver kind and its parameters;
* `limits/<cell>.json`: the limit of each number the correctness check compares;
* `metrics/<metric>.py`: one reader a per-layer metric;
* `roofline/<kernel>.py`: the work of one kernel's call, from its shapes;
* `drivers/<kind>.py`: the measured window of one kind of traffic;
* `reference/`: the plain PyTorch reference that decides `correct`.

Nothing here imports `jax` or the JAX package, and the reference imports
nothing of the port.
"""
