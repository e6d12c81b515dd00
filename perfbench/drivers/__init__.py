"""The measured windows, one module a kind of traffic (`traffic/*.json`'s
"driver"). Each has `run(job) -> Outcome`."""
