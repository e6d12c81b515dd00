"""The port's kernel layer under threads, as the serving fleet's workers
(threads of one process) drive it.

* `build.load` builds the library once whichever threads ask at the same
  time (the build is stubbed: there is no `nvcc` here).
* Every wrapper counts its launches through `build.count_launch`, under one
  lock: increments from many threads add up exactly, and
  `ops.reset_launch_counts` zeroes them under the same lock.
"""
import sys
import threading
import time

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import (  # noqa: E402
    build,
    decode_attention,
    flash_attention,
    fused_linear,
    linear_scan,
    ops,
    paged_decode_attention,
)

WRAPPERS = {
    "flash_attention": flash_attention,
    "decode_attention": decode_attention,
    "paged_decode_attention": paged_decode_attention,
    "gated_linear_scan": linear_scan,
    "fused_linear": fused_linear,
}


@pytest.fixture
def fast_switching():
    """Switch threads every microsecond, so unguarded read-modify-writes
    would interleave."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(old)


def test_load_builds_once_from_many_threads(monkeypatch):
    calls = []

    def slow_build(*, verbose=False):
        calls.append(threading.get_ident())
        time.sleep(0.05)  # every other thread arrives while this one builds
        return "libstub.so", "log"

    libs = []
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("loaded", path))
    start = threading.Barrier(4)

    def worker():
        start.wait()
        libs.append(build.load())

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "a loading thread hung"
    assert len(calls) == 1, f"built {len(calls)} times"
    assert libs == [("loaded", "libstub.so")] * 4
    assert build.build_log() == "log"


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_launch_counts_add_up_exactly_across_threads(name, fast_switching):
    mod = WRAPPERS[name]
    kinds = sorted(mod.variant_launches)
    n_threads, per_thread = 8, 2000
    ops.reset_launch_counts()
    start = threading.Barrier(n_threads)

    def worker(i):
        start.wait()
        for _ in range(per_thread):
            build.count_launch(mod.__name__, kinds[i % len(kinds)])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "a counting thread hung"
        assert ops.launch_counts()[name] == n_threads * per_thread
        want = {k: per_thread * sum(1 for i in range(n_threads) if kinds[i % len(kinds)] == k)
                for k in kinds}
        assert ops.variant_counts()[name] == want
        assert all(v == 0 for k, v in ops.launch_counts().items() if k != name)
    finally:
        ops.reset_launch_counts()
    assert ops.launch_counts()[name] == 0 and set(ops.variant_counts()[name].values()) == {0}


def test_count_and_reset_wait_for_the_shared_lock():
    """A count (or a reset) made while another thread holds the lock lands
    only once that thread lets go: no increment is lost between the read
    and the write of another thread's update."""
    ops.reset_launch_counts()
    kind = sorted(flash_attention.variant_launches)[0]
    try:
        with build.COUNT_LOCK:
            t = threading.Thread(target=build.count_launch, args=(flash_attention.__name__, kind))
            t.start()
            t.join(timeout=0.2)
            assert t.is_alive() and flash_attention.launches == 0
        t.join(timeout=30)
        assert not t.is_alive()
        assert flash_attention.launches == 1 and flash_attention.variant_launches[kind] == 1
        with build.COUNT_LOCK:
            t = threading.Thread(target=ops.reset_launch_counts)
            t.start()
            t.join(timeout=0.2)
            assert t.is_alive() and flash_attention.launches == 1
        t.join(timeout=30)
        assert not t.is_alive() and flash_attention.launches == 0
    finally:
        ops.reset_launch_counts()
