"""No module whose top-level name is `jax`, `jaxlib`, `flax` or the JAX
package's (`repro`) is loaded by a run, and the plain reference loads
nothing of the port. Checked in fresh processes, with top-level names
compared whole (the port's name begins with the JAX package's)."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RUN = """
import json, sys
from perfbench import bench, testing
from perfbench.drivers import serve_closed_loop, train_steps
serve_closed_loop.run(testing.small_job(testing.SERVE, seconds=2.0))
train_steps.run(testing.small_job(testing.TRAIN, seconds=2.0))
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import perfbench.reference.dense_lm
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _top_level_modules(code):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    names = _top_level_modules(RUN)
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level_modules(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_no_file_of_the_benchmark_reads_the_old_benchmarks():
    for path in ROOT.joinpath("perfbench").rglob("*.py"):
        if path.name.startswith("test_perfbench"):
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "import jax" not in text, path
