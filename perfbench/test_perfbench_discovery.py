"""A configuration, a traffic mix or a per-layer metric is added by adding
files and BENCHMARK.json entries, with no edit: in a copy of the benchmark
with one more mix and one more metric, the harness finds both by name."""
import json
import shutil
from pathlib import Path

from perfbench import bench

ROOT = Path(__file__).resolve().parent.parent


def test_new_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = dict(bench.traffic("code-completion", tmp_path), prompt_tokens=[6144, 8064])
    (tmp_path / "perfbench" / "traffic" / "long-file.json").write_text(json.dumps(mix))
    (tmp_path / "perfbench" / "metrics" / "admissions.serve.py").write_text(
        "def read(ctx):\n    return float(sum(s.name == 'admit' for s in ctx.spans))\n")
    b = bench.benchmark(tmp_path)
    b["workloads"].append({"name": "granite-20b.long-file", "config": "granite-20b",
                           "traffic": "long-file", "chips": 1, "why": "long files"})
    b["per_layer"].append({"name": "admissions.serve", "unit": "requests", "better": "higher",
                           "source": "program_span", "layer": "scheduler",
                           "moves": "ttft_p90_ms", "workloads": ["granite-20b.long-file"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = bench.workload("granite-20b.long-file", tmp_path)
    assert bench.traffic(cell["traffic"], tmp_path)["prompt_tokens"] == [6144, 8064]
    assert bench.config(cell["config"], tmp_path)["n_layer"] == 52
    names = [m["name"] for m in bench.cell_metrics("per_layer", cell["name"], tmp_path)]
    assert names == ["admissions.serve"]
    ctx = bench.ReadContext(cell=cell["name"], config={}, traffic={}, arch=None, t0=0, t1=1,
                            spans=[bench.Span("admit", 0.1, 0.2)], counters={}, trace=None,
                            peaks=None)
    assert bench.read_per_layer(ctx, tmp_path) == {
        "admissions.serve": {"value": 1.0, "unit": "requests"}}
    assert "admissions.serve" not in [m["name"] for m in bench.cell_metrics(
        "per_layer", "granite-20b.code-completion", tmp_path)]
