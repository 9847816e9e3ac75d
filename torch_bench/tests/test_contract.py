"""BENCHMARK.json against the benchmark's contract, and the harness's shape:
files found by name, the result line's keys, no JAX."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "torch_bench/run.py"]
    assert BENCH["paths"] == ["torch_bench"]
    assert isinstance(BENCH["run_seconds"], int) and 10 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_names_units_and_texts():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("torch_bench/")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_end_to_end_metrics_and_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if reports(w["name"], m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(reports(w["name"], m) for m in BENCH["per_layer"]), w["name"]


def test_each_moves_is_reported_where_its_metric_is():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert TEXT.match(m["layer"])
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert reports(cell, e2e[m["moves"]]), (m["name"], cell)


def test_files_are_found_by_name():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (ROOT / cfg["reference"]).is_file()
    for w in BENCH["workloads"]:
        mix = json.loads((ROOT / "torch_bench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "torch_bench" / "drivers" / f"{mix['driver']}.py").is_file()
        assert mix["limits"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "torch_bench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_a_new_cell_is_files_alone(tmp_path):
    """A copy of the benchmark gains a cell by a traffic file and entries
    in BENCHMARK.json alone, and runs it."""
    shutil.copytree(ROOT / "torch_bench", tmp_path / "torch_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "terra_gan_tpu_torch").symlink_to(ROOT / "terra_gan_tpu_torch")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "infer.grid-c4", "config": "pconvunet512-infer-fp32",
                               "traffic": "grid-c4", "chips": 1, "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "infer.grid-c8" in m.get("workloads", []):
            m["workloads"].append("infer.grid-c4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((ROOT / "torch_bench/traffic/grid-c8.json").read_text())
    mix.update(chunk=4, tiles=10, sample_share=0.5)
    (tmp_path / "torch_bench/traffic/grid-c4.json").write_text(json.dumps(mix))
    script = (
        "import sys, time, json, torch; sys.path.insert(0, '.');"
        "from torch_bench import harness; from torch_bench.run import parse;"
        "a = parse(['--workload', 'infer.grid-c4', '--seed', '5', '--seconds', '1']);"
        "r = harness.run_cell(a, time.perf_counter(), torch.device('cpu'),"
        " {'config': {'base_width': 8, 'image_size': 128}});"
        "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and "infer_tiles_per_s" in res["metrics"]


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, "torch_bench/run.py", "--workload", "infer.grid-c8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert out.stdout.strip() == ""


def test_nothing_imported_pulls_in_jax():
    script = (
        "import sys, glob, importlib, runpy; sys.path.insert(0, '.');"
        "from torch_bench import harness, traffic, work, compare, codec, weights, sets;"
        "from torch_bench.drivers import grid, train, serve, control;"
        "import torch_bench.loadgen;"
        "[harness.load_module(__import__('pathlib').Path(p)) for p in glob.glob('torch_bench/metrics/*.py')];"
        "import terra_gan_tpu_torch.serving.server, terra_gan_tpu_torch.training.loop,"
        " terra_gan_tpu_torch.training.human_guided, terra_gan_tpu_torch.parallel.infer;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'terra_gan_tpu'"
        " or m.startswith('terra_gan_tpu.') or m in ('bench', 'scripts')];"
        "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


def test_result_line_keys(run_small, capsys):
    from torch_bench import harness

    for trace in ("0", "1"):
        res = run_small("infer.grid-c8", trace=int(trace), seconds=1.0)
        harness.report(res)
        captured = capsys.readouterr()
        line = json.loads(captured.out.strip().splitlines()[-1])
        keys = list(line)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert keys[-1] == "checks" and set(keys) <= {*keys[:5], "breakdown", "checks"}
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
        if trace == "1":
            assert {"busy_s", "window_s"} <= set(line["device"])
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        for name, c in line["checks"].items():
            assert f"check {name} " in captured.err
        tail = captured.err.strip().splitlines()[-len(line["checks"]):]
        assert all(t.startswith("check ") for t in tail)
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
