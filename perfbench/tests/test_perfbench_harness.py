"""The harness is driven by data: cells, mixes, limits and metrics are found
by name, and new ones are picked up by adding files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_every_cell_resolves_to_its_files():
    bench = _bench()
    names = [w["name"] for w in bench["workloads"]]
    assert names == ["flagship_int8.stream_b256", "flagship_float.train_b64",
                     "flagship_float.stream_b256"]
    for name in names:
        _, cell, cfg, traffic, limits = harness.cell_files(ROOT, name)
        assert cfg["name"] == cell["config"]
        assert os.path.isfile(os.path.join(harness.HERE, "drivers", f"{traffic['driver']}.py"))
        assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(trace):
    bench = _bench()
    for w in bench["workloads"]:
        names = {m["name"] for m in harness.cell_metrics(bench, w["name"], bool(trace))}
        if trace:
            assert names and all(os.path.isfile(os.path.join(harness.HERE, "metrics", f"{n}.py"))
                                 for n in names)
        else:
            assert "setup_s" in names and len(names) >= 2


def test_every_reader_loads_and_finds_nothing_in_an_empty_trace():
    class Empty:
        window_s = busy_s = 0.0

        def count(self, span):
            return 0

        def device_s(self, *a, **k):
            return 0.0

    bench = _bench()
    for m in bench["per_layer"]:
        cell = m["workloads"][0]
        _, _, cfg, traffic, limits = harness.cell_files(ROOT, cell)
        ctx = harness.Context(ROOT, {}, cfg, traffic, limits, 1, 1.0, True, None, "plain", 0.0)
        assert harness.load_reader(m["name"]).read(Empty(), ctx) is None


def test_contract_names_units_and_limits():
    bench = _bench()
    allowed = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m["name"]) <= allowed and len(m["name"]) <= 64
        assert 1 <= len(m["unit"]) <= 16 and " " not in m["unit"]
    assert {m["name"] for m in bench["end_to_end"]} == {"serve_fps", "serve_p95_ms",
                                                        "train_fps", "setup_s"}
    assert len(bench["per_layer"]) == 11
    for m in bench["per_layer"]:
        assert m["name"].endswith("_roofline") == ("roofline" in m["name"])


def test_a_mix_with_a_key_its_driver_does_not_read_is_refused(tmp_path, monkeypatch):
    dst = _copy_checkout(tmp_path)
    monkeypatch.setattr(harness, "HERE", str(dst / "perfbench"))
    path = dst / "perfbench" / "traffic" / "stream_b256.json"
    mix = json.load(open(path))
    json.dump(dict(mix, host_memory="pinned"), open(path, "w"))
    with pytest.raises(ValueError, match="host_memory"):
        harness.cell_files(str(dst), "flagship_int8.stream_b256")


def _copy_checkout(tmp_path):
    """A copy of the benchmark's files beside the repository's program."""
    dst = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst / "BENCHMARK.json")
    return dst


def test_a_new_mix_cell_and_metric_are_picked_up_by_adding_files(tmp_path):
    """Add a traffic file, a limits file, a metric reader and their entries
    in a copy; the copy's harness runs the new cell on the CPU and reads the
    new metric with no edit to a file that was there."""
    dst = _copy_checkout(tmp_path)
    for d in ("spef_tpu_torch", "experiments"):  # the program and its weights
        os.symlink(os.path.join(ROOT, d), dst / d)
    before = {p: open(dst / "perfbench" / p).read()
              for p in ("harness.py", "drivers/stream.py", "trace.py")}
    mix = json.load(open(dst / "perfbench" / "traffic" / "stream_b256.json"))
    mix.update(window=2, pool_windows=2, ref_block=2, warmup_windows=2, trace_after_windows=1,
               trace_windows=1)
    json.dump(mix, open(dst / "perfbench" / "traffic" / "stream_b2.json", "w"))
    shutil.copy(dst / "perfbench" / "limits" / "flagship_int8.stream_b256.json",
                dst / "perfbench" / "limits" / "flagship_int8.stream_b2.json")
    (dst / "perfbench" / "metrics" / "windows.serve.py").write_text(
        "def read(trace, ctx):\n    return float(trace.count('forward'))\n")
    bench = json.load(open(dst / "BENCHMARK.json"))
    bench["workloads"].append({"name": "flagship_int8.stream_b2", "config": "flagship_int8",
                               "traffic": "stream_b2", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_fps", "serve_p95_ms"):
            m["workloads"].append("flagship_int8.stream_b2")
    bench["per_layer"].append({"name": "windows.serve", "unit": "windows", "better": "higher",
                               "source": "program_counter", "layer": "serving",
                               "moves": "serve_fps", "workloads": ["flagship_int8.stream_b2"]})
    json.dump(bench, open(dst / "BENCHMARK.json", "w"))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(dst)!r})\n"
        "from perfbench.harness import run_cell\n"
        f"r = run_cell({str(dst)!r}, 'flagship_int8.stream_b2', 2**33 + 5, 3.0, True, 'cpu',\n"
        "             backend='plain', sizes={'img_size': [48, 64]})\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=dst, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["windows.serve"]["value"] >= 1
    assert result["attempted"] >= 3
    assert all(open(dst / "perfbench" / p).read() == text for p, text in before.items())


def test_a_run_without_the_program_fails_with_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files prints
    no result line and exits with an error."""
    dst = _copy_checkout(tmp_path)
    code = ("import sys\n"
            f"sys.path.insert(0, {str(dst)!r})\n"
            "from perfbench.harness import run_cell\n"
            f"run_cell({str(dst)!r}, 'flagship_int8.stream_b256', 1, 1.0, False, 'cpu',\n"
            "         backend='plain')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=dst, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert "spef_tpu_torch" in out.stderr
    assert not out.stdout.strip()


def test_the_command_refuses_a_machine_without_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this test needs a machine without a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "flagship_int8.stream_b256", "--seed", str(2**33), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA card" in out.stderr
