"""BENCHMARK.json against the benchmark's contract, the files it names,
and what a run's process may load."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def e2e(cell: str) -> set[str]:
    return {m["name"] for m in MANIFEST["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(line(w) for w in MANIFEST["command"])
    files = [w for w in MANIFEST["command"] if "/" in w]
    assert all(f.split("/")[0] in MANIFEST["paths"] and ".." not in f for f in files)


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_have_their_keys_names_and_units(group):
    entries = MANIFEST[group]
    assert len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        extra = {"workloads"} if group == "end_to_end" else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert line(e[k]), (e["name"], k)
        if group == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        if group == "configs":
            assert len(e["reduced"]) <= 16 and all(NAME.match(k) for k in e["reduced"])


def test_end_to_end_metrics_and_bounds():
    by = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in by and by["setup_s"]["bound"] <= 0.25 and "workloads" not in by["setup_s"]
    for m in by.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_a_rate_and_a_per_layer_metric():
    for cell in CELLS:
        assert "setup_s" in e2e(cell) and len(e2e(cell)) >= 2
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])


def test_per_layer_metrics_move_a_metric_their_cells_report():
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
        for cell in m["workloads"]:
            assert cell in CELLS and m["moves"] in e2e(cell), (m["name"], cell)
    layers = {}
    for m in MANIFEST["per_layer"]:  # one layer, one spelling
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configs_cells_and_chips():
    configs = {c["name"] for c in MANIFEST["configs"]}
    assert configs == {w["config"] for w in MANIFEST["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) == len(CELLS)
    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])


def test_named_files_exist_under_the_benchmark():
    for c in MANIFEST["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.resolve().is_relative_to(BENCH)
        config = json.loads(path.read_text())
        assert set(c["reduced"]) <= set(config) and config["reduced"] == c["reduced"]
    for w in MANIFEST["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['kind']}.py").is_file()
        assert json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_every_limit_sits_between_readings_it_names():
    for w in MANIFEST["workloads"]:
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert all(NAME.match(k) and v >= 0 for k, v in limits.items())


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_without_a_card_a_run_exits_non_zero_and_prints_no_result():
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
                           "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    if "CUDA device" not in proc.stderr:
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


RUN = """
import sys, time
sys.path[:0] = {paths!r}
import tiny, harness
tiny.run(tiny.cell({cell!r}, "bfloat16"))
print(harness.forbidden_modules(), "image_diffusion_torch" in sys.modules)
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_neither_jax_nor_the_jax_package(cell):
    code = RUN.format(paths=[str(ROOT), str(BENCH), str(Path(__file__).parent)], cell=cell)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[] True"
