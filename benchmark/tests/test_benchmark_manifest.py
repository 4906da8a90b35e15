"""BENCHMARK.json against the benchmark's contract, and the files each
name leads to."""

import json
import re
import sys
import types

import pytest

from benchmark import harness

M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_names_and_units():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in M[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]), e
        assert e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for e in M["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert "setup_s" in {e["name"] for e in M["end_to_end"]}
    assert 1 <= M["run_seconds"] <= 51


def test_every_name_finds_its_files():
    for c in M["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        harness.load_arch(cfg, c["file"])
        assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))
    for w in M["workloads"]:
        harness.load_cell(w["name"])
        assert w["chips"] in (1, 4)
    for e in M["end_to_end"] + M["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{e['name']}.py").exists()


def test_each_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {e["name"]: e for e in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    layers = {}
    for e in M["per_layer"]:
        assert e["moves"] in e2e
        for w in e.get("workloads", cells):
            assert w in cells
            assert w in e2e[e["moves"]].get("workloads", cells)
        layers.setdefault(e["layer"], []).append(e["name"])
    for w in cells:
        reported = [e for e in M["per_layer"]
                    if w in e.get("workloads", cells)]
        assert reported, w


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    for bad in ("jax", "jaxlib.xla_client", "mast3r_slam_tpu.pipeline",
                "flax"):
        monkeypatch.setitem(sys.modules, bad, types.ModuleType(bad))
        assert bad.split(".")[0] in harness.imported_forbidden()
        monkeypatch.delitem(sys.modules, bad)
    for fine in ("mast3r_slam_torch", "mast3r_slam_torch.pipeline",
                 "jaxtyping_like", "flaxen"):
        monkeypatch.setitem(sys.modules, fine, types.ModuleType(fine))
    assert not (set(harness.imported_forbidden())
                & {"mast3r_slam_torch", "jaxtyping_like", "flaxen"})


@pytest.mark.parametrize("path", sorted(harness.BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_file_of_the_benchmark_imports_jax(path):
    import ast

    for node in ast.walk(ast.parse(path.read_text())):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        for m in mods:
            assert m.split(".")[0] not in harness.FORBIDDEN, (path, m)


@pytest.mark.parametrize("path", sorted(
    (harness.BENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    text = path.read_text()
    assert "mast3r_slam_torch" not in re.sub(r'"""(.|\n)*?"""', "", text)
