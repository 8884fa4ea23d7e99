"""BENCHMARK.json against the benchmark's contract, and everything found by name."""
import json
import re

import pytest

from portbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(spec.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "portbench/run.py"] and bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_loads_and_reports_what_its_metrics_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = spec.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert cell.limits, "every cell states the limits of its correctness check"
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in bench["per_layer"]:
        assert e2e[m["moves"]]
        assert callable(spec.layer_reader(m["name"]))


def test_configs_are_files_under_paths(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(spec.ROOT / c["file"]) as f:
            config = json.load(f)
        assert config["name"] == c["name"] and c["reduced"] == []


@pytest.mark.parametrize("section,key,value", [
    ("model", "layerscale", True),  # DINOv2's LayerScale: no weights, no reference for it
    ("model", "register_tokens", 4),  # a key the harness does not read
    ("extract", "slice_along", "z"),
    ("similarity", "threshold", 0.3),
    ("refinement", "cg_maxiter", 50),
])
def test_a_configuration_the_harness_cannot_run_raises(bench, section, key, value):
    """Every key of a configuration is read or refused: one that the
    harness, its reference or the program would not run as written raises."""
    from portbench.harness import edit, extract

    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        check = edit.program_settings if section in ("similarity", "refinement") \
            else extract.settings
        check(cell)
        config = json.loads(json.dumps(cell.config))
        config[section][key] = value
        with pytest.raises(ValueError):
            check(spec.Cell(cell.name, 1, config, cell.traffic, cell.limits, [], []))


def test_a_new_configuration_is_found_by_name(tmp_path, bench):
    """A configuration, a mix and a cell added as files and entries only."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "traffic" / "extract-64.json").write_text(
        json.dumps({"loop": "extract", "volume": 64, "check_slots": 4}))
    (tmp_path / "limits" / "new-extract-64.json").write_text(json.dumps({"feat_rel_err": 0.1}))
    with open(spec.BENCH_DIR / "configs" / "dino-vits8.json") as f:
        config = dict(json.load(f), name="dino-new")
    (tmp_path / "dino-new.json").write_text(json.dumps(config))
    new = dict(bench)
    new["configs"] = bench["configs"] + [{"name": "dino-new", "source": "https://example.org",
                                          "file": "dino-new.json", "reduced": [], "why": "test"}]
    new["workloads"] = bench["workloads"] + [{"name": "new-extract-64", "config": "dino-new",
                                              "traffic": "extract-64", "chips": 1, "why": "t"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = spec.load_cell("new-extract-64", tmp_path / "BENCHMARK.json", tmp_path)
    assert cell.config["name"] == "dino-new" and cell.traffic["volume"] == 64
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell", tmp_path / "BENCHMARK.json", tmp_path)
