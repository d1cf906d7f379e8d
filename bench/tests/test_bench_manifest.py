"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units, references between entries, and the files it names."""
import json
import re

import pytest

from harness import cell as C

ROOT = C.BENCH.parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert (ROOT / "bench" / "run.py").is_file()


def test_names_and_units():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["why"])
        assert LINE.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        names.append(w["name"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
        assert (C.BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in MAN["end_to_end"] if C.applies(m,
                                                                w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(C.applies(m, w["name"]) for m in MAN["per_layer"])
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    """Each configuration's file is its own, names its reference, lists
    every key changed from the source in ``reduced`` (with the published
    value under ``as_published``) and builds the program's config held to
    its sizes."""
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("bench/configs/")
    assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
    assert set(conf.get("as_published", {})) == set(entry["reduced"])
    assert (C.BENCH / "reference" / f"{conf['reference']}.py").is_file()
    C.program_config(conf)
    used = [w for w in MAN["workloads"] if w["config"] == entry["name"]]
    assert used
    for w in used:
        assert (C.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (C.BENCH / "checks" / f"{w['name']}.json").is_file()


def test_size():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
