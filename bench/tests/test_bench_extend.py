"""A configuration, a traffic mix and a per-layer metric added as new
files are found by name and run, with no file of the benchmark edited
(BENCHMARK.json gains entries)."""
import hashlib
import json

import _smoke
from harness import cell as C

NEW_METRIC = '''"""Requests in the window (a smoke metric)."""


def read(run):
    return float(sum(r.rows for r in run.records))
'''


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file()
        and "__pycache__" not in p.parts}


def test_new_files_run_unedited(tmp_path):
    before = digest(C.BENCH)
    root = _smoke.tree(tmp_path)
    (root / "bench" / "metrics" / "smoke_requests.py").write_text(NEW_METRIC)
    man = json.loads((root / "BENCHMARK.json").read_text())
    cell = "glm4-9b-smoke.smoke"
    man["per_layer"].append({"name": "smoke_requests", "unit": "requests",
                             "better": "higher", "source": "host_clock",
                             "layer": "serve step and model (host)",
                             "moves": "prefill_tokens_per_s",
                             "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    after = digest(root / "bench")
    assert {k: v for k, v in after.items() if k in before} == before

    rc, line, err = _smoke.run(root, cell, trace=1)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert line["metrics"]["smoke_requests"]["value"] == line["attempted"]
    # the device's metrics read nothing off the card
    assert set(line["metrics"]) == {"smoke_requests"}
    assert list(line)[-1] == "checks"

    rc, line, err = _smoke.run(root, cell)
    assert rc == 0 and line["correct"] is True, err
    assert set(line["metrics"]) == {"prefill_tokens_per_s", "ttft_p95_ms",
                                    "setup_s"}
    assert line["attempted"] > 0 and line["failed"] == 0
