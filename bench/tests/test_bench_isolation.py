"""Nothing the benchmark runs imports JAX or the JAX package, by the
top-level name of each loaded module compared whole (the port's name
begins with the JAX package's); a run in whose process one is loaded
exits without a result; a run without the card it asks for exits
without a result."""
import os
import subprocess
import sys

import _smoke
from harness import cell as C

IMPORT_ALL = """
import sys
sys.path[:0] = [sys.argv[1] + "/bench", sys.argv[1] + "/src"]
from pathlib import Path
from harness import cell as C, main, check, flops, timing, traffic, weights
import calibrate
bench = Path(sys.argv[1]) / "bench"
for p in (bench / "metrics").glob("*.py"):
    C.metric_reader(bench, p.stem)
for p in (bench / "reference").glob("[!_]*.py"):
    C.reference(bench, p.stem)
print(main.forbidden_modules())
"""


def test_modules_import_nothing_forbidden():
    p = subprocess.run([sys.executable, "-c", IMPORT_ALL,
                        str(C.BENCH.parent)], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_names_compare_whole():
    from harness import main
    assert main.forbidden_modules(["repro_torch", "repro_torch.models",
                                   "jaxtyping", "flaxen.x", "torch"]) == []
    assert main.forbidden_modules(["repro.core.engine", "jax.numpy",
                                   "jaxlib", "flax", "torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_a_forbidden_import_refuses_the_result(tmp_path):
    root = _smoke.tree(tmp_path)
    rc, line, err = _smoke.run(root, "glm4-9b-smoke.smoke")
    assert rc == 0 and line is not None, err
    rc, line, err = _smoke.run(root, "glm4-9b-smoke.smoke",
                               patch="import repro")
    assert rc != 0 and line is None
    assert "repro" in err


def test_no_card_no_result():
    p = subprocess.run([sys.executable, str(C.BENCH / "run.py"),
                        "--workload", "glm4-9b.prefill_long", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout.strip() == ""
