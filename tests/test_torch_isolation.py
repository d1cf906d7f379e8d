"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, and the modules it copies from that package stay equal to their
sources (with ``repro.`` renamed ``repro_torch.``), so the two cannot
drift apart unnoticed."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

COPIES = ["core/format.py", "relational/tpch.py", "objectstore/latency.py",
          "objectstore/store.py", "objectstore/client.py",
          "objectstore/__init__.py", "core/__init__.py",
          "core/stragglers.py", "core/shuffle.py", "core/plan.py",
          "core/cost.py", "core/events.py", "faults/retry.py",
          "faults/inject.py", "faults/coldstart.py"]

# the coordinator is a copy except for the torch device it hands workers
COORDINATOR_DEVICE_PATCH = [
    ("                 journal=None):\n        self.store = store",
     "                 journal=None, device: str = \"cuda\"):\n"
     "        self.device = device    # torch device the Workers compute on\n"
     "        self.store = store"),
    ("tabs = [decode_object(self.store.get(k), key=k)\n",
     "tabs = [decode_object(self.store.get(k), key=k,\n"
     "                                      device=self.device)\n"),
    ("                        self.compute_scale)\n",
     "                        self.compute_scale, device=self.device)\n"),
]


def _renamed(rel: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.",
                  (SRC / "repro" / rel).read_text())


def _port_modules() -> list[str]:
    return sorted(".".join(p.relative_to(SRC).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr


def test_no_reference_imports_in_source():
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|repro\b(?!_torch))",
                     re.MULTILINE)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_reference(rel):
    assert (PORT / rel).read_text() == _renamed(rel)


def test_coordinator_equals_reference_but_for_device():
    want = _renamed("core/coordinator.py")
    for old, new in COORDINATOR_DEVICE_PATCH:
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    assert (PORT / "core/coordinator.py").read_text() == want


def test_planner_config_equals_reference():
    ref = _renamed("planner/model.py")
    start = ref.index("def _norm_shuffle")
    end = ref.index("@dataclasses.dataclass(frozen=True)\nclass Prediction")
    port = (PORT / "planner/model.py").read_text()
    assert port[port.index("def _norm_shuffle"):] == \
        ref[start:end].rstrip() + "\n"
