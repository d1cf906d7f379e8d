"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, and the modules it copies from that package stay equal to their
sources (with ``repro.`` renamed ``repro_torch.``, and in the model configs
``jax.numpy`` renamed ``torch``), so the two cannot drift apart
unnoticed."""
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
          "faults/inject.py", "faults/coldstart.py", "faults/journal.py",
          "faults/__init__.py", "workload/arrivals.py", "workload/mix.py",
          "workload/pricing.py", "workload/driver.py",
          "workload/__init__.py", "planner/calibrate.py",
          "planner/model.py", "planner/sla.py", "planner/__init__.py",
          "obs/metrics.py", "obs/report.py", "obs/trace.py",
          "obs/drift.py", "obs/__init__.py"]

# the arch configs are pure data; their dtypes are torch's
CONFIGS = ["configs/deepseek_v2_lite.py", "configs/glm4_9b.py",
           "configs/granite_20b.py", "configs/llama4_maverick_400b.py",
           "configs/mamba2_2p7b.py", "configs/qwen2_vl_7b.py",
           "configs/recurrentgemma_9b.py", "configs/smollm_135m.py",
           "configs/starcoder2_3b.py", "configs/whisper_tiny.py",
           "configs/smoke.py"]

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

# the modules that build coordinators are copies except for the device
# those coordinators run on, which is the caller's
DEVICE_PATCHES = {
    "workload/tenancy.py": [
        ("                             "
         "executor_workers=coord.executor_workers)\n",
         "                             "
         "executor_workers=coord.executor_workers,\n"
         "                             device=coord.device)\n"),
        ("        bank = _ModelBank(probe_opts if probe_opts is not None\n"
         "                          "
         "else getattr(session, \"engine_opts\", {}) or {},\n"
         "                          probe_runs=probe_runs)\n",
         "        opts = probe_opts if probe_opts is not None \\\n"
         "            else getattr(session, \"engine_opts\", {}) or {}\n"
         "        # probe engines run on the session's device unless named\n"
         "        opts = {\"device\": session.coord.device, **opts}\n"
         "        bank = _ModelBank(opts, probe_runs=probe_runs)\n"),
    ],
    "planner/search.py": [
        ("                 faults=None, coldstart=None, retry=None):\n"
         "        from repro_torch.core.stragglers import StragglerConfig\n",
         "                 faults=None, coldstart=None, retry=None,\n"
         "                 device: str = \"cuda\"):\n"
         "        from repro_torch.core.stragglers import StragglerConfig\n"
         "        self.device = device    "
         "# torch device confirmations run on\n"),
        ("                faults=self.faults, coldstart=self.coldstart, "
         "retry=retry)\n",
         "                faults=self.faults, coldstart=self.coldstart, "
         "retry=retry,\n"
         "                device=self.device)\n"),
    ],
    "planner/adaptive.py": [
        ("            executor_workers=coord.executor_workers,\n"
         "            plan_kw=self.probe_plan_kw)\n",
         "            executor_workers=coord.executor_workers,\n"
         "            plan_kw=self.probe_plan_kw, device=coord.device)\n"),
    ],
}


def _renamed(rel: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.",
                  (SRC / "repro" / rel).read_text())


def _torch_dtypes(text: str) -> str:
    text = text.replace("import jax.numpy as jnp", "import torch")
    return re.sub(r"\bjnp\.", "torch.", text)


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


@pytest.mark.parametrize("rel", CONFIGS)
def test_config_module_equals_reference(rel):
    assert (PORT / rel).read_text() == _torch_dtypes(_renamed(rel))


def _patched(rel: str, patch: list[tuple[str, str]]) -> str:
    want = _renamed(rel)
    for old, new in patch:
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    return want


def test_coordinator_equals_reference_but_for_device():
    assert (PORT / "core/coordinator.py").read_text() == \
        _patched("core/coordinator.py", COORDINATOR_DEVICE_PATCH)


@pytest.mark.parametrize("rel", sorted(DEVICE_PATCHES))
def test_module_equals_reference_but_for_device(rel):
    assert (PORT / rel).read_text() == _patched(rel, DEVICE_PATCHES[rel])
