"""The port's train CLI against the reference's, and the port's examples,
on the CPU.

Both train CLIs run in-process at ``--smoke --steps 8 --steps-per-task 2
--fail-at 3``, the port's from the reference's initial state (bridged):
the same committed steps, losses to ``TOL``, and exactly the same lines
for the injected failure and the store's PUT/GET counts. Each
``examples/torch/*.py`` runs in its own interpreter with ``--device
cpu``."""
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.smoke import smoke_config as jax_smoke_config  # noqa
from repro.launch import train as jax_train  # noqa: E402
from repro.launch.steps import init_train_state as jax_init_state  # noqa
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.runtime.optimizer import make_optimizer as jax_opt  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.bridge import tree_from_numpy  # noqa: E402
from repro_torch.runtime.train_loop import ElasticTrainer  # noqa: E402

from _torch_train import TOL  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--smoke", "--steps", "8", "--steps-per-task", "2", "--fail-at", "3"]
LOSS = re.compile(r"^step +(\d+) +loss (\S+)$")


def _split(out: str) -> tuple[list, list, list]:
    """-> (committed steps, losses, every other line)."""
    steps, losses, rest = [], [], []
    for line in out.splitlines():
        m = LOSS.match(line)
        if m:
            steps.append(int(m.group(1)))
            losses.append(float(m.group(2)))
        else:
            rest.append(line)
    return steps, losses, rest


def test_train_cli_prints_the_references_lines(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train"] + ARGS)
    jax_train.main()
    ref = _split(capsys.readouterr().out)

    # the reference CLI's initial state: its trainer draws it at seed 0
    jb = jax_build_model(jax_smoke_config("smollm-135m"))
    init = jax.tree.map(np.asarray, jax_init_state(
        jb, jax_opt(jb.cfg.optimizer, lr=1e-3), jax.random.key(0)))
    monkeypatch.setattr(ElasticTrainer, "_init_state",
                        lambda self: tree_from_numpy(init, self.device))
    train.main(ARGS + ["--device", "cpu"])
    port = _split(capsys.readouterr().out)

    assert port[0] == ref[0] == [2, 4, 6, 8]
    np.testing.assert_allclose(port[1], ref[1], rtol=TOL, atol=0)
    assert port[2] == ref[2]
    assert ref[2] == ["[inject] worker failure at step 3",
                      "done: 4 committed checkpoints, 276 PUTs / 276 GETs "
                      "to the store"]


@pytest.mark.parametrize("name", ["quickstart", "serve_decode",
                                  "tpch_query", "train_elastic"])
def test_example_runs_on_the_cpu(name):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    if name == "train_elastic":
        assert "loss trajectories bit-exact across failures: True" in \
            out.stdout
