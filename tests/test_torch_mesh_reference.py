"""The committed reference counts of the smoke mesh cells and one-device
steps (``tests/data/torch_mesh_reference.json``) are still the reference's
own:
a fixed subset compiled again by the JAX package
(``make_torch_mesh_reference.compute``, a child process of 8 host
devices) gives the file's numbers exactly."""
import json

import pytest

pytest.importorskip("jax")

from make_torch_mesh_reference import OUT, compute  # noqa: E402

SUBSET = ["glm4-9b:train:2x4", "mamba2-2.7b:train:2x4",
          "smollm-135m:decode:2x4", "qwen2-vl-7b:prefill:1"]


def test_the_committed_reference_counts_are_the_reference_s():
    data = json.loads(OUT.read_text())
    assert data["command"] and data["jax"]
    got = compute(SUBSET)
    for cell in SUBSET:
        assert got[cell] == data["cells"][cell], cell
