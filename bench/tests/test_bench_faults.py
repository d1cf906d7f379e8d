"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven, at smoke
width in float32 (where the program and the reference agree to about
3e-6), once for each fault of ``harness/faults.py``. A sound run of the
same tree is correct."""
import pytest

import _smoke

BROKEN = """
import repro_torch.launch.steps as S
from harness import faults
_orig = S.make_prefill_step
S.make_prefill_step = lambda bundle: faults.FAULTS[{fault!r}](_orig(bundle))
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _smoke.tree(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", ["glm4-9b-smoke.smoke",
                                  "deepseek-v2-lite-16b-smoke.smoke"])
def test_a_sound_run_is_correct(root, cell):
    rc, line, err = _smoke.run(root, cell)
    assert rc == 0 and line["correct"] is True, err
    assert "check logit_err" in err.splitlines()[-2]


@pytest.mark.parametrize("fault", ["answer_altered",
                                   "half_batch_left_out"])
@pytest.mark.parametrize("cell", ["glm4-9b-smoke.smoke",
                                  "deepseek-v2-lite-16b-smoke.smoke"])
def test_a_fault_is_not_correct(root, cell, fault):
    rc, line, err = _smoke.run(root, cell, patch=BROKEN.format(fault=fault))
    assert rc == 0, err
    assert line["correct"] is False
    assert line["checks"]["logit_err"]["value"] > 0.1
