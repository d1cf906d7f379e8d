"""The control, the reference computed with fp8 operands in the
program's place, comes out not correct where the sound program comes
out correct: at smoke width in bf16 (the configurations' precision),
through a whole run of the harness, under limits set at that width as
the cells' own were set at theirs (``_smoke.BF16_LIMITS``). The readings
at the cells' own size, from which their limits were set, are in
PERF.md and bench/checks/."""
import pytest

import _smoke

CONTROL = """
import json, torch
import repro_torch.launch.steps as S
from harness import cell as C, weights
import _plain
_conf = json.loads(open({conf!r}).read())
_ref = C.reference(C.BENCH, _conf["reference"])
def _control(bundle):
    def f(params, batch):
        lg = _ref.forward(weights.flatten(params), _conf, batch["tokens"],
                          _plain.Fp8())
        return lg[:, None, :], None
    return f
S.make_prefill_step = _control
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _smoke.tree(tmp_path_factory.mktemp("control"), "bfloat16")


@pytest.mark.parametrize("config", sorted(_smoke.SMOKE))
def test_the_control_fails_where_the_program_passes(root, config):
    cell = f"{config}-smoke.smoke"
    rc, line, err = _smoke.run(root, cell)
    assert rc == 0 and line["correct"] is True, (err, line)
    conf = root / "bench" / "configs" / f"{config}-smoke.json"
    rc, line, err = _smoke.run(root, cell,
                               patch=CONTROL.format(conf=str(conf)))
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]
