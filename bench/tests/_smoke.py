"""A benchmark tree at smoke widths for the CPU tests: the repository's
BENCHMARK.json and bench/ copied into a temporary directory, with the
program's sources linked, and smoke cells added as new files only (a
configuration, a mix and a check file each), as a later change would add
them."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

# published keys at smoke width, and what else the program must be told
SMOKE = {
    "glm4-9b": ({"num_layers": 2, "hidden_size": 64, "ffn_hidden_size": 96,
                 "kv_channels": 16, "num_attention_heads": 4,
                 "multi_query_group_num": 2, "padded_vocab_size": 512},
                {"logit_chunk": 0}),
    "deepseek-v2-lite-16b": (
        {"num_hidden_layers": 3, "hidden_size": 64, "intermediate_size": 96,
         "num_attention_heads": 4, "num_key_value_heads": 4,
         "kv_lora_rank": 32,
         "qk_rope_head_dim": 8, "qk_nope_head_dim": 16, "v_head_dim": 16,
         "n_routed_experts": 8, "num_experts_per_tok": 2,
         "n_shared_experts": 1, "moe_intermediate_size": 32,
         "vocab_size": 512},
        {"head_dim": 24, "logit_chunk": 0}),
}
MIX = {"name": "smoke", "loop": "closed", "batch_tokens": 64,
       "cycle": [8, 16, 32], "tokens": {"dist": "uniform"},
       "why": "smoke"}
# limits of the smoke cells in float32: the program's CPU path and the
# reference agree to about 3e-6 (test_bench_reference.py)
LIMITS = {"logit_err": 1e-4, "token_gap": 1e-4}
# and in bf16, the configurations' precision, set as the cells' own are
# (bench/calibrate.py --device cpu on this tree, 6 seeds each): glm4-9b
# smoke, the program's largest logit_err 0.024 and token_gap 0.036, the
# fp8 control's smallest 0.233 and 0.280; deepseek-v2-lite-16b smoke, the
# program's largest median logit_err 0.013 against the control's 0.170
# (its largest logit_err, 0.20-0.51, is routing flips: 0.54-0.94 for the
# control), so as at full size the median carries the comparison
BF16_LIMITS = {"glm4-9b": {"logit_err": 0.13, "token_gap": 0.15},
               "deepseek-v2-lite-16b": {"logit_err_median": 0.09,
                                        "logit_err": 0.9}}


def smoke_config(name: str, dtype: str = "float32") -> dict:
    """The configuration file ``name`` at smoke width and in ``dtype``:
    its sizes replaced, and the program's fields that match them replaced
    too."""
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    sizes, extra = SMOKE[name]
    conf.update(sizes)
    conf["name"] = f"{name}-smoke"
    conf["kv_handoff_tokens"] = 4 * MIX["batch_tokens"]
    conf["compute_dtype"] = dtype
    rep = dict(conf["program"].get("replace", {}), **extra,
               compute_dtype=dtype)
    for field, key in conf["program"]["matches"].items():
        if key in sizes:
            if field.startswith("moe."):
                rep.setdefault("moe", {})[field[4:]] = sizes[key]
            else:
                rep["head_dim" if field == "resolved_head_dim"
                    else field] = sizes[key]
    conf["program"]["replace"] = rep
    return conf


def tree(tmp: Path, dtype: str = "float32") -> Path:
    """A benchmark root under ``tmp`` with a smoke cell a configuration
    (``<config>-smoke.smoke``) in ``dtype`` (float32 or bfloat16)."""
    root = tmp / "root"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", root / "src")
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "bench" / "traffic" / "smoke.json").write_text(json.dumps(MIX))
    for name in SMOKE:
        conf = smoke_config(name, dtype)
        f = f"bench/configs/{conf['name']}.json"
        (root / f).write_text(json.dumps(conf))
        man["configs"].append({"name": conf["name"], "source": "smoke",
                               "file": f, "reduced": [], "why": "smoke"})
        cell = f"{conf['name']}.smoke"
        man["workloads"].append({"name": cell, "config": conf["name"],
                                 "traffic": "smoke", "chips": 1,
                                 "why": "smoke"})
        (root / "bench" / "checks" / f"{cell}.json").write_text(
            json.dumps({"limits": LIMITS if dtype == "float32"
                        else BF16_LIMITS[name]}))
        for m in man["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root


LAUNCHER = """
import sys, torch
sys.path[:0] = [sys.argv[1] + "/bench", sys.argv[1] + "/src",
                sys.argv[1] + "/bench/reference"]
from harness.main import main
{patch}
sys.exit(main(sys.argv[2:], device="cpu"))
"""


def run(root: Path, cell: str, *args: str, patch: str = "",
        seconds: float = 0.5, seed: int = 2 ** 31 + 5, trace: int = 0):
    """The harness on the CPU (its look for a card skipped) in a fresh
    process, ``patch`` run first. -> (returncode, last stdout line as
    JSON or None, stderr)."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--root", str(root),
            *args]
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", LAUNCHER.format(patch=patch),
                        str(root), *argv], capture_output=True, text=True,
                       env=env, timeout=600)
    lines = p.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return p.returncode, line, p.stderr
