"""What one cell is made of, found by name: the manifest's entries, the
configuration file, the mix file, the reference of the configuration's
family, the per-layer metric readers and the cell's check limits; and
the program's configuration built from the configuration file."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


def manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(path: Path, name: str):
    """A module from its file; its directory goes on the path, so that it
    can import the files beside it."""
    if str(path.parent) not in sys.path:
        sys.path.insert(0, str(path.parent))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(bench: Path, family: str):
    return load_module(bench / "reference" / f"{family}.py",
                       f"bench_reference_{family}")


def metric_reader(bench: Path, name: str):
    return load_module(bench / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_"))


def limits(bench: Path, cell: str) -> dict | None:
    p = bench / "checks" / f"{cell}.json"
    return json.loads(p.read_text())["limits"] if p.is_file() else None


def lookup(c: dict, dotted: str):
    for k in dotted.split("."):
        c = c[k]
    return c


_DTYPES = ("bfloat16", "float16", "float32")


def program_config(conf: dict):
    """The program's ModelConfig: its registered arch with the file's
    ``program.replace``, held to the file's published sizes
    (``program.matches``: program field -> file key)."""
    import torch

    from repro_torch.configs.base import get_config
    prog = conf["program"]
    cfg = get_config(prog["arch"])
    kw = {}
    for k, v in prog.get("replace", {}).items():
        if k == "moe":
            kw[k] = dataclasses.replace(cfg.moe, **v)
        elif isinstance(v, str) and v in _DTYPES:
            kw[k] = getattr(torch, v)
        else:
            kw[k] = v
    cfg = cfg.replace(**kw)
    for field, key in prog["matches"].items():
        have = lookup_attr(cfg, field)
        want = lookup(conf, key)
        if have != want:
            raise ValueError(f"program {field} = {have!r}, but the "
                             f"configuration file's {key} = {want!r}")
    return cfg


def lookup_attr(obj, dotted: str):
    for k in dotted.split("."):
        obj = getattr(obj, k)
    return obj
