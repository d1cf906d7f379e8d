"""The one fixture of the port's tests that builds meshes: a module's
2x4 ("data", "model") and 2x2x2 ("pod", "data", "model") meshes over the
fake process group of ``repro_torch.launch.mesh``, which it starts and
destroys at the module's end, so no other test sees a process group.

Each smoke step a mesh test runs is also held against the reference's
compiled SPMD step on the same mesh: the counts in
``tests/data/torch_mesh_reference.json`` (``make_torch_mesh_reference.py``
writes them with JAX; these tests read them without it, so they run on a
host without JAX too)."""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.launch.mesh import make_mesh  # noqa: E402

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def meshes():
    if dist.is_initialized():
        pytest.fail("a process group is already running")
    try:
        yield {name: make_mesh(*spec) for name, spec in MESHES.items()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# the (kind, mesh) cells each family's smoke steps run on: train on both
# meshes, a serve step on one each (prefill on the 3-D mesh, decode on
# 2x4), which keeps each file near a minute
CELLS = (("train", "2x4"), ("train", "2x2x2"), ("prefill", "2x2x2"),
         ("decode", "2x4"))
# the same smoke steps on one device, no mesh (mesh name "1"):
# tests/test_torch_dryrun_onedevice.py holds them
ONE_DEVICE_CELLS = (("train", "1"), ("prefill", "1"), ("decode", "1"))
B, S = 4, 16
# the layers a smoke step keeps on a mesh: every kind of layer a family
# has once (deepseek's dense layer and one MoE layer, griffin's (rec, rec,
# attn) triple, llama4's super-block of 4); DTensor's per-operation cost
# makes the depth the test's time
LAYERS = {"deepseek-v2-lite-16b": 2, "recurrentgemma-9b": 3,
          "llama4-maverick-400b-a17b": 4, "whisper-tiny": 1}
# archs of the port that the reference (the JAX package) does not have, so
# that it has no compiled step to hold them to: granite-4.0-h-small's
# hybrid Mamba-2 / attention / MoE family is the port's own (its CPU tests
# hold it to the plain reference in bench/reference/granite_hybrid.py)
NO_REFERENCE = ("granite-4.0-h-small",)


REFERENCE = pathlib.Path(__file__).parent / "data" / \
    "torch_mesh_reference.json"
# each device's FLOPs, port against the reference's compiled step: the
# one-device tolerance (test_torch_dryrun.FLOPS_TOL), since the two
# frameworks lower the same products differently (einsum splits, the
# attention's masked blocks) on a mesh as on one device
FLOPS_TOL = 0.025
# each device's collective bytes (ring model, both sides): the two
# partitioners pick their own plans for the small collectives (GSPMD sums
# some gradients in tuples, moves a target logit by all-to-all; DTensor
# gathers a dim split over two mesh dims in two steps), which moves the
# total by up to a fifth on these smoke shapes. The reference is compiled
# for the CPU, whose backend has no reduce-scatter: it all-reduces and
# slices (repro/launch/dryrun.py, the record's f32 note), so each of the
# port's reduce-scatters is priced as that all-reduce (``cpu_lowered``)
COLL_TOL = 0.25
# cells whose port step reads outside a tolerance, with the traced cause
# and the counts by kind (ROADMAP.md lists each where the port does not
# mirror the reference's behaviour); each stays a strict xfail of the
# mesh tests
_TARGET_LOGITS = (
    "collective bytes 0.736x of the reference's: the port moves all-gather "
    "3621760, reduce-scatter 882304 (priced as the CPU's all-reduce), "
    "all-to-all 5120 and all-reduce 46474 bytes a device, the reference "
    "all-gather 3704416, all-reduce 3741204, all-to-all 2506240 and "
    "collective-permute 5760; the gap is the reference's all-to-all, which "
    "moves the loss's target logits (take_along_axis over the vocabulary "
    "split, repro/models/modules.py:175), where the port's vocabulary-"
    "parallel loss (models/modules.py:_vocab_parallel_nll) moves partial "
    "sums of a few bytes a token")
KNOWN_FAULTS: dict[tuple[str, str, str], str] = {
    ("whisper-tiny", "train", "2x4"): _TARGET_LOGITS,
}
# the open cells' FLOPs a device as torch 2.13.0+cpu counts them in these
# tests: the layouts are stated, so chip_smoke.py [dryrun mesh] holds the
# card's torch release to them within FLOPS_TOL
OPEN_CELL_FLOPS: dict[tuple[str, str, str], float] = {
    ("whisper-tiny", "train", "2x4"): 163639296.0,
}
_ANALYSES: dict[tuple[str, str, str], dict] = {}


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def cpu_lowered(ana: dict) -> float:
    """The analysis' collective bytes with each reduce-scatter priced as
    the all-reduce over its whole input that the CPU backend issues in its
    place (twice the input x (g-1)/g: 2g times the reduce-scatter's)."""
    return sum(2 * r["group"] * r["bytes"] if r["kind"] == "reduce-scatter"
               else r["bytes"] for r in ana["ops"] if "group" in r)


class OutsideReference(AssertionError):
    """A step's counts outside the tolerances of the reference's."""


def reference_cases(archs, cells=None) -> list:
    """(arch, kind, mesh name) for each arch and cell (``CELLS`` unless
    given), those of ``KNOWN_FAULTS`` marked as expected to fail,
    strictly, and only by ``OutsideReference``."""
    return [pytest.param(a, kind, m, marks=pytest.mark.xfail(
        strict=True, raises=OutsideReference,
        reason=KNOWN_FAULTS[(a, kind, m)]))
            if (a, kind, m) in KNOWN_FAULTS else (a, kind, m)
            for a in archs for kind, m in (cells or CELLS)]


def matches_reference(arch: str, kind: str, mesh_name_: str, meshes) -> None:
    """The smoke step of ``arch`` on the named mesh (as ``holds_on_mesh``
    ran it in this module, else run now) within ``FLOPS_TOL`` of the
    reference's FLOPs a device and ``COLL_TOL`` of its collective bytes a
    device (``cpu_lowered``), else ``OutsideReference``; an open cell
    first reads its ``OPEN_CELL_FLOPS`` within ``FLOPS_TOL``."""
    key = (arch, kind, mesh_name_)
    got = _ANALYSES.get(key) or holds_on_mesh(arch, kind, meshes[mesh_name_])
    want = json.loads(REFERENCE.read_text())["cells"][":".join(key)]
    coll = cpu_lowered(got)
    detail = (f"{key}: FLOPs {got['flops']:.0f} vs {want['flops']:.0f}; "
              f"collective bytes {coll:.0f} vs "
              f"{want['collective_total_bytes']:.0f}; port by kind "
              f"{got['collective_bytes_by_kind']}, reference by kind "
              f"{want['collective_bytes_by_kind']}")
    if key in OPEN_CELL_FLOPS:
        assert abs(got["flops"] - OPEN_CELL_FLOPS[key]) <= \
            FLOPS_TOL * OPEN_CELL_FLOPS[key], (OPEN_CELL_FLOPS[key], detail)
    if abs(got["flops"] - want["flops"]) > FLOPS_TOL * want["flops"] or \
            abs(coll - want["collective_total_bytes"]) > \
            COLL_TOL * want["collective_total_bytes"]:
        raise OutsideReference(detail)


def holds_on_mesh(arch: str, kind: str, mesh) -> dict:
    """A smoke step of ``arch`` run under ``launch/dryrun.lower_cell`` on
    ``mesh``: it must count each device's work, at least the unsharded
    step's FLOPs over the mesh's devices, and call the same kernel entries
    as the unsharded step on one device, but for its MoE combine (plain on
    a mesh). -> the analysis (with its op
    record), kept for ``matches_reference``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import mesh_chips
    cfg = smoke_config(arch)
    cfg = cfg.replace(num_layers=LAYERS.get(arch, 2))
    if cfg.family == "audio":
        cfg = cfg.replace(encoder_layers=1)
    shape = ShapeConfig("smoke", S, B, kind)
    one, _ = lower_cell(arch, shape, None, cfg=cfg)
    got, _ = lower_cell(arch, shape, mesh, cfg=cfg, record_ops=True)
    _ANALYSES[(arch, kind, mesh_name(mesh))] = got
    assert got["flops"] > 0 and got["memory_bytes"] > 0
    assert got["flops"] * mesh_chips(mesh) >= one["flops"]
    # the mesh's combine is plain (moe._combine_on_mesh); one device's
    # is the moe_combine kernel
    assert got["kernel_calls"] == {k: n for k, n in one["kernel_calls"]
                                   .items() if k != "moe_combine"}
    assert got["collective_total_bytes"] > 0
    assert got["peak_bytes"] >= got["argument_bytes"] > 0
    return got
