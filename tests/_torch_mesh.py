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
B, S = 4, 16
# the layers a smoke step keeps on a mesh: every kind of layer a family
# has once (deepseek's dense layer and one MoE layer, griffin's (rec, rec,
# attn) triple, llama4's super-block of 4); DTensor's per-operation cost
# makes the depth the test's time
LAYERS = {"deepseek-v2-lite-16b": 2, "recurrentgemma-9b": 3,
          "llama4-maverick-400b-a17b": 4, "whisper-tiny": 1}


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
# cells whose port step reads outside a tolerance, with the reason
# (ROADMAP.md Queue C lists each as an open fault)
_MOVES_MORE = ("collective bytes {} of the reference's: GSPMD gathers the "
               "{} again in the backward and moves the loss's target logits "
               "by all-to-all (take_along_axis); the port keeps each "
               "gathered weight for its backward and the vocabulary split")
_ONE_DEVICE = ("FLOPs {}: the unsharded step reads {} at B 4, S 16 on one "
               "device; the split is exact (the port's FLOPs a device are "
               "its one-device FLOPs over 8); not traced further")
_FEW_ROWS = ("FLOPs {}{} of the reference's: a microbatch of {} (grad_accum "
             "{} on a batch of 4) does not split over the batch axes' {} "
             "devices, and both repeat work (the reference {:.2f}x its "
             "one-device count over 8, the port {:.2f}x on torch 2.13); "
             "which work each repeats depends on the partitioner")
KNOWN_FAULTS: dict[tuple[str, str, str], str] = {
    ("mamba2-2.7b", "train", "2x4"): _MOVES_MORE.format("0.59x",
                                                        "tied head"),
    ("mamba2-2.7b", "train", "2x2x2"): _MOVES_MORE.format("0.67x",
                                                          "tied head"),
    ("whisper-tiny", "train", "2x4"): _MOVES_MORE.format("0.57x", "head"),
    ("whisper-tiny", "train", "2x2x2"): _MOVES_MORE.format("0.67x", "head"),
    ("deepseek-v2-lite-16b", "train", "2x4"): _MOVES_MORE.format(
        "0.72x", "weights outside the remat'd layers (the head, the dense "
        "layer 0)"),
    ("granite-20b", "train", "2x2x2"): _FEW_ROWS.format(
        "-26 %", "", "2 rows", 2, 4, 1.70, 1.25),
    ("recurrentgemma-9b", "train", "2x2x2"): _FEW_ROWS.format(
        "-20 %", "", "2 rows", 2, 4, 1.63, 1.30),
    ("qwen2-vl-7b", "train", "2x4"): _ONE_DEVICE.format("+3.9 %", "+3.0 %"),
    ("qwen2-vl-7b", "train", "2x2x2"): _ONE_DEVICE.format("+3.9 %",
                                                          "+3.0 %"),
    ("llama4-maverick-400b-a17b", "train", "2x4"): _FEW_ROWS.format(
        "+16 %", "", "one row", 4, 2, 1.28, 1.47),
    ("llama4-maverick-400b-a17b", "train", "2x2x2"): _FEW_ROWS.format(
        "+39 %", " and collective bytes 1.33x", "one row", 4, 4, 1.75,
        2.41),
    ("smollm-135m", "prefill", "2x2x2"): _ONE_DEVICE.format("-2.7 %",
                                                            "-2.7 %"),
    ("qwen2-vl-7b", "prefill", "2x2x2"): _ONE_DEVICE.format("-3.5 %",
                                                            "-3.5 %"),
    ("llama4-maverick-400b-a17b", "prefill", "2x2x2"): _ONE_DEVICE.format(
        "-3.8 %", "-3.8 %"),
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


def reference_cases(archs, cells=None) -> list:
    """(arch, kind, mesh name) for each arch and cell (``CELLS`` unless
    given), those of ``KNOWN_FAULTS`` marked as expected to fail,
    strictly."""
    return [pytest.param(a, kind, m, marks=pytest.mark.xfail(
        strict=True, reason=KNOWN_FAULTS[(a, kind, m)]))
            if (a, kind, m) in KNOWN_FAULTS else (a, kind, m)
            for a in archs for kind, m in (cells or CELLS)]


def matches_reference(arch: str, kind: str, mesh_name_: str, meshes) -> None:
    """The smoke step of ``arch`` on the named mesh (as ``holds_on_mesh``
    ran it in this module, else run now) within ``FLOPS_TOL`` of the
    reference's FLOPs a device and ``COLL_TOL`` of its collective bytes a
    device (``cpu_lowered``)."""
    key = (arch, kind, mesh_name_)
    got = _ANALYSES.get(key) or holds_on_mesh(arch, kind, meshes[mesh_name_])
    want = json.loads(REFERENCE.read_text())["cells"][":".join(key)]
    coll = cpu_lowered(got)
    detail = (f"{key}: FLOPs {got['flops']:.0f} vs {want['flops']:.0f}; "
              f"collective bytes {coll:.0f} vs "
              f"{want['collective_total_bytes']:.0f}; port by kind "
              f"{got['collective_bytes_by_kind']}, reference by kind "
              f"{want['collective_bytes_by_kind']}")
    assert abs(got["flops"] - want["flops"]) <= FLOPS_TOL * want["flops"], \
        detail
    assert abs(coll - want["collective_total_bytes"]) <= \
        COLL_TOL * want["collective_total_bytes"], detail


def holds_on_mesh(arch: str, kind: str, mesh) -> dict:
    """A smoke step of ``arch`` run under ``launch/dryrun.lower_cell`` on
    ``mesh``: it must count each device's work, at least the unsharded
    step's FLOPs over the mesh's devices, and call the same kernel entries
    as the unsharded step on one device. -> the analysis (with its op
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
    assert got["kernel_calls"] == one["kernel_calls"]
    assert got["collective_total_bytes"] > 0
    assert got["peak_bytes"] >= got["argument_bytes"] > 0
    return got
