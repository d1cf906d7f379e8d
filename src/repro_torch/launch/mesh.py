"""Production mesh factory (PyTorch port of ``repro.launch.mesh``).

The reference lowers its cells for TPU pods on 512 placeholder host
devices. Here a pod is a mesh of H100s built over a fake process group
(``torch.testing._internal.distributed.fake_pg``): this process plays rank
0 of 512, and a collective returns at once without moving data. Tensors on
such a mesh are DTensors whose local shards are rank 0's, on the meta
device (``models/modules.abstract_params``), so a step lowers without a
card, a network or any allocation. The mesh's device type is "cuda", so
DTensor issues the collectives a GPU mesh would (an all-to-all, where a
"cpu" mesh falls back to all-gather and chunk).

Functions, not module-level constants, so importing this module never
touches a process group. The group is started once a process, with world
size 512; the single-pod mesh uses its first 256 ranks. This is the one
module of the package that imports ``torch.testing._internal``.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

WORLD = 512                       # 2 pods x 16 x 16


def fake_world(world_size: int = WORLD) -> None:
    """Start the fake process group (rank 0 of ``world_size``) unless one
    is running; a running group must be that fake one, at least as
    large."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world_size:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is running; the production "
                f"meshes need the fake group of {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` (major to minor) over the first
    prod(shape) ranks of the fake group."""
    fake_world(max(WORLD, math.prod(shape)))
    import torch
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh("cuda", ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh_by_name(name: str) -> DeviceMesh:
    if name in ("single", "single_pod", "16x16"):
        return make_production_mesh(multi_pod=False)
    if name in ("multi", "multi_pod", "2x16x16"):
        return make_production_mesh(multi_pod=True)
    raise ValueError(f"unknown mesh {name!r}")


def mesh_chips(mesh) -> int:
    return int(mesh.size())
