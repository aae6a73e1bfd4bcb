"""Mesh construction on ``torch.distributed`` (mirrors
:mod:`repro.launch.mesh`).

Functions, not module-level constants, so importing this module touches no
process group. Single pod: 16x16 = 256 ranks ("data", "model"). Multi-pod:
2x16x16 = 512 ranks ("pod", "data", "model"); the 'pod' axis carries
either extra DP (default) or the compressed gradient reduction
(:mod:`repro_torch.parallel.compression`).

Every mesh spans the default process group's world, which the caller
initialises (``torch.distributed.init_process_group`` with its own
address, world size and rank); its device type is the caller's device's
(``"cuda"`` unless ``device="cpu"``, under ``gloo``).

:func:`fake_production_mesh` builds the production mesh in a fake world:
this process joins a process-local group of 256 or 512 ranks as rank 0,
on the ``"fake"`` backend that ``torch.testing._internal.distributed.
fake_pg`` registers, whose collectives return at once and move nothing.
It is for counting one rank's step on ``meta`` tensors (the dry-run's
``--mesh single|multi``), never for computing. The group is the process's
default group, so only a process of its own (a spawned worker) joins it.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import MeshShape

PRODUCTION_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}
PRODUCTION_SHAPES = {False: (16, 16), True: (2, 16, 16)}


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call torch.distributed"
                           ".init_process_group first")
    return dist.get_world_size()


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axis_names`` over the whole world (the
    reference's ``jax.make_mesh``): rank ``r`` at the row-major coordinate
    of ``r``. On the card each rank uses its local card, ``rank %
    device_count()``."""
    world = _world()
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"a mesh {shape} named {tuple(axis_names)} does "
                         f"not cover the world of {world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, shape,
                            mesh_dim_names=tuple(axis_names))


def make_debug_mesh(n: int | None = None, device=None) -> DeviceMesh:
    """A ("data", "model") mesh over the world, 'model' the largest of 4,
    2, 1 dividing it (tests / examples); ``n`` must be the world size."""
    world = _world()
    n = n or world
    if n != world:
        raise ValueError(f"the debug mesh spans the world of {world} "
                         f"ranks, not {n}")
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return make_mesh((n // model, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, shape_only: bool = False,
                         device=None):
    """(16, 16) ("data", "model"), or with ``multi_pod`` (2, 16, 16)
    ("pod", "data", "model"), over a world of 256 or 512 ranks; with
    ``shape_only`` its :class:`MeshShape`, which needs no process group
    (a planner's layout of the production mesh)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod], PRODUCTION_AXES[multi_pod]
    if shape_only:
        return MeshShape(axes, shape)
    world = _world()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the world "
                         f"has {world} (shape_only=True gives its shape)")
    return make_mesh(shape, axes, device)


def join_fake_world(world: int) -> None:
    """Join a fake world of ``world`` ranks as rank 0 (module docstring);
    raises if this process already has a default group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("this process already has a default process "
                           "group; join the fake world in a process of its "
                           "own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh (:func:`make_production_mesh`, its device type
    ``"cpu"``) of a fake world that this process joins for the rest of its
    life, as rank 0 at coordinate ``(0, 0)`` or ``(0, 0, 0)``."""
    join_fake_world(math.prod(PRODUCTION_SHAPES[multi_pod]))
    return make_production_mesh(multi_pod=multi_pod, device="cpu")
