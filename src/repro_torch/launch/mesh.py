"""Device meshes on ``torch.distributed``: the port of the JAX package's
``repro.launch.mesh``.  Functions, not module constants, so importing
this module never touches a process group.

A mesh spans the ranks of the current process group
(``init_device_mesh``); the production meshes need a group of their size:
``fake_world`` makes one in a single process for the dry-run, on the
``fake`` backend (no device work, every collective a no-op).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch.distributed as dist

from repro_torch.distributed.sharding import mesh_axis_sizes

__all__ = ["fake_world", "make_host_mesh", "make_mesh_auto",
           "make_production_mesh", "mesh_axis_sizes"]


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh_auto(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    current process group (whose size must be the product of ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_auto(shape, axes)


def make_host_mesh(model_parallel: int = 1):
    """A ``(world // model_parallel, model_parallel)`` ("data", "model")
    mesh over every rank of the current group."""
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel="
                         f"{model_parallel}")
    return make_mesh_auto((n // model_parallel, model_parallel),
                          ("data", "model"))


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """A default process group of ``size`` ranks in this one process, on
    the ``fake`` backend, for the span of the block.  Raises if a group is
    already initialized."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
