"""Device meshes of the LM half (twin of ``repro.launch.mesh``), as
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group.

Defined as functions, never module-level constants: importing this module
touches no process group.

Topology (the reference's, written against axis names):
  single-pod: (16, 16)    = ("data", "model")          -- 256 ranks
  multi-pod:  (2, 16, 16) = ("pod", "data", "model")   -- 512 ranks; the
              "pod" axis composes with "data" for DP / FSDP.

A rank is a process with one device.  The reference's ``jax.make_mesh``
raises unless the process sees exactly the mesh's device count; here a
mesh must cover the group's world, and a wrong world size raises naming
the ranks the mesh wants.  A one-process run joins a one-rank group
(:func:`launch_group`), so every launcher path runs on a mesh, as the
reference's ``make_host_mesh()`` binds the one device it sees.

The sharding rules read only a mesh's axis names and sizes, so an
object with the reference's ``axis_names`` and ``shape[name]`` (its
tests' ``FakeMesh``) serves as well as a ``DeviceMesh``.  The graph
half's 1-axis data mesh is
:class:`repro_torch.distributed.sharding.GraphMesh`.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from datetime import timedelta
from typing import Any, Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.runtime import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def axis_names(mesh: Any) -> tuple[str, ...]:
    """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names`` or an
    abstract mesh's ``axis_names``."""
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_sizes(mesh: Any) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an abstract mesh
    (``axis_names`` and ``shape[name]``, as the reference's ``Mesh``)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


@contextmanager
def launch_group(device: str | torch.device = "cuda",
                 timeout_s: float = 600.0) -> Iterator[None]:
    """The default process group for a launcher's run: an initialised one
    as it is; else the one ``torchrun`` describes in the environment
    (``WORLD_SIZE``), or a one-rank group of this process over an
    in-memory store -- NCCL on the card, gloo on the CPU -- destroyed on
    the way out."""
    if dist.is_initialized():
        yield
        return
    dev = resolve_device(device)
    timeout = timedelta(seconds=timeout_s)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(_backend(dev), timeout=timeout)
    else:
        dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1, timeout=timeout)
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        yield
    finally:
        dist.destroy_process_group()


def _device_type(device: str | torch.device | None) -> str:
    if device is not None:
        return torch.device(device).type
    return "cuda" if str(dist.get_backend()) == "nccl" else "cpu"


def _mesh(dims: tuple[int, ...], names: tuple[str, ...],
          device: str | torch.device | None, what: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs an initialised process group "
                           f"(launch.mesh.launch_group, torchrun, or "
                           f"distributed.ranks.run_ranks)")
    want = 1
    for n in dims:
        want *= n
    world = dist.get_world_size()
    if world != want:
        raise ValueError(
            f"{what} {dict(zip(names, dims))} needs {want} ranks; the "
            f"process group has {world}")
    return init_device_mesh(_device_type(device), dims,
                            mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, *,
                         device: str | torch.device | None = None
                         ) -> DeviceMesh:
    """The production mesh over the group's 256 (512 with ``multi_pod``)
    ranks; raises on any other world size, naming the count.  The device
    type defaults to the group's (NCCL: cuda; otherwise cpu)."""
    dims, names = PRODUCTION[bool(multi_pod)]
    return _mesh(dims, names, device,
                 "the multi-pod mesh" if multi_pod else "the production mesh")


def make_host_mesh(n_devices: int | None = None, model: int = 1, *,
                   device: str | torch.device | None = None) -> DeviceMesh:
    """A (world / model, model) ("data", "model") mesh over the group's
    ranks (tests, one host); ``n_devices``, when given, must be the world
    size."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if n % model:
        raise ValueError(f"{n} ranks do not divide into a model axis of "
                         f"{model}")
    return _mesh((n // model, model), ("data", "model"), device,
                 "the host mesh")


def dp_axes(mesh: Any) -> tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axes_size(mesh: Any, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    s = 1
    for a in axes:
        s *= sizes[a]
    return s
