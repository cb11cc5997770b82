"""Device meshes over the initialised process group.

The port is multi-controller, the idiom of ``torch.distributed``: one
process per rank.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the default process group, which the caller initialises
(``torch.distributed.init_process_group``, with its store, world size and
rank) before building one.  The group's backend follows the device: NCCL
for ``cuda``, gloo for ``cpu``.

``init_fake_world`` sets up the dry run's world instead: the ``fake``
backend, every rank of a 256- or 512-rank production mesh stood for by this
one process.  A process has one default group, so a fake world never shares
a process with a real one (the launcher's ``dryrun`` command runs in a
process of its own, as the reference sets ``XLA_FLAGS`` before any import).

FUNCTIONS, not module-level constants: importing this module touches no
process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: the backend a mesh on each device type needs
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
#: the dry run's backend: a world of ranks in one process, whose
#: collectives return at once (it serves a mesh of any device type)
FAKE_BACKEND = "fake"


def make_mesh(axis_shapes, axis_names, *, device: str = "cuda") -> DeviceMesh:
    """A mesh of ``axis_shapes`` named ``axis_names`` over every rank of the
    default group, laid out in rank order.  Raises if the group is not
    initialised, its backend is not ``device``'s or its world size is not
    the mesh's size."""
    axis_shapes, axis_names = tuple(axis_shapes), tuple(axis_names)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} axis sizes for "
                         f"{len(axis_names)} names")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (torch.distributed.init_process_group)")
    want = BACKENDS[device]
    if dist.get_backend() not in (want, FAKE_BACKEND):
        raise ValueError(f"a mesh on {device} needs the {want} backend; the "
                         f"default group has {dist.get_backend()}")
    size, world = math.prod(axis_shapes), dist.get_world_size()
    if size != world:
        raise ValueError(f"a mesh of {axis_shapes} needs {size} ranks; the "
                         f"default group has {world}")
    return init_device_mesh(device, axis_shapes, mesh_dim_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """The reference's production shapes: (16, 16) ``data, model``, or
    (2, 16, 16) ``pod, data, model`` across two pods.  Raises, naming the
    world size it needs, when the group is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(*, device: str = "cuda") -> DeviceMesh:
    """The (1, 1) ``data, model`` mesh of one rank."""
    return make_mesh((1, 1), ("data", "model"), device=device)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def init_fake_world(world_size: int, rank: int = 0) -> None:
    """Initialise the default group on the ``fake`` backend: ``world_size``
    ranks, this process rank ``rank`` of them, no peer.  Collectives return
    at once without moving data (the dry run counts them, on fake
    tensors).  Re-initialises when a fake world of another size is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != FAKE_BACKEND:
            raise RuntimeError("this process has a real process group: the "
                               "dry run's fake world needs a process of its "
                               "own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_fake_production_mesh(*, multi_pod: bool = False,
                              device: str = "cuda") -> DeviceMesh:
    """``make_production_mesh`` over a fake world of its size (256 ranks,
    or 512 across two pods): the dry run's mesh, built on a host with no
    card."""
    init_fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device=device)
