"""Device meshes for multi-device Jindo and Buckler runs, on
``torch.distributed``: one process per device, the meshes of
``torch.distributed.device_mesh``.

The axes (the JAX package's, ringo_tpu/parallel/mesh.py):

* ``dp``: the batch of independent commitments, openings or witnesses;
* ``tp``: the RNS prime planes of the commitment rings; every ring
  operation is plane-local but the exact CRT of the cutoff, which needs
  every plane (rings/rns_device.py);
* ``sp``: the MSIS / decomposition rows of the Ajtai products, and the
  coefficient grid of the four-step big-field NTT (parallel/bigntt.py).

PyTorch has no GSPMD, so the sharded programs are explicit SPMD: each rank
computes its shard and calls the collective that the JAX package's sharding
constraint stands for, through ``Axis``.  The collectives run at every
world size, 1 included.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .. import backend

AXES = ("dp", "tp", "sp")

# all_gather_single replaces all_gather_into_tensor in newer releases
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def mesh_shape(n: int, axes=AXES) -> tuple[int, ...]:
    """n devices factored onto the axes left to right by repeated halving
    (an odd remainder goes whole to the next axis): 8 -> (2, 2, 2),
    4 -> (2, 2, 1), 1 -> (1, 1, 1)."""
    dims = [1] * len(axes)
    i, rem = 0, n
    while rem > 1:
        f = 2 if rem % 2 == 0 else rem
        dims[i % len(dims)] *= f
        rem //= f
        i += 1
    return tuple(dims)


def make_mesh(n_devices: int | None = None, axis_names=AXES,
              shape: tuple[int, ...] | None = None, device=None):
    """A ``DeviceMesh`` over the world of the default process group
    (``init_multihost``), one device per process: ``n_devices`` (default:
    the world size) must be that world's size, ``shape`` defaults to
    ``mesh_shape``.  ``device=None`` means the card (raises without CUDA);
    the tests pass ``"cpu"`` (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    device = backend.resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.init_multihost first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} "
                         "processes: one process per device")
    shape = mesh_shape(n, axis_names) if shape is None else tuple(shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return init_device_mesh(device.type, shape,
                            mesh_dim_names=tuple(axis_names))


class Axis:
    """One axis of a mesh as this rank sees it: the process group of the
    ranks that differ only along it, their count and this rank's place.
    ``take`` and ``gather`` split a dimension over those ranks and put it
    back together.  An uneven split is padded: each rank takes
    ceil(n / size) indices, the ones past the end repeating the last, and
    ``gather`` keeps the first n of the concatenation."""

    def __init__(self, mesh, name: str):
        if name not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"the mesh has no {name!r} axis")
        self.name = name
        self.group = mesh.get_group(name)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def take(self, n: int, device) -> torch.Tensor:
        """This rank's indices into a dimension of size n."""
        c = -(-n // self.size)
        idx = torch.arange(self.rank * c, (self.rank + 1) * c, device=device)
        return torch.clamp(idx, max=n - 1)

    def gather(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """The ranks' equal chunks of ``dim`` concatenated in rank order,
        the first n kept."""
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x, group=self.group)
        return out[:n].movedim(0, dim)


def mesh_axes(mesh, device) -> tuple[Axis, Axis, Axis]:
    """The mesh's dp, tp and sp axes, for tensors on ``device``; raises
    when the mesh lies on another kind of device."""
    device = torch.device(device)
    if mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot shard tensors "
                         f"on {device}")
    return tuple(Axis(mesh, a) for a in AXES)


def check_device(mesh, *tensors) -> None:
    """Raise unless every tensor lies on the mesh's kind of device."""
    for t in tensors:
        if t.device.type != mesh.device_type:
            raise ValueError(f"a {mesh.device_type} mesh was given a tensor "
                             f"on {t.device}")
