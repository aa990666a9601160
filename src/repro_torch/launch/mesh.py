"""Device meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``'s
``make_mesh`` and ``make_host_mesh``).

A :class:`Mesh` lays the ranks of the default process group out on named
axes in row-major order (rank ``r`` of a ``(data, model)`` mesh sits at
``(r // model, r % model)``, the order ``jax.make_mesh`` gives devices) and
holds one process group for every set of axes: the ranks that share their
coordinates on all the other axes.  ``mesh.shape`` is a dict, as the
reference's code reads it (``mesh.shape["model"]``).

The caller initialises the default group (``torchrun``'s environment, or
:func:`init_single_rank` for a one-rank group in-process) and passes each
rank's device; collectives then run on the tensors' own devices: NCCL for
``cuda`` tensors, gloo for CPU tensors (:func:`backend_for`).
:func:`make_production_mesh` lays the launcher's world out as ``(data,
model)`` or ``(pod, data, model)``; :func:`elastic_mesh` rebuilds the
largest ``(data, model)`` mesh of a failure's survivors, ``model`` kept.
Multi-rank meshes are held on gloo ranks on the CPU; on the card a mesh
has one rank (one H100 a machine).
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device


class Mesh:
    """This rank's view of a mesh: axis sizes, its coordinates, its device
    and one process group per set of axes (:meth:`group`)."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int], groups: Dict[Tuple[str, ...], object],
                 device: torch.device):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.coords = dict(coords)
        self.device = device
        self._groups = groups

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group spanning ``axes`` (one name or several) through
        this rank."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in names)
        if not key or len(key) != len(set(names)):
            raise ValueError(f"axes {names} are not a non-empty subset of the mesh axes {self.axis_names}")
        return self._groups[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords}, device={self.device})"


def backend_for(device) -> str:
    """gloo for a CPU mesh; gloo for CPU tensors and NCCL for CUDA ones on
    the card, so one group serves both."""
    return "gloo" if torch.device(device).type == "cpu" else "cpu:gloo,cuda:nccl"


def init_single_rank(device) -> None:
    """A one-rank default process group in this process (no launcher, no
    port: the store is in memory)."""
    dist.init_process_group(backend_for(device), store=dist.HashStore(), rank=0, world_size=1)


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` by default (the card; an error
    without one), or the device given."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None) -> Mesh:
    """A mesh of ``shape`` over the ranks of the default process group,
    which must hold exactly ``prod(shape)`` ranks.  Every rank calls this
    with the same arguments: each subgroup is created collectively, in the
    same order on every rank."""
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(torchrun's environment, or launch.mesh.init_single_rank)")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs {int(np.prod(shape))} ranks, the group has {world}")
    rank = dist.get_rank()
    grid = np.arange(world).reshape(shape)
    me = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups: Dict[Tuple[str, ...], object] = {}
    for n in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), n):
            others = [i for i in range(len(axes)) if i not in sub]
            for fixed in itertools.product(*(range(shape[i]) for i in others)):
                index = [slice(None)] * len(axes)
                for i, c in zip(others, fixed):
                    index[i] = c
                ranks = sorted(int(r) for r in grid[tuple(index)].reshape(-1))
                g = dist.new_group(ranks)
                if all(me[i] == c for i, c in zip(others, fixed)):
                    groups[tuple(axes[i] for i in sub)] = g
    return Mesh(dict(zip(axes, shape)), dict(zip(axes, me)), groups, rank_device(device))


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ``(data, model)`` mesh over the default group's ranks."""
    return make_mesh((data, model), ("data", "model"), device)


def make_production_mesh(*, model: int = 1, multi_pod: bool = False, device=None) -> Mesh:
    """The deployment mesh over the default group's ranks (the launcher's
    ``WORLD_SIZE``): ``(data, model)``, or with ``multi_pod`` ``(pod=2, data,
    model)``; ``data`` takes what ``model`` (and the pods) leave.  ``pod``
    composes with ``data`` for batch and gradient parallelism; its
    reduction hop is the one the trainer's hierarchical reduction treats
    apart (``parallel.collectives.hierarchical_grad_sync``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialised default process group")
    world, pods = dist.get_world_size(), 2 if multi_pod else 1
    if model < 1 or world % (pods * model):
        raise ValueError(f"{world} ranks do not split into {pods} pod(s) of model={model}")
    data = world // (pods * model)
    if multi_pod:
        return make_mesh((pods, data, model), ("pod", "data", "model"), device)
    return make_mesh((data, model), ("data", "model"), device)


def elastic_mesh(n_healthy: int, *, model: int = 16, device=None, init_method=None, rank=None) -> Mesh:
    """Elastic re-shape after losing ranks: the largest ``(data, model)``
    mesh that ``n_healthy`` survivors hold, ``model`` kept (the parameter
    placement stays valid) and ``data`` shrunk.  With ``init_method`` (a
    rendezvous URL) the survivors first make a fresh default group of
    ``data * model`` ranks, this one ``rank`` (the old group, whose other
    members are gone, is destroyed); without it the default group must
    already be the survivors'."""
    if n_healthy < model or model < 1:
        raise ValueError(f"cannot keep model={model} with {n_healthy} ranks")
    data = n_healthy // model
    world = data * model
    if init_method is not None:
        if rank is None or not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not one of the {world} ranks the new mesh holds")
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group(backend_for(rank_device(device)), init_method=init_method, rank=rank,
                                world_size=world)
    return make_mesh((data, model), ("data", "model"), device)
