"""Meshes: the node axis of one problem split into slabs, and a batch of
problem instances split over devices.

The counterpart of opty_tpu/parallel/mesh.py, whose meshes are
``jax.sharding.Mesh`` objects and whose collectives ``shard_map``
inserts.  Here the slab axis is a tensor axis:

* ``NodeMesh(P)`` holds all P node slabs of a problem in this process,
  on one device, as a leading axis of every slab array (the JAX
  package's tests run the same on 8 virtual CPU devices; on the card
  all P slabs sit on the one GPU);
* ``NodeMesh(P, group=...)`` gives each rank of a ``torch.distributed``
  group one slab (P is the group's size).

Both carry the same three collectives (``SlabAxis``): ``gather`` of
each slab's boundary rows, ``psum`` of the border sums and
``next_first``, the ``ppermute`` that hands each slab its successor's
first coupling block.  parallel/spike.py runs one body over either.

A batch mesh is a list of torch devices (``make_batch_mesh``), or,
across processes, the one that ``multihost.global_batch_mesh`` returns.
Instances are independent, so a sharded batch solves to the unsharded
result.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device

__all__ = ['NodeMesh', 'SlabAxis', 'BatchMesh', 'ShardedBatch',
           'make_batch_mesh', 'shard_batch', 'solve_batch_sharded']


class SlabAxis:
    """The collectives over the node slabs, slab axis first.

    ``local`` slabs live in this process (all P, or one a rank) and
    ``index`` holds their positions 0..P-1."""

    def __init__(self, n_slabs, group=None, device=None):
        self.n_slabs = n_slabs
        self.group = group
        if group is None:
            self.local = n_slabs
            self.index = torch.arange(n_slabs, device=device)
        else:
            self.local = 1
            self.index = torch.tensor(
                [torch.distributed.get_rank(group)], device=device)

    def gather(self, x):
        """(local, ...) -> (P, ...): every slab's value."""
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.n_slabs)]
        torch.distributed.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=0)

    def psum(self, x):
        """(local, ...) -> (...): the sum over all slabs."""
        if self.group is None:
            return torch.sum(x, dim=0)
        out = x[0].clone()
        torch.distributed.all_reduce(out, group=self.group)
        return out

    def next_first(self, x):
        """(local, ...) -> (local, ...): slab p gets slab p + 1's value,
        the last slab zeros (the ppermute p + 1 -> p, masked)."""
        full = self.gather(x)
        full = torch.cat([full[1:], torch.zeros_like(full[:1])], dim=0)
        return full if self.group is None else full[self.index]

    def take(self, x):
        """(P, ...) -> (local, ...): this process's slabs of a value
        known for every slab."""
        return x if self.group is None else x[self.index]


class NodeMesh:
    """P node slabs of one problem: all in this process (on the device of
    the arrays split over them), or one a rank of the process group
    ``group`` (P is then its size).  ``shape`` maps the axis name to P,
    as a JAX mesh's does."""

    def __init__(self, n_slabs=None, group=None, axis_name='node'):
        if group is not None:
            size = torch.distributed.get_world_size(group)
            if n_slabs not in (None, size):
                raise ValueError('a process group of {} ranks holds {} '
                                 'slabs, not {}'.format(size, size, n_slabs))
            n_slabs = size
        if not n_slabs or n_slabs < 1:
            raise ValueError('a node mesh needs at least one slab')
        self.n_slabs = int(n_slabs)
        self.group = group
        self.axis_name = axis_name

    @property
    def shape(self):
        return {self.axis_name: self.n_slabs}

    def axis(self, device):
        return SlabAxis(self.n_slabs, self.group, device)

    def __repr__(self):
        return 'NodeMesh({}, group={})'.format(self.n_slabs, self.group)


class BatchMesh(NamedTuple):
    """Devices of this process over which a batch is split (``devices``),
    and across processes the group (None: this process alone)."""
    devices: tuple
    group: object = None


class ShardedBatch(NamedTuple):
    """This process's rows of a batch split over the processes of
    ``mesh`` (multihost.host_local_batch_to_global)."""
    local: torch.Tensor
    mesh: BatchMesh


def make_batch_mesh(devices=None):
    """A batch mesh over the given devices (default: the card)."""
    if devices is None:
        devices = [resolve_device(None)]
    return BatchMesh(tuple(torch.device(d) for d in devices))


def shard_batch(arr, mesh):
    """Split a batch's rows evenly over the mesh's devices: a list of
    one tensor a device (the batch's length must be a multiple of the
    mesh's size)."""
    n = len(mesh.devices)
    arr = torch.as_tensor(np.asarray(arr)) if not torch.is_tensor(arr) \
        else arr
    if arr.shape[0] % n:
        raise ValueError('a batch of {} rows does not split over {} '
                         'devices'.format(arr.shape[0], n))
    return [part.to(dev) for part, dev in
            zip(torch.chunk(arr, n, dim=0), mesh.devices)]


def _same_device(a, b):
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _drop_padding(res, rows, padded):
    return type(res)(*[a[:rows] if torch.is_tensor(a) and a.ndim
                       and a.shape[0] == padded else a for a in res])


def _gather_rows(res, group):
    """Every process's rows of a result, in process order."""
    out = []
    for a in res:
        # gloo gathers no bool: as bytes
        v = a.to(torch.uint8) if a.dtype == torch.bool else a.contiguous()
        parts = [torch.empty_like(v)
                 for _ in range(torch.distributed.get_world_size(group))]
        torch.distributed.all_gather(parts, v, group=group)
        out.append(torch.cat(parts, dim=0).to(a.dtype))
    return type(res)(*out)


def solve_batch_sharded(problem, free_batch, mesh=None):
    """Solve a batch of instances of ``problem`` split over a mesh.

    ``free_batch`` rows are independent initial guesses; the batch is
    padded up to a multiple of the mesh's size with copies of its last
    row, and the padding rows are dropped from the result (the batched
    IPMResult).  A ``ShardedBatch`` is solved by each process on its own
    rows, and every process gets all rows back.  A problem lives on one
    device: every device of the mesh must be the problem's."""
    if isinstance(free_batch, ShardedBatch):
        res = problem.solve_batch(free_batch.local)
        return _gather_rows(res, free_batch.mesh.group)
    if mesh is None:
        mesh = make_batch_mesh([problem.device])
    other = [d for d in mesh.devices if not _same_device(d, problem.device)]
    if other:
        raise ValueError('the problem lives on {}; build one a device to '
                         'solve on {}'.format(problem.device, other))
    free_batch = np.asarray(free_batch.detach().cpu() if torch.is_tensor(
        free_batch) else free_batch, dtype=np.float64)
    rows = free_batch.shape[0]
    pad = (-rows) % len(mesh.devices)
    if pad:
        free_batch = np.concatenate(
            [free_batch, np.repeat(free_batch[-1:], pad, axis=0)], axis=0)
    res = problem.solve_batch(free_batch)
    return _drop_padding(res, rows, rows + pad) if pad else res
