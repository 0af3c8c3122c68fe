"""Multi-process entry path: ``torch.distributed`` initialization and the
data-parallel batch split across processes.

The counterpart of opty_tpu/parallel/multihost.py, which federates
processes through ``jax.distributed``.  Here each process joins one
``torch.distributed`` group (gloo between CPU processes, NCCL between
cards), contributes its rows of an instance batch, solves them, and
gets every process's rows back.  A node mesh over the same group
(``mesh.NodeMesh(group=...)``) splits one problem's KKT solve over the
processes instead (parallel/spike.py).

Usage (the same calls on every process, before any solve)::

    from opty_tpu_torch.parallel import multihost
    multihost.initialize(coordinator_address='host0:1234',
                         num_processes=4, process_id=rank)
    mesh = multihost.global_batch_mesh()
    batch = multihost.host_local_batch_to_global(local_free, mesh)
    res = solve_batch_sharded(problem, batch)   # every row, every process

Nothing discovers a cluster: the coordinator's address, the number of
processes and this one's id are given, or read from the environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) when
omitted.  ``tests/test_torch_multihost.py`` runs two gloo CPU processes.
"""

import numpy as np
import torch
import torch.distributed as dist

from .mesh import BatchMesh, ShardedBatch

__all__ = ['initialize', 'global_batch_mesh',
           'host_local_batch_to_global', 'replicate_to_global']


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, cpu_collectives='gloo', device=None):
    """Join (or start) the process group.  Idempotent: a second call is
    a no-op.  ``device`` is this process's device ('cpu', or a card:
    None means the card when one is present); CPU processes use
    ``cpu_collectives`` (gloo), cards NCCL."""
    if dist.is_initialized():
        return
    if device is None:
        device = 'cuda' if torch.cuda.is_available() else 'cpu'
    backend = 'nccl' if torch.device(device).type == 'cuda' \
        else cpu_collectives
    if coordinator_address is None:
        dist.init_process_group(backend, init_method='env://')
        return
    dist.init_process_group(backend,
                            init_method='tcp://' + coordinator_address,
                            world_size=num_processes, rank=process_id)


def _local_device():
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def global_batch_mesh(axis_name='batch'):
    """The batch mesh over every process of the group (data parallel):
    this process's device, and the group."""
    return BatchMesh((_local_device(),), dist.group.WORLD)


def host_local_batch_to_global(local_batch, mesh, axis_name='batch'):
    """The global batch whose rows are every process's ``local_batch``
    (B_local, ...) in process order (every process gives as many).  No
    data moves: each process keeps the rows it holds."""
    local = torch.as_tensor(np.asarray(local_batch, dtype=np.float64),
                            device=mesh.devices[0])
    return ShardedBatch(local, mesh)


def replicate_to_global(value, mesh):
    """A host value (the same on every process) on the mesh's device."""
    return torch.as_tensor(np.asarray(value), device=mesh.devices[0])
