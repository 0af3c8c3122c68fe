from .mesh import make_batch_mesh, shard_batch, solve_batch_sharded

__all__ = ['make_batch_mesh', 'shard_batch', 'solve_batch_sharded']
