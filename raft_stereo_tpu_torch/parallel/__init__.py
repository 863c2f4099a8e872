"""Parallel execution over several processes, one card each.

The JAX package shards its arrays over a device ``Mesh`` and lets XLA insert
the collectives. Here each process holds its own part and calls the
collectives itself (``torch.distributed``): a :class:`ProcessGrid` of
``(data, space)`` extents, the gradient sum over the world, the loss's
partial sums, and the halo rows of the height-sharded refinement loop
(``ops/halo.py``).
"""

from raft_stereo_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshShape,
    ProcessGrid,
    choose_mesh,
    local_batch_rows,
    make_mesh,
    maybe_distributed_init,
    shard_batch,
    space_mesh_of,
    validate_spatial_shard,
)
