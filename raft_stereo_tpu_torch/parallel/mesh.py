"""Process grids over ``torch.distributed``: the JAX package's device mesh
(``parallel/mesh.py``) with one process per card.

Axes, as in the JAX package:
- ``data``: batch data parallelism; each data index trains on its rows of
  the global batch and the gradients are summed over the world
  (``engine/steps.py``);
- ``space``: each sample's height split over the ranks of a space row.
  The encoders run whole on every rank of the row; each rank keeps its rows
  of the feature maps and the context, builds the correlation volume of
  those rows only (rows are independent) and runs the refinement loop on
  them, exchanging halo rows with its neighbours where a convolution needs
  them (``ops/halo.py``). The volume, the memory that ``--spatial_shard``
  exists to split, is 1/``n_space`` a rank.

Rank ``r`` sits at data index ``r // n_space`` and space index ``r %
n_space``: a space row is ``n_space`` consecutive ranks, which a launcher
that numbers each host's processes consecutively keeps inside one host.

The launch contract is the JAX package's: ``COORDINATOR_ADDRESS``
(``host:port``), ``PROCESS_ID`` and ``NUM_PROCESSES``, the last two set
together (:func:`maybe_distributed_init`).
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from raft_stereo_tpu_torch.parallel import comm


def _local_index(pid: int) -> int:
    return int(os.environ.get("LOCAL_RANK", pid))


def maybe_distributed_init(backend: Optional[str] = None, device=None) -> bool:
    """Join the process group when launched as several processes (a no-op
    that returns False otherwise, or when already joined).

    Opt-in via ``COORDINATOR_ADDRESS`` (``host:port`` of the rendezvous,
    served by process 0); ``PROCESS_ID`` and ``NUM_PROCESSES`` give this
    process's rank and the world size. ``device`` is the card this process
    uses (``cuda`` picks ``cuda:<LOCAL_RANK or PROCESS_ID mod cards>``);
    the backend is NCCL when each rank owns its card, gloo on the CPU.
    ``backend`` sets it explicitly: ``"gloo"`` lets two ranks share one
    card (their collectives staged through host memory). Two ranks on one
    card without it raise: NCCL refuses them, and nothing swaps the backend
    behind the caller's back.
    """
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if not addr:
        return False
    if dist.is_initialized():
        return True
    pid, num = os.environ.get("PROCESS_ID"), os.environ.get("NUM_PROCESSES")
    if (pid is None) != (num is None):
        raise RuntimeError(
            "PROCESS_ID and NUM_PROCESSES must be set together (manual "
            "multi-host launch needs COORDINATOR_ADDRESS, PROCESS_ID and "
            f"NUM_PROCESSES); got PROCESS_ID={pid!r} NUM_PROCESSES={num!r}")
    if pid is None:
        raise RuntimeError(
            "COORDINATOR_ADDRESS is set without PROCESS_ID and NUM_PROCESSES: "
            "torch.distributed has no topology discovery; set all three")
    rank, world = int(pid), int(num)
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"COORDINATOR_ADDRESS must be host:port, got {addr!r}")
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_index(rank) % max(1, torch.cuda.device_count()))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    chosen = backend or ("nccl" if dev.type == "cuda" else "gloo")
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0)
    me = f"{socket.gethostname()}|{dev}"
    store.set(f"rst_rank_{rank}", me)
    placed = [store.get(f"rst_rank_{r}").decode() for r in range(world)]
    if dev.type == "cuda" and backend is None and placed.count(me) > 1:
        raise RuntimeError(
            f"{placed.count(me)} ranks share {dev} on {socket.gethostname()}: NCCL takes one "
            "rank a card; pass backend='gloo' explicitly to share a card")
    dist.init_process_group(chosen, store=store, rank=rank, world_size=world)
    return True


def local_world_size() -> Optional[int]:
    """Ranks on this process's host, from every rank's host name (a
    collective: every rank calls it); None without a process group."""
    if not dist.is_initialized():
        return None
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return names.count(socket.gethostname())


def validate_spatial_shard(n_space: int, n_devices: int,
                           local_devices: Optional[int] = None) -> None:
    """Shared checks for the ``space`` (height) axis extent.

    Raises ValueError (CLIs turn it into their exit style). The /32 rule:
    every input is padded to a /32-multiple height (train crops and eval
    padding alike), so a shard count dividing 32 shards every feature scale
    evenly. ``local_devices`` (several hosts): the space axis must fit
    within one host's ranks, so its halo and volume traffic stays on the
    host's links.
    """
    if n_space <= 1:
        return
    if n_devices % n_space:
        raise ValueError(
            f"spatial_shard {n_space} does not divide the "
            f"{n_devices} available device(s)")
    if 32 % n_space:
        raise ValueError(
            f"spatial_shard {n_space} must divide 32 so every /32-multiple "
            "input height shards evenly at all scales")
    if local_devices is not None and local_devices % n_space:
        raise ValueError(
            f"spatial_shard {n_space} must divide the {local_devices} "
            "devices local to each host, or the space axis would span "
            "hosts and its halo/volume traffic would ride DCN instead of "
            "ICI")


class MeshShape(NamedTuple):
    """A grid's extents, as :func:`choose_mesh` picks them."""

    n_data: int
    n_space: int


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """The JAX package's ``Mesh`` over processes: ``(n_data, n_space)``,
    this rank's place in it, and the process group of its space row."""

    n_data: int
    n_space: int
    rank: int
    backend: Optional[str]
    space_ranks: Tuple[int, ...]   # global ranks of this rank's space row, in order
    space_group: Any = None        # their process group (None: one rank a row)

    @property
    def size(self) -> int:
        return self.n_data * self.n_space

    @property
    def data_index(self) -> int:
        return self.rank // self.n_space

    @property
    def space_index(self) -> int:
        return self.rank % self.n_space

    @property
    def is_lead(self) -> bool:
        return self.rank == 0

    def prev_rank(self) -> Optional[int]:
        """The global rank holding the rows above this rank's, or None."""
        s = self.space_index
        return self.space_ranks[s - 1] if s > 0 else None

    def next_rank(self) -> Optional[int]:
        """The global rank holding the rows below this rank's, or None."""
        s = self.space_index
        return self.space_ranks[s + 1] if s + 1 < self.n_space else None

    def rows(self, h: int) -> slice:
        """This rank's rows of a map of global height ``h``."""
        if h % self.n_space:
            raise ValueError(f"height {h} does not split over {self.n_space} space ranks")
        hl = h // self.n_space
        return slice(self.space_index * hl, (self.space_index + 1) * hl)

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over every rank of the grid, in place."""
        if self.size == 1:
            return t
        return comm.all_reduce_sum_(t, self.backend)

    def all_reduce_sum_list_(self, tensors: Sequence[torch.Tensor]) -> None:
        if self.size > 1:
            comm.all_reduce_sum_list_(tensors, self.backend)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This space row's rows of ``x`` (B, h, ...) gathered to the whole
        map (B, h * n_space, ...), on every rank of the row."""
        if self.n_space == 1:
            return x
        return comm.all_gather_cat(x, self.n_space, self.backend, self.space_group, dim=1)

    def any_rank(self, flag: bool, device=None) -> bool:
        if self.size == 1:
            return flag
        dev = torch.device("cpu") if self.backend == "gloo" or device is None else device
        return comm.any_rank(flag, self.backend, dev)


def make_mesh(n_data: Optional[int] = None, n_space: int = 1) -> ProcessGrid:
    """The grid over the joined process group (one process when not
    joined). Every rank of the world must be in it, and every rank must
    call this in the same order: the space rows' groups are created here
    (``dist.new_group`` is collective)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_space
    if n_data * n_space != world:
        raise ValueError(f"a {n_data} x {n_space} grid needs {n_data * n_space} processes, "
                         f"the world has {world} (every rank must be in the grid)")
    backend = dist.get_backend() if dist.is_initialized() else None
    rows = [tuple(range(d * n_space, (d + 1) * n_space)) for d in range(n_data)]
    group = None
    if n_space > 1:
        for ranks in rows:
            g = dist.new_group(list(ranks))
            if rank in ranks:
                group = g
    return ProcessGrid(n_data, n_space, rank, backend, rows[rank // n_space], group)


def choose_mesh(batch_size: int, spatial_shard: int, devices: Union[int, Sequence],
                process_count: int, local_device_count: Optional[int] = None
                ) -> Optional[MeshShape]:
    """Pick the training grid from the topology (the JAX package's
    ``engine/train.py:choose_mesh``; ``devices`` a count or a sequence).

    ``spatial_shard`` > 1 reserves a ``space`` axis; the rest of the devices
    form the ``data`` axis. With several processes every process must be in
    the grid (one left out would wait forever at the first collective), so
    there the batch has to divide the data extent exactly. Returns None when
    a single device is the answer."""
    n_devices = devices if isinstance(devices, int) else len(devices)
    n_space = max(1, spatial_shard)
    validate_spatial_shard(n_space, n_devices, local_device_count)
    avail = n_devices // n_space
    if process_count > 1:
        n_data = avail
        if batch_size % n_data:
            raise ValueError(
                f"batch_size {batch_size} must divide evenly over the "
                f"pod's data extent {n_data} ({n_devices} devices / "
                f"{n_space} spatial shards)")
    else:
        n_data = max(d for d in range(1, avail + 1) if batch_size % d == 0)
    if n_data * n_space == 1:
        return None
    return MeshShape(n_data, n_space)


def space_mesh_of(grid: Optional[ProcessGrid]) -> Optional[ProcessGrid]:
    """``grid`` when it has a real (> 1) ``space`` axis, else None: the one
    gate every engine passes to the model as ``space``."""
    if grid is not None and grid.n_space > 1:
        return grid
    return None


def local_batch_rows(grid: ProcessGrid, batch_size: int) -> Optional[slice]:
    """Rows of the global batch this rank trains on: its data index's
    share (the ranks of one space row share it). None when the batch does
    not split over the data axis."""
    if batch_size % grid.n_data:
        return None
    per = batch_size // grid.n_data
    return slice(grid.data_index * per, (grid.data_index + 1) * per)


def shard_batch(batch: Dict[str, torch.Tensor], grid: ProcessGrid) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (a dict of batch-leading
    tensors): its data index's share."""
    n = next(iter(batch.values())).shape[0]
    rows = local_batch_rows(grid, n)
    if rows is None:
        raise ValueError(f"batch {n} does not split over {grid.n_data} data ranks")
    return {k: v[rows] for k, v in batch.items()}
