"""The device mesh of the sharded solvers, and multi-process start-up.

Port of ``orb_slam2_ros2_tpu/parallel/mesh.py``.  The JAX package shards the
global BA's landmark blocks and the essential graph's edges over a 1-D
``jax.sharding.Mesh`` and joins the shards with ``psum`` / ``all_gather``
inside ``shard_map``; across hosts ``jax.distributed.initialize`` makes the
mesh span every process.  Here the mesh is explicit: an ordered list of shard
slots ``(rank, device)``, of which this process runs its own.  A sharded
solver loops over its local shards, each on its slot's device, and joins
them through the mesh's collectives; the replicated work (the CG on the
reduced system, the line-search decisions) runs once, on the mesh's first
local device (``Mesh.device``), and ``Mesh.broadcast`` hands its results to
the shards.

The collectives add the shards in slot order, always from the lowest slot,
so a run repeats exactly; with more than one process they then call
``torch.distributed.all_reduce``.  ``all_gather`` across processes is an
``all_reduce`` of a zero-filled buffer into which each process writes its
own slots: gloo supports only ``all_reduce`` and ``broadcast`` for CUDA
tensors.  Nothing here uses a float ``index_add_`` (whose order is not fixed
on CUDA).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, backend: Optional[str] = None) -> int:
    """Join this process to a multi-process run so that ``ba_mesh`` spans
    every process's devices; returns this process's rank.

    The arguments default to ``SLAM_COORDINATOR`` (``host:port`` of rank 0),
    ``SLAM_NUM_PROCESSES`` and ``SLAM_PROCESS_ID``.  Without a coordinator
    and a process count, from the arguments or the environment, nothing is
    initialized and 0 is returned: a single-process run pays nothing.  The
    backend is NCCL with a card and gloo without; ``backend="gloo"`` lets
    two ranks share one card (NCCL refuses two ranks on one GPU)."""
    coordinator = coordinator or os.environ.get("SLAM_COORDINATOR")
    num_processes = num_processes or _env_int("SLAM_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("SLAM_PROCESS_ID")
    if coordinator is None and num_processes is None:
        return 0
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator, the process count and this "
                         "process's id (SLAM_COORDINATOR, SLAM_NUM_PROCESSES, SLAM_PROCESS_ID)")
    if dist.is_initialized():
        return dist.get_rank()
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def _world() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """This process's devices: ``devices`` when given, else every visible
    CUDA device.  Without a card and without ``devices`` it raises: a run
    on the CPU names its slots (``devices=["cpu", ...]``)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; to run on the CPU pass its slots, "
                           "devices=[\"cpu\", ...]")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_devices(device, n: int) -> List[torch.device]:
    """The devices a SLAM on ``device`` spreads over when its caller names
    none: every visible CUDA device for a CUDA ``device``; for a CPU
    ``device``, CPU slots enough for this process's share of ``n`` slots (a
    card on the machine is not used unless asked for)."""
    device = torch.device(device)
    if device.type == "cuda":
        return local_devices()
    _, world = _world()
    return [device] * max(1, -(-n // world))


def _global_slots(devices: Optional[Sequence] = None) -> List[Tuple[int, torch.device]]:
    """Every process's local devices, in rank order."""
    rank, world = _world()
    mine = [str(d) for d in local_devices(devices)]
    if world == 1:
        return [(0, torch.device(d)) for d in mine]
    every: list = [None] * world
    dist.all_gather_object(every, mine)
    return [(r, torch.device(d)) for r, devs in enumerate(every) for d in devs]


def device_count(devices: Optional[Sequence] = None) -> int:
    """Devices over every process."""
    return len(_global_slots(devices))


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``slots`` [(rank, device)] in mesh order, this process's
    ``rank`` and the axis name."""

    axis: str
    slots: Tuple[Tuple[int, torch.device], ...]
    rank: int = 0

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def local(self) -> List[int]:
        """This process's slot indices, in mesh order."""
        return [k for k, (r, _) in enumerate(self.slots) if r == self.rank]

    @property
    def local_devices(self) -> List[torch.device]:
        return [self.slots[k][1] for k in self.local]

    @property
    def device(self) -> torch.device:
        """The first local device: where the replicated work runs."""
        return self.local_devices[0]

    @property
    def multi_process(self) -> bool:
        return len({r for r, _ in self.slots}) > 1

    @property
    def capturable(self) -> bool:
        """Whether a sharded program over this mesh can be captured as one
        CUDA graph (on a CUDA device; elsewhere the same wrappers run
        eagerly).  Decided by the layout alone:

        * one process whose local slots all sit on one device: yes.  Then
          ``broadcast`` and ``split`` hand out the tensor or views of it,
          ``psum`` is a chain of adds and ``all_gather`` a ``torch.cat``,
          all work on that device's stream;
        * several processes: no.  ``psum`` and ``all_gather`` call
          ``torch.distributed.all_reduce``; gloo's collectives cannot be
          captured, and NCCL's, which can, refuse two ranks on one GPU;
        * one process over several GPUs: no.  A capture records one
          device's stream, so the shards' kernels on the other devices
          would run during the capture instead of being recorded.

        The unsharded parts of the sharded solvers (the essential graph's
        problem and commit, the GBA commit) run on one device under any
        mesh and are captured whatever this says."""
        return not self.multi_process and len(set(self.local_devices)) == 1

    def broadcast(self, x):
        """A replicated tensor on every local shard's device (the same
        tensor where the device is the same)."""
        return [x.to(d) for d in self.local_devices]

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum over every shard of the mesh, on ``device``: the local
        shards added in slot order from the lowest, then, across processes,
        ``all_reduce``."""
        dev = self.device
        acc = xs[0].to(dev)
        for x in xs[1:]:
            acc = acc + x.to(dev)
        if self.multi_process:
            if acc is xs[0]:
                acc = acc.clone()
            dist.all_reduce(acc)
        return acc

    def all_gather(self, xs: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
        """The shards' equal-sized pieces concatenated along ``dim`` in slot
        order, on ``device``."""
        dev = self.device
        if not self.multi_process:
            return torch.cat([x.to(dev) for x in xs], dim=dim) if len(xs) > 1 else xs[0].to(dev)
        piece = xs[0].shape[dim]
        shape = list(xs[0].shape)
        shape[dim] = piece * self.size
        dtype = torch.int32 if xs[0].dtype == torch.bool else xs[0].dtype
        buf = torch.zeros(shape, dtype=dtype, device=dev)
        for k, x in zip(self.local, xs):
            buf.narrow(dim, k * piece, piece).copy_(x)
        dist.all_reduce(buf)
        return buf.bool() if xs[0].dtype == torch.bool else buf

    def split(self, x: torch.Tensor, dim: int = -1) -> List[torch.Tensor]:
        """This process's shards of ``x`` (its size along ``dim`` a multiple
        of the mesh size), each on its slot's device."""
        piece = x.shape[dim] // self.size
        return [x.narrow(dim, k * piece, piece).to(self.slots[k][1]) for k in self.local]


def ba_mesh(n_devices: Optional[int] = None, axis: str = "ba",
            devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """A 1-D mesh over the first ``n_devices`` slots of every process's
    devices (``devices`` replaces this process's list, as the virtual
    devices of the JAX tests do); None for one device, where the solvers
    take their unsharded paths.  Fewer slots than asked make a smaller
    mesh, as JAX's ``devs[:n]``.  Without a card ``devices`` is required
    (``local_devices``)."""
    slots = _global_slots(devices)
    n = n_devices or len(slots)
    if n <= 1:
        return None
    rank, world = _world()
    owners = {r for r, _ in slots[:n]}
    if len(owners) > 1 and owners != set(range(world)):
        # the collectives reduce over the whole process group
        raise ValueError(f"a mesh over several processes must hold a slot of every one: {slots[:n]}")
    return Mesh(axis=axis, slots=tuple(slots[:n]), rank=rank)


def pad_points_for_mesh(n_points: int, n_devices: int) -> int:
    """The landmark count padded up to a multiple of the mesh size."""
    per = -(-n_points // n_devices)
    return per * n_devices
