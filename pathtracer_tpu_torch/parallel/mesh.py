"""Device mesh and process-group bring-up (``parallel/mesh.py``).

Two logical axes, as in the reference:

- ``rays``: the flattened framebuffer is split across the axis;
- ``spp``: the samples of the same pixels are split across the axis and
  summed.

A :class:`Mesh` is a (rays, spp) grid of device slots. In one process a
device may fill several slots (a mesh of ``[cpu] * 8`` or ``[cuda:0] *
2`` runs every slot in turn), which is how a machine with one device
reaches every code path. With a process group up, the grid is global:
each rank brings the same number of local slots, ranks in order, and runs
its own.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

RAYS_AXIS = "rays"
SPP_AXIS = "spp"


def group_up() -> bool:
    """True while a process group is up: the sharded paths then reduce
    across ranks (one rank included)."""
    return dist.is_available() and dist.is_initialized()


def _world():
    """(world size, rank) of the process group, (1, 0) without one."""
    if group_up():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> None:
    """Bring up the process group: NCCL for ranks on ``cuda`` (each rank on
    card ``process_id`` modulo the cards it sees), gloo on the CPU; no
    fallback from one to the other.

    ``coordinator_address`` is ``host:port`` or ``tcp://host:port``. A
    no-op for one process unless an address is given (a launcher that
    names one gets a group of that size, one rank included), and safe to
    call twice: a group already up with ``num_processes`` ranks is kept,
    one of another size raises."""
    if num_processes is None or (num_processes <= 1
                                 and coordinator_address is None):
        return
    if dist.is_initialized():
        if dist.get_world_size() == num_processes:
            return
        raise RuntimeError(f"a process group of {dist.get_world_size()} "
                           f"ranks is up, not {num_processes}")
    if coordinator_address is None or process_id is None:
        raise ValueError("a process group needs the coordinator's address "
                         "and this process's id")
    address = coordinator_address
    if "://" not in address:
        address = "tcp://" + address
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for an NCCL process group")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id)


class Mesh:
    """A (rays, spp) grid of device slots. ``devices[r][s]`` is the device
    of slot (r, s) where this process runs it, else None; ``owners[r][s]``
    is the rank that runs it."""

    def __init__(self, devices: List[list], owners: List[list]):
        self.devices = devices
        self.owners = owners

    @property
    def shape(self) -> dict:
        return {RAYS_AXIS: len(self.devices), SPP_AXIS: len(self.devices[0])}

    def local_slots(self):
        """[(r, s, device)] of the slots this process runs, row-major."""
        _, rank = _world()
        return [(r, s, dev)
                for r, row in enumerate(self.devices)
                for s, dev in enumerate(row) if self.owners[r][s] == rank]


def make_mesh(devices: Optional[Sequence] = None,
              spp_axis_size: int = 1) -> Mesh:
    """The (rays, spp) mesh over ``devices`` (default: every CUDA device of
    this process; without one it raises). ``spp_axis_size`` slots share
    the samples of the same pixels; the rest split the pixels.

    With a process group up, ``devices`` are this rank's slots and every
    rank passes as many: the mesh spans world size times that many slots,
    rank 0's first."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a mesh: pass devices "
                               "(e.g. ['cpu'] * 8) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in devices]
    world, rank = _world()
    n = len(local) * world
    if spp_axis_size < 1 or n == 0 or n % spp_axis_size != 0:
        raise ValueError(f"{n} devices not divisible by spp_axis_size="
                         f"{spp_axis_size}")
    slots = [(k // len(local), local[k % len(local)]) for k in range(n)]
    grid = [slots[r * spp_axis_size:(r + 1) * spp_axis_size]
            for r in range(n // spp_axis_size)]
    return Mesh([[dev if owner == rank else None for owner, dev in row]
                 for row in grid],
                [[owner for owner, _ in row] for row in grid])
