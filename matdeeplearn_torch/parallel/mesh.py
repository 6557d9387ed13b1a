"""The (dp, ep) process mesh over torch.distributed.

The reference package lays a device mesh with axes dp and ep over
every visible device and drives it from one process (parallel/mesh.py).
The port runs one process a card, the torch idiom: each process is one
(dp, ep) member, rank = d·ep + e (ep innermost, as the reference's mesh
reshapes its device list), and holds

  * dp: data parallelism over graphs. Each replica assembles its own row
    of the (dp, B) id matrix and runs the single-card step on it;
  * ep: edge parallelism. The members of one replica's ep group each take
    a contiguous 1/ep of that batch's padded edge slots, and their
    partial node sums are combined (parallel/ring.py).

`maybe_initialize_distributed` joins the world torchrun describes (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL when every rank on
the host has a card of its own, gloo on the CPU, or on CUDA tensors when
ranks share a card (NCCL refuses two ranks on one card). A failed
rendezvous raises; the reference package falls back to a single host
there, which would hide the run's real layout. Every collective of the
port is an all_reduce, which gloo supports on CUDA tensors too, so one
code path serves gloo on the CPU, gloo on a card and NCCL across cards.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

EP_IMPLS = ("ring", "gspmd")


def maybe_initialize_distributed(device: str | torch.device = "cuda",
                                 timeout_s: float = 600.0,
                                 verbose: bool = True) -> bool:
    """Join the world of torchrun's environment. False (and nothing done)
    without WORLD_SIZE in the environment; True once this process is in a
    process group (or already was). `device` picks the backend: NCCL for
    "cuda" when the host has a card for each of its ranks
    (LOCAL_WORLD_SIZE), else gloo. A rendezvous that fails or does not
    complete within `timeout_s` raises RuntimeError."""
    env = os.environ
    if "WORLD_SIZE" not in env:
        return False
    if dist.is_initialized():
        return True
    missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {', '.join(missing)} is "
                           "not: torchrun sets all of RANK, WORLD_SIZE, "
                           "LOCAL_RANK, MASTER_ADDR and MASTER_PORT")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", rank))
    addr, port = env["MASTER_ADDR"], env["MASTER_PORT"]
    backend = "gloo"
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device 'cuda' requested but no card is visible")
        torch.cuda.set_device(local % cards)
        ranks_here = int(env.get("LOCAL_WORLD_SIZE", world))
        if ranks_here <= cards:
            backend = "nccl"
        elif verbose:
            print(f"{ranks_here} ranks share {cards} card(s): NCCL refuses two "
                  "ranks on one card; gloo on CUDA tensors (eager steps)")
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    except (RuntimeError, OSError) as e:  # DistError is a RuntimeError
        raise RuntimeError(f"rendezvous at {addr}:{port} failed for rank "
                           f"{rank} of {world} ({backend}): {e}") from e
    if verbose:
        print(f"torch.distributed initialized: rank {rank}/{world}, {backend}")
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's place in the (dp, ep) mesh and its groups.

    world_group, dp_group and ep_group are None without a process group (a
    mesh of one process, whose steps then run no collective); ep_group is
    also None at ep 1, where no batch is sharded. ep_impl: "ring" sums
    partial node rows across the ep group, "gspmd" gathers the edge-sized
    operand and reduces it locally (parallel/ring.py); the Run sets it
    from the model's `ep_impl` (with_impl)."""

    dp: int
    ep: int
    rank: int
    device: torch.device
    world_group: object = None
    dp_group: object = None
    ep_group: object = None
    backend: str | None = None
    ep_impl: str = "ring"

    @property
    def world(self) -> int:
        return self.dp * self.ep

    @property
    def dp_rank(self) -> int:
        return self.rank // self.ep

    @property
    def ep_rank(self) -> int:
        return self.rank % self.ep

    @property
    def is_main(self) -> bool:
        """Rank 0: the process that writes checkpoints and CSVs."""
        return self.rank == 0

    @property
    def captures(self) -> bool:
        """Whether CUDA graphs may capture its collectives: not gloo's."""
        return self.backend != "gloo"

    def with_impl(self, ep_impl: str) -> "Mesh":
        impl = str(ep_impl).lower()
        if impl not in EP_IMPLS:
            raise ValueError(f"unknown ep_impl {ep_impl!r}: expected ring or "
                             "gspmd")
        return dataclasses.replace(self, ep_impl=impl)


def make_mesh(dp: int | None = None, ep: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """The (dp, ep) mesh over this process's world (one process without a
    process group). dp None takes world / ep. ep must divide the world and
    dp·ep equal it (ValueError). Makes the dp and ep groups (every rank
    calls new_group for every group, in one order) and, under NCCL, runs
    one all_reduce on each group this rank is in, so their communicators
    exist before a CUDA graph captures a collective. device: the rank's
    card (cuda:LOCAL_RANK, set by maybe_initialize_distributed) or the
    CPU."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    ep = int(ep)
    if ep < 1 or world % ep:
        raise ValueError(f"--ep={ep} does not divide the world of {world} "
                         "process(es)")
    dp = world // ep if dp is None else int(dp)
    if dp * ep != world:
        raise ValueError(f"dp={dp} x ep={ep} != the world of {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    if not dist.is_initialized():
        return Mesh(dp, ep, rank, device)
    dp_groups = [dist.new_group([d * ep + e for d in range(dp)])
                 for e in range(ep)]
    ep_groups = [dist.new_group([d * ep + e for e in range(ep)])
                 for d in range(dp)]
    mesh = Mesh(dp, ep, rank, device, world_group=dist.group.WORLD,
                dp_group=dp_groups[rank % ep],
                ep_group=ep_groups[rank // ep] if ep > 1 else None,
                backend=dist.get_backend())
    if mesh.backend == "nccl":
        for group in (mesh.world_group, mesh.dp_group, mesh.ep_group):
            if group is not None:
                dist.all_reduce(torch.zeros(1, device=device), group=group)
        torch.cuda.synchronize(device)
    return mesh
