"""Device meshes for doc-range sharding, and the multi-process setup.

PyTorch counterpart of `nextplaid_tpu.parallel.mesh`. next-plaid has no
distributed backend at all (multi-node is more containers over a shared
filesystem); the JAX package shards the corpus by contiguous document
ranges over a 1-D "docs" mesh axis and merges per-shard top-k tiles with
XLA collectives. Here a `Mesh` is the ordered list of this process's shard
devices and, across processes, a `torch.distributed` process group:

  - shard i of the whole mesh is local shard i - rank * local_count of
    process `rank` (process-major, as `jax.devices()` orders a multi-host
    mesh); every process holds the same number of shards;
  - a device may repeat: four shards on one card run a real merge on one
    card, and the tests shard over eight "cpu" shards as the JAX tests do
    over eight virtual CPU devices;
  - two collectives carry everything: `all_gather` of the [S_local, Q, k]
    score and id tiles (`jax.lax.all_gather`) and `sum` (`jax.lax.psum`).
    In one process they are a stack and a sum on the mesh's first device;
    across processes, `dist.all_gather` / `dist.all_reduce` of that local
    result. Only the tiles cross processes, never the corpus.

`init_distributed` reads the JAX package's environment variables and joins
the process group over TCP. Its backend follows one rule: NCCL when every
rank has a card of its own, gloo otherwise (the CPU, or ranks that share a
card: NCCL refuses two ranks on one device). Under gloo the tiles go
through host memory, explicitly: they are kilobytes a query batch.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from nextplaid_tpu_torch.utils.device import DeviceLike, resolve_device

DOC_AXIS = "docs"

# How long a rank waits for the others to join the process group.
JOIN_TIMEOUT = timedelta(seconds=300)


@dataclass(frozen=True)
class Mesh:
    """This process's shard devices, in shard order, and the process group
    that joins it to the other processes' shards (None in one process)."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    world_size: int = 1
    group: Optional[object] = None

    @property
    def local_count(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards of the whole mesh, over every process."""
        return self.local_count * self.world_size

    @property
    def local_shards(self) -> range:
        """The global shard ids this process holds."""
        return range(self.rank * self.local_count, (self.rank + 1) * self.local_count)

    @property
    def host_collectives(self) -> bool:
        """True when the collectives go through host memory (gloo)."""
        return self.group is not None and dist.get_backend(self.group) == "gloo"

    def all_gather(self, tiles: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard's tile, stacked in shard order, [S, ...] on the first
        local device: `tiles` are this process's, one a local shard."""
        head = self.devices[0]
        local = torch.stack([t.to(head) for t in tiles])
        if self.group is None:
            return local
        send = local.cpu() if self.host_collectives else local
        parts = [torch.empty_like(send) for _ in range(self.world_size)]
        dist.all_gather(parts, send, group=self.group)
        return torch.cat(parts).to(head)

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of every shard's part, on the first local device: `parts`
        are this process's, summed in shard order."""
        head = self.devices[0]
        total = parts[0].to(head)
        for p in parts[1:]:
            total = total + p.to(head)
        if self.group is None:
            return total
        send = total.cpu() if self.host_collectives else total.contiguous()
        dist.all_reduce(send, group=self.group)
        return send.to(head)


def _indexed(device: torch.device) -> torch.device:
    """`device` with its card index ("cuda" names the current card), the
    form tensors on it report."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _card_id(device: torch.device) -> str:
    """This host's name and the card's UUID (`device` indexed), or "" for
    the CPU."""
    if device.type != "cuda":
        return ""
    props = torch.cuda.get_device_properties(device.index)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> bool:
    """Join this process to a multi-process mesh.

    Arguments default from the JAX package's environment variables, so
    launchers configure every process alike:
      NEXT_PLAID_COORDINATOR   host:port of process 0's store
      NEXT_PLAID_NUM_PROCESSES world size
      NEXT_PLAID_PROCESS_ID    this process's rank
    `device` is this rank's device ("cuda" when None, raising without a
    card). The ranks publish their cards through the TCP store before the
    group forms: NCCL when every rank has a card of its own, gloo
    otherwise. Returns True once the process group exists, False for the
    single-process default (neither a coordinator nor a world size given).
    Idempotent."""
    coordinator_address = coordinator_address or os.environ.get("NEXT_PLAID_COORDINATOR")
    env_np = os.environ.get("NEXT_PLAID_NUM_PROCESSES")
    env_pid = os.environ.get("NEXT_PLAID_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process mesh needs the coordinator's host:port, the world "
            "size and this process's rank (NEXT_PLAID_COORDINATOR, "
            "NEXT_PLAID_NUM_PROCESSES, NEXT_PLAID_PROCESS_ID)"
        )
    device = _indexed(resolve_device(device))
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(
        host, int(port), num_processes, is_master=process_id == 0, timeout=JOIN_TIMEOUT
    )
    store.set(f"next_plaid/card/{process_id}", _card_id(device))
    cards = [store.get(f"next_plaid/card/{r}").decode() for r in range(num_processes)]
    own_cards = all(cards) and len(set(cards)) == len(cards)
    if own_cards:
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if own_cards else "gloo", store=store, rank=process_id,
        world_size=num_processes, timeout=JOIN_TIMEOUT,
    )
    return True


def make_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence[DeviceLike]] = None
) -> Mesh:
    """A 1-D doc-shard mesh over `devices` (one shard each, repeats allowed),
    by default over every visible card (the first `n_devices` of them),
    raising without one. After `init_distributed` the mesh spans every
    process's shards; every process must give the same number."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = tuple(_indexed(resolve_device(d)) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(devices)
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(devices))
    if len(set(counts)) != 1:
        raise ValueError(f"every process must hold as many shards; got {counts}")
    return Mesh(devices, dist.get_rank(), dist.get_world_size(), dist.group.WORLD)
