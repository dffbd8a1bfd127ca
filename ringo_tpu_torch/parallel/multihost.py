"""Process-group plumbing: ``torch.distributed`` start-up, rank 0's bytes
to every rank, and a barrier.

1. **Start-up**: every process calls :func:`init_multihost` before it
   builds a mesh.  One process per device: NCCL for the card, gloo for
   ``device="cpu"``.
2. **One transcript**: Fiat-Shamir is sequential host work, and every rank
   runs it from the same bytes (the sharded programs leave their results
   on every rank).  Where a rank's bytes could differ (fresh randomness),
   rank 0's are broadcast with :func:`bcast_bytes`.

A single process makes a process group of world size 1, so the same
collectives run there too.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .. import backend


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device=None) -> int:
    """Start the default process group and return this process's rank.

    The arguments, or the torchrun variables ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` (``env://``), name the
    rendezvous: ``coordinator_address`` is ``host:port`` (TCP) or a
    ``file://``, ``tcp://`` or ``env://`` URL.  One process with no address gets a world of one over
    an in-memory store.  ``device=None`` means the card (NCCL; raises
    without CUDA), ``"cpu"`` gloo.  Once started, it returns the rank."""
    device = backend.resolve_device(device)
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = "env://"    # torchrun's store and variables
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    name = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    kw = dict(backend=name, rank=process_id, world_size=num_processes,
              timeout=datetime.timedelta(minutes=10))
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError(f"{num_processes} processes need a "
                             "coordinator address")
        dist.init_process_group(store=dist.HashStore(), **kw)
    else:
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(init_method=url, **kw)
    return dist.get_rank()


def rank() -> int:
    """This process's rank in the default process group."""
    return dist.get_rank()


def bcast_bytes(data: bytes | None, length: int) -> bytes:
    """``length`` bytes from rank 0 to every rank (a seed, a challenge).
    Rank 0 passes them; the others pass None (ignored).  The bytes travel
    through the card under NCCL and through the CPU under gloo."""
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    buf = torch.zeros(length, dtype=torch.uint8)
    if dist.get_rank() == 0:
        if data is None or len(data) != length:
            raise ValueError("rank 0 must supply `length` bytes")
        buf[:] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    buf = buf.to(device)
    dist.broadcast(buf, src=0)
    return bytes(buf.cpu().numpy())


def sync_global_devices(tag: str = "ringo") -> None:
    """Barrier across every rank (``tag`` names it in a trace)."""
    from ..utils import profiling

    with profiling.span(f"parallel.barrier.{tag}"):
        dist.barrier()
