"""Mesh builders of the port (the counterpart of ``repro/launch/mesh.py``).

Functions (never module-level constants), so importing this module touches
no process group.  ``make_production_mesh`` is the JAX package's 256 / 512
chip layout and refuses with the count when the world is smaller;
``make_host_mesh`` joins the ranks this process was started with.  Under
``torchrun`` (``python -m torch.distributed.run``) the environment holds
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and the
rendezvous address; a plain ``python`` start is world 1.
"""
from __future__ import annotations

import math
import os
from typing import Tuple

import torch

from repro_torch.nn.sharding import GROUP_TIMEOUT as TIMEOUT
from repro_torch.nn.sharding import Mesh, choose_backend


def world_from_env() -> Tuple[int, int, int, int]:
    """(rank, world, local rank, local world) from torchrun's environment."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    return rank, world, local, local_world


def init_distributed(device: torch.device, *, rank: int, world: int, local_world: int) -> str:
    """Join the default process group (once; the rendezvous from torchrun's
    environment) and return its backend: NCCL when every local rank has a
    card of its own, gloo otherwise (``nn.sharding.choose_backend``).
    Printed by rank 0."""
    import torch.distributed as dist

    backend = choose_backend(device, local_world)
    if not dist.is_initialized():
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, rank=rank, world_size=world, timeout=TIMEOUT, **kw)
    if rank == 0:
        print(f"process group: backend {dist.get_backend()}, {world} ranks "
              f"({local_world} on this host, device {device.type})", flush=True)
    return dist.get_backend()


def close_distributed() -> None:
    """Leave the default process group (after a barrier), so that no rank
    exits while a peer still talks to it and no communicator outlives the
    interpreter (a live gloo group can abort the process at exit)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def host_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given ('cpu'), else the card
    ``LOCAL_RANK`` names when there are enough cards, else card 0 (ranks
    sharing one card)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    _, _, local, local_world = world_from_env()
    idx = local if torch.cuda.device_count() >= local_world else 0
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def make_host_mesh(shape: Tuple[int, int] = (0, 1), device=None) -> Mesh:
    """A (data, model) mesh over the ranks this process was started with
    (torchrun's environment; world 1 otherwise).  ``shape`` (0, m) sizes
    the data axis to the world.  Joins the default group when world > 1."""
    rank, world, _, local_world = world_from_env()
    d, m = shape
    d = d or world // m
    if d * m != world:
        raise ValueError(f"mesh {d}x{m} needs {d * m} ranks, WORLD_SIZE is {world}")
    if world > 1:
        init_distributed(host_device(device), rank=rank, world=world, local_world=local_world)
    return Mesh((d, m), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    _, world, _, _ = world_from_env()
    if world < need:
        raise RuntimeError(f"mesh {shape} needs {need} devices, have {world} — "
                           "start that many ranks under torchrun")
    return Mesh(shape, axes)
