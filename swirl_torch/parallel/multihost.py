"""The process-level runtime of a sharded prove: ``torch.distributed`` and
the meshes of ranks built on it.

Peer of ``swirl/parallel/multihost.py``. There ``jax.distributed`` joins
the hosts and a mesh holds devices; here each rank is one process on one
device (``cuda:LOCAL_RANK``, or the CPU when the caller passes
``device_type="cpu"``), and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of ranks.

- :func:`initialize`: ``init_process_group`` from torchrun's environment
  (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) in place of the
  ``JAX_*`` names; idempotent, and it sets up nothing for one process.
- :func:`proof_mesh`: one axis, ``rows``, over the world with each host's
  ranks next to each other, so that the exchanges between neighbouring
  shards stay inside a host and only the host boundaries cross the
  network. Without a process group it makes a world of one (NCCL on the
  card, gloo on the CPU) on an in-memory store, so the same code path
  serves one process.
- :func:`host_local_mesh` and :func:`hierarchical_mesh` (``("host",
  "chip")``).

Every rank runs the same prove on the same context, so every rank draws
the same Fiat-Shamir challenges: nothing is broadcast from rank 0.
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS = "rows"

# the process group's backend for a mesh's device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (made current), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"multihost: device type {device_type!r} is neither 'cuda' nor 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("multihost: no CUDA device; pass device_type='cpu' to run the ranks on the CPU")
    index = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _init(device_type: str, **kwargs) -> None:
    device = local_device(device_type)
    dist.init_process_group(
        BACKENDS[device_type], device_id=device if device.type == "cuda" else None, **kwargs
    )


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
) -> None:
    """Join the process group (idempotent).

    ``coordinator_address`` (``host:port``) defaults to torchrun's
    ``MASTER_ADDR:MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE`` and
    ``process_id`` to ``RANK``. One process with no coordinator sets up
    nothing (:func:`proof_mesh` then makes a world of one)."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    _init(device_type, init_method=method, world_size=num_processes, rank=process_id)


def _world(device_type: str) -> None:
    """A world of one on an in-memory store when no process group exists."""
    if not dist.is_initialized():
        _init(device_type, store=dist.HashStore(), rank=0, world_size=1)


def _ranks_by_host() -> List[List[int]]:
    """The world's ranks grouped by host name, hosts in the order of their
    first rank."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    hosts: dict = {}
    for rank, name in enumerate(names):
        hosts.setdefault(name, []).append(rank)
    return list(hosts.values())


def proof_mesh(devices: Optional[Sequence[int]] = None, device_type: str = "cuda") -> DeviceMesh:
    """One-axis mesh (``rows``) over the world's ranks (or ``devices``, a
    sequence of ranks), each host's ranks next to each other."""
    _world(device_type)
    chosen = set(range(dist.get_world_size()) if devices is None else devices)
    ordered = [r for host in _ranks_by_host() for r in host if r in chosen]
    return DeviceMesh(device_type, ordered, mesh_dim_names=(AXIS,))


def host_local_mesh(n: Optional[int] = None, device_type: str = "cuda") -> DeviceMesh:
    """``rows`` mesh over this host's ranks (the first ``n`` if given). Every
    rank builds every host's mesh (a group is made by all ranks together)
    and keeps its own host's."""
    _world(device_type)
    mine = None
    for host in _ranks_by_host():
        mesh = DeviceMesh(device_type, host[:n], mesh_dim_names=(AXIS,))
        if dist.get_rank() in host:
            mine = mesh
    return mine


def hierarchical_mesh(devices: Optional[Sequence[int]] = None, device_type: str = "cuda") -> DeviceMesh:
    """Two-axis ``("host", "chip")`` mesh for layouts that want the hosts
    and the ranks inside a host apart (proofs data-parallel over "host",
    each sharded over "chip")."""
    _world(device_type)
    chosen = set(range(dist.get_world_size()) if devices is None else devices)
    rows = [[r for r in host if r in chosen] for host in _ranks_by_host()]
    rows = [row for row in rows if row]
    if any(len(row) != len(rows[0]) for row in rows):
        raise ValueError("hosts expose unequal device counts")
    return DeviceMesh(device_type, rows, mesh_dim_names=("host", "chip"))
