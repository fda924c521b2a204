"""Multi-process runtime helpers (counterpart of
``mpc_cbf_tpu/parallel/distributed.py``; absent in the reference).

The scaling recipe: the scenario axis is embarrassingly parallel and
splits across processes, one process a card; a scenario's agents stay on
its card. ``init_distributed`` joins the process group (gloo for CPU
tensors, NCCL for CUDA tensors), ``global_mesh`` lays every process's
device on the scenario axis in rank order, and
``host_scenarios_to_global`` all-gathers each process's scenarios into the
global batch.

Usage on each process:
    init_distributed()                                    # torchrun's env, or
    init_distributed("tcp://host:port", world, rank)      # explicit
    mesh = global_mesh()
    batch = host_scenarios_to_global(mesh, local_init)    # [S_local * world, ...]
    result = sharded_rollout(sim, mesh, batch, goals, steps)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mpc_cbf_torch.parallel.mesh import Mesh, _grid, scenario_sharding
from mpc_cbf_torch.utils.tree import tree_map

_CLUSTER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """torch.distributed.init_process_group with the backend for each tensor
    kind ('cpu:gloo,cuda:nccl' where a card is visible, else gloo).

    coordinator_address: 'tcp://host:port' (or 'host:port'), with
    num_processes and process_id; None reads torchrun's environment
    (env://). A no-op only when the group is already initialized, or when
    no argument and no cluster environment is given. Unlike the JAX
    package, which swallows every RuntimeError and ValueError of
    jax.distributed.initialize, any other error propagates: a process that
    silently runs alone computes a different result.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if not all(k in os.environ for k in _CLUSTER_ENV):
            return
        kw = dict(init_method="env://")
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed: an address needs num_processes and process_id")
        if "://" not in coordinator_address:
            coordinator_address = "tcp://" + coordinator_address
        kw = dict(init_method=coordinator_address, world_size=num_processes, rank=process_id)
        local = process_id
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "cpu:gloo,cuda:nccl"
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, **kw)


def _world() -> tuple:
    """(world size, rank); (1, 0) outside a process group."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _local_device() -> torch.device:
    """The device this process drives: its current card, else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(agent: int = 1) -> Mesh:
    """Mesh over every process's device, rank-major on the scenario axis
    (each process's device on a row of its own when agent = 1)."""
    world, _ = _world()
    if world % agent:
        raise ValueError(f"{world} devices not divisible by agent={agent}")
    # every process drives one device of the same kind; the entries of
    # other processes name their device as seen from that process
    devices = [_local_device()] * world
    return Mesh(_grid(devices, world // agent, agent),
                np.arange(world).reshape(world // agent, agent))


def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """Every process's x (same shape everywhere) concatenated on axis 0 in
    rank order; x itself outside a process group."""
    world, _ = _world()
    if world == 1:
        return x
    src = x.contiguous()
    if src.dtype == torch.bool:              # not every backend gathers bool
        return all_gather_cat(src.to(torch.uint8)).bool()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src)
    return torch.cat(parts)


def host_scenarios_to_global(mesh: Mesh, local_batch):
    """Assemble each process's scenario batch into the global batch (the
    multi-host data-loading pattern): a tree of [S_local, ...] tensors, the
    same S_local on every process, becomes the tree of [S_local * world,
    ...] tensors in rank order, on each process's own device. The global
    scenario count must split over the mesh's scenario axis."""
    def to_global(x):
        g = all_gather_cat(x)
        scenario_sharding(mesh).shards(g.shape)          # raises if S does not split
        return g

    return tree_map(to_global, local_batch)
