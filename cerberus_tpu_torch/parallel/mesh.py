"""The devices a batch is spread over (port of
`cerberus_tpu/parallel/mesh.py`).

The JAX package shards a batch's leading axis over a `jax.sharding.Mesh`.
The port's mesh is a list of torch devices, and `shard_batch` splits the
leading axis into one contiguous chunk per device, each moved to its
device. On one card both are the identity: a one-device list, one chunk.

Multi-process: `init_distributed` starts a `torch.distributed` process
group (nccl between cards, gloo on the CPU), and
`batched.pooled_calibration_step(..., group=)` all-reduces each process's
normal equations over it, the JAX package's `psum` across hosts.
"""

from __future__ import annotations

import torch

from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.ops import factors as fac


def init_distributed(coordinator: str | None = None, num_processes: int = 1,
                     process_id: int = 0, device="cuda"):
    """Join a torch.distributed process group of num_processes processes at
    coordinator ("host:port", as the JAX package's
    jax.distributed.initialize takes it), this one of rank process_id, with
    the nccl backend for device="cuda" (each process on card
    process_id % device_count) or gloo for device="cpu". Returns the
    (default) group. A single process with no coordinator has no group to
    join: a no-op returning None, as in the JAX package; name a coordinator
    to make a one-process group."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if num_processes == 1 and coordinator is None:
        return None
    if coordinator is None:
        raise ValueError("init_distributed: a coordinator address is needed "
                         "for more than one process")
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.group.WORLD


def make_mesh(n_devices: int | None = None, device="cuda"):
    """The devices to spread a batch over: every visible card (or the first
    n_devices), or, with device="cpu", n_devices (default 1) CPU entries,
    whose chunks run one after another."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (n_devices or 1)
    devs = [torch.device(dev.type, i) for i in range(torch.cuda.device_count())]
    return devs[:n_devices] if n_devices is not None else devs


def shard_batch(tree, mesh):
    """Split a batched tree (WindowState / WindowData, nested NamedTuples of
    tensors) along its leading axis into len(mesh) contiguous chunks, chunk
    c on mesh[c]. Returns the list of chunks."""
    n = len(mesh)
    parts = [fac.map_tensors(lambda x, c=c: torch.tensor_split(x, n)[c]
                             .to(mesh[c]), tree) for c in range(n)]
    return parts


def gather_batch(parts, device):
    """shard_batch's inverse: the chunks concatenated on `device`."""
    return fac.map_tensors(lambda *xs: torch.cat([x.to(device) for x in xs]),
                           *parts)
