"""The (data, sample) device mesh over torch.distributed ranks.

Counterpart of ``vpt/dist/mesh.py``. vpt lays its devices out as a
`jax.sharding.Mesh` with two axes and runs one SPMD program over it
(shard_map); here each rank is one process on one device, and the mesh
holds this rank's place in the (data, sample) grid and the process groups
of its row and column:

  "data"   — pixels sharded across ranks (each renders its contiguous
             range of tiles); a sum over the data group replaces vpt's
             psum, an all-gather over it vpt's out_specs=P("data");
  "sample" — samples per pixel sharded across ranks, reduced with an
             all-reduce over the sample group divided by its size (vpt's
             pmean).

Ranks are laid out in rank order as vpt reshapes its device list: rank
r = di * S + si. The collectives ride the process group's backend: NCCL
for CUDA tensors, gloo for CPU tensors. A gloo group given CUDA tensors
(two ranks sharing one card, which NCCL refuses) stages them through the
host. Without a process group the mesh is (1, 1) and its collectives do
nothing; with one, every collective runs, over groups of one rank too.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "SAMPLE_AXIS", "Mesh", "make_mesh", "mesh_shape_for"]

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


def mesh_shape_for(n_devices: int,
                   sample_shards: int | None = None) -> tuple[int, int]:
    """Pick a (data, sample) factorization of n_devices, as vpt does: by
    default the sample axis gets 2 when n_devices is even, else 1 (pixels
    are the abundant axis; the sample axis exercises the cross-shard
    estimator reduction)."""
    if sample_shards is None:
        sample_shards = 2 if n_devices % 2 == 0 else 1
    if n_devices % sample_shards:
        raise ValueError(
            f"n_devices={n_devices} not divisible by sample_shards="
            f"{sample_shards}")
    return n_devices // sample_shards, sample_shards


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the (data, sample) mesh: its coordinates
    (di, si), its device, and the process groups of the ranks that share
    its sample index (data_group: the ranks of its data axis) and its data
    index (sample_group). shape maps each axis name to its size, as vpt's
    Mesh.shape does. The groups are None without a process group."""

    shape: dict
    di: int
    si: int
    device: torch.device
    data_group: object = None
    sample_group: object = None

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_sample(self) -> int:
        return self.shape[SAMPLE_AXIS]

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of t over the ranks of `axis`, in place; returns t."""
        group = self.data_group if axis == DATA_AXIS else self.sample_group
        if group is None:
            return t
        if t.is_cuda and dist.get_backend(group) == "gloo":
            host = t.cpu()
            dist.all_reduce(host, group=group)
            return t.copy_(host)
        dist.all_reduce(t, group=group)
        return t

    def gather_data(self, t: torch.Tensor) -> torch.Tensor:
        """The data axis' shards of t (each rank's the same shape),
        concatenated along dim 0 in data order."""
        if self.data_group is None:
            return t
        src = t.contiguous()
        if src.is_cuda and dist.get_backend(self.data_group) == "gloo":
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.n_data)]
        dist.all_gather(parts, src, group=self.data_group)
        return torch.cat(parts).to(t.device)


def _device_of(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): "
                               "torch.cuda.is_available() is False")
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() if dist.is_initialized()
                                   else 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(sample_shards: int | None = None, device="cuda") -> Mesh:
    """Build this rank's (data, sample) mesh over the world of the default
    process group (world of 1 without one). Every rank must call it, in
    the same order as its other group constructions: it creates one data
    group per sample index and one sample group per data index. device
    "cuda" is cuda:{LOCAL_RANK % device_count} (the rank where LOCAL_RANK
    is unset); "cpu" runs the plain versions."""
    dev = _device_of(device)
    if not dist.is_initialized():
        mesh_shape_for(1, sample_shards)
        return Mesh({DATA_AXIS: 1, SAMPLE_AXIS: 1}, 0, 0, dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    D, S = mesh_shape_for(world, sample_shards)
    data_group = sample_group = None
    for si in range(S):             # the ranks of one sample index
        g = dist.new_group([di * S + si for di in range(D)])
        if rank % S == si:
            data_group = g
    for di in range(D):             # the ranks of one data index
        g = dist.new_group([di * S + si for si in range(S)])
        if rank // S == di:
            sample_group = g
    return Mesh({DATA_AXIS: D, SAMPLE_AXIS: S}, rank // S, rank % S, dev,
                data_group, sample_group)
