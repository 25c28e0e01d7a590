"""The shard mesh of the sharded solvers: the port's `jax.sharding.Mesh`.

Port of `orb_slam3_ros2_tpu/parallel/mesh.py`. A JAX mesh names device
axes, `jax.shard_map` runs one body on every device and `lax.psum` sums
across them. Here a `Mesh` records, per axis, how many shards exist
globally and on which `torch.device` each of this process's shards lives.
A per-shard body is a generator over its shard's slices: each `yield`
hands the mesh the shard's partial sums and receives the sums over every
shard of the axis (`run_shards`, the port's `psum`). So a body never reads
another shard's data, and the one program holds in three settings:

* one process, N logical shards (the CPU tests; N shards on one card);
* one process as rank 0 of a `torch.distributed` group of world size 1
  (NCCL on the card: each psum runs the collective, over one rank);
* R processes x M local shards: the 1-D mesh's global shards are
  rank-major, rank r holding shards [r*M, (r+1)*M), and each psum adds the
  local shards and then all-reduces across the group. Under gloo a CUDA
  sum travels through a host copy (NCCL refuses two ranks on one card).

The local shards are summed in shard order on the first local shard's
device, so the sum's order differs from JAX's psum: results agree within
tolerances, not bit for bit.
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

LM_AXIS = "lm"  # landmark-sharding axis (BA Schur reduction rides psum here)
KF_AXIS = "kf"  # keyframe-sharding axis (pose-graph / map-block ops)


def _group_world() -> Tuple[int, int, bool]:
    """(world size, rank, whether a process group is up) of the default
    `torch.distributed` group; (1, 0, False) without one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0, False
    return dist.get_world_size(), dist.get_rank(), True


class Mesh:
    """Shards over named axes. `devices` holds this process's shards'
    devices in the mesh's local shape; over processes, the first axis is
    split rank-major (1-D meshes only)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.world, self.rank, self.collective = _group_world()
        if self.world > 1 and len(self.axis_names) > 1:
            raise ValueError("a mesh over processes has one axis")

    @property
    def shape(self) -> dict:
        """Global shard count per axis (JAX `Mesh.shape`)."""
        local = self.devices.shape
        return {a: n * (self.world if i == 0 else 1)
                for i, (a, n) in enumerate(zip(self.axis_names, local))}

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def local_shards(self) -> range:
        """Global indices of this process's shards along a 1-D mesh."""
        m = self.devices.shape[0]
        return range(self.rank * m, (self.rank + 1) * m)

    def psum(self, parts: Sequence[Sequence[torch.Tensor]],
             devices: Optional[Sequence] = None) -> List[Tuple]:
        """Sum each field over the local shards' `parts` (one tuple of
        tensors per shard, in shard order), all-reduce across the process
        group in one collective, and return the sums, one copy per shard
        on that shard's device (`devices`, default this mesh's)."""
        devices = list(self.devices.reshape(-1) if devices is None
                       else devices)
        home = parts[0][0].device
        sums = []
        for fields in zip(*parts):
            total = fields[0].to(home)
            for f in fields[1:]:
                total = total + f.to(home)
            sums.append(total)
        if self.collective:
            sums = _all_reduce(sums)
        return [tuple(s.to(torch.device(d)) for s in sums) for d in devices]

    def gather(self, parts: Sequence[torch.Tensor], dim: int = 0
               ) -> torch.Tensor:
        """The full array of a sharded output: the local shards
        concatenated along `dim`, then all-gathered across processes in
        rank order (every process returns the same full array)."""
        home = parts[0].device
        local = torch.cat([p.to(home) for p in parts], dim=dim)
        if not self.collective:
            return local
        import torch.distributed as dist

        wire = _collective_copy(local).contiguous()
        out = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(out, wire)
        return torch.cat(out, dim=dim).to(home)


def _collective_copy(t: torch.Tensor) -> torch.Tensor:
    """`t` where the group's backend can reduce it: gloo reduces host
    tensors (a CUDA tensor goes through a host copy), NCCL device ones."""
    import torch.distributed as dist

    backend = dist.get_backend()
    if t.device.type == "cuda" and backend == "gloo":
        return t.cpu()
    if t.device.type != "cuda" and backend == "nccl":
        return t.cuda()
    return t


def _all_reduce(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each tensor over the group's processes with one all-reduce of
    their flattened concatenation."""
    import torch.distributed as dist

    home = tensors[0].device
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    buf = _collective_copy(flat).clone()
    dist.all_reduce(buf)
    buf = buf.to(home)
    out, at = [], 0
    for t in tensors:
        out.append(buf[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def process_allgather(tree: Mapping[str, np.ndarray]) -> dict:
    """Every process's copy of each fixed-shape array, stacked on a new
    leading axis in rank order (JAX `multihost_utils.process_allgather`):
    one `all_gather` per array, no pickling. Without a group of world
    size > 1, each array gains the axis alone."""
    world, _, _ = _group_world()
    out = {}
    for k, a in tree.items():
        a = np.array(a, order="C", copy=None)  # keeps a 0-d array 0-d
        wire = (a.astype(np.uint8) if a.dtype == bool
                else a.view(np.int32) if a.dtype == np.uint32 else a)
        t = torch.from_numpy(wire)
        if world == 1:
            g = t[None].numpy()
        else:
            import torch.distributed as dist

            t = _collective_copy(t)
            bufs = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(bufs, t)
            g = torch.stack(bufs).cpu().numpy()
        out[k] = (g.astype(bool) if a.dtype == bool
                  else g.view(np.uint32) if a.dtype == np.uint32 else g)
    return out


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = (LM_AXIS,),
              devices=None) -> Mesh:
    """1-D (default) or n-D mesh over this process's shards.

    `devices`: one entry per local shard (a device may repeat: N shards on
    one card, or "cpu" N times); default every visible card, and it
    raises without one. `n_devices` takes the first n of them. Under a
    `torch.distributed` group of world size W the 1-D mesh has W x n
    shards. An n-D mesh factors n near-square, as JAX's does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass "
                "devices=[\"cpu\"] * n to shard on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if len(axis_names) == 1:
        shape = (n,)
    else:
        # split n into a near-square factorization for 2-D meshes
        a = int(np.floor(np.sqrt(n)))
        while n % a:
            a -= 1
        shape = (a, n // a)
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


def pad_to_multiple(x: torch.Tensor, axis: int, multiple: int, fill=0):
    """Pad `axis` of x up to a multiple (sharding needs even splits)."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    pad_shape = list(x.shape)
    pad_shape[axis] = target - size
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=axis)


def run_shards(mesh: Mesh, gens: Iterable, devices=None) -> list:
    """Drive one generator per local shard in lockstep (the port's
    `shard_map`): each yields a tuple of partial sums and is sent their
    psum (`Mesh.psum`). Returns each generator's return value; every body
    runs the same number of psums, as an SPMD program does."""
    gens = list(gens)
    parts = [next(g) for g in gens]
    while True:
        sums = mesh.psum(parts, devices)
        done, parts = [], []
        for g, s in zip(gens, sums):
            try:
                parts.append(g.send(s))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if len(done) != len(gens):
                raise RuntimeError("shards ran different numbers of psums")
            return done
