"""The port's device mesh: a 1-D row of shards over local devices, and
across processes when ``runtime.init_distributed`` has joined them.

Counterpart of ``deltapq_tpu/parallel/mesh.py``.  JAX's ``Mesh`` is
single-controller: one process addresses all its local devices, and
``jax.distributed`` joins processes.  The port keeps that model.  A
``Mesh`` lists this process's shards in shard order as
``torch.device``s; a device may repeat, which lets one card hold 2 or 4
shards (the shards of one card run one after the other).  With a
``torch.distributed`` group the shard count is local shards x world
size, and global shard ``g = rank * local + i`` owns rows
``[g * per, (g + 1) * per)``.

Every process passes the whole array and keeps its own slice
(``shard_rows``).  ``all_gather`` is the port's ``lax.all_gather`` and
``psum``: it moves each local shard's result to ``devices[0]`` and stacks
them, then, with a group, gathers the stacks of every process, so each
process holds the merged result, as JAX's replicated ``out_specs`` give.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device


@dataclass(frozen=True)
class Mesh:
    """This process's shards (``devices``, in shard order, repeats
    allowed), the axis name, and the ``torch.distributed`` group that
    joins processes (None: this process is the whole mesh)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("shard",)
    group: Optional[object] = None
    rank: int = 0
    world: int = 1

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shard count over every process."""
        return self.n_local * self.world

    def shard_ids(self) -> List[int]:
        """Global shard index of each local shard."""
        return [self.rank * self.n_local + i for i in range(self.n_local)]


def _local_devices(device) -> List[torch.device]:
    """The devices of this process that a mesh over ``device`` may use:
    the one named if it carries an index, else every card (``cuda``) or
    the CPU.  Without a card the list is ``cuda:0`` all the same, so the
    first tensor placed there raises."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    return ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            or [torch.device("cuda", 0)])


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "shard",
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """1-D mesh over this process's devices: ``devices`` as given, else
    the local devices of ``device``'s type (None: the cards).
    ``num_devices=n`` places n local shards round-robin over them (on one
    card, n shards of ``cuda:0``; the JAX function takes the first n
    devices instead).  If ``torch.distributed`` is initialized the mesh
    spans every process of the default group."""
    local = ([torch.device(d) for d in devices] if devices is not None
             else _local_devices(device))
    if num_devices is not None:
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        local = [local[i % len(local)] for i in range(num_devices)]
    if dist.is_available() and dist.is_initialized():
        return Mesh(tuple(local), (axis_name,), dist.group.WORLD,
                    dist.get_rank(), dist.get_world_size())
    return Mesh(tuple(local), (axis_name,))


def check_axis(mesh: Mesh, axis: str) -> None:
    """Raise ValueError unless ``axis`` names the mesh's axis, as JAX's
    ``shard_map`` refuses an axis its mesh lacks."""
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh's axis is {mesh.axis_names[0]!r}, "
                         f"not {axis!r}")


def _to_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:        # torch takes only writable arrays
        a = a.copy()
    return torch.from_numpy(a)


def shard_rows(mesh: Mesh, x, dim: int = 0) -> List[torch.Tensor]:
    """This process's shards of ``x`` (a NumPy array or a tensor) split
    along ``dim``, each on its shard's device: the port's
    ``device_put(x, NamedSharding(mesh, P(axis)))``.  ``x.shape[dim]``
    must divide by the shard count."""
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} shards; "
                         f"pad them (pad_to_shards)")
    per = n // mesh.size
    t = _to_tensor(x)
    return [t.narrow(dim, g * per, per).contiguous().to(d)
            for g, d in zip(mesh.shard_ids(), mesh.devices)]


def replicated(mesh: Mesh, x) -> List[torch.Tensor]:
    """``x`` on every local shard's device (one copy a device)."""
    t = _to_tensor(x)
    copies = {d: t.to(d) for d in dict.fromkeys(mesh.devices)}
    return [copies[d] for d in mesh.devices]


def pad_to_shards(x: np.ndarray, n_shards: int, fill=0) -> np.ndarray:
    """Pad axis 0 so it divides evenly across shards."""
    n = x.shape[0]
    pad = (-n) % n_shards
    if pad:
        padding = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        x = np.pad(x, padding, constant_values=fill)
    return x


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """[S, ...]: each local shard's ``parts[i]`` (one shape) in global
    shard order, on ``devices[0]`` of every process.  Across processes it
    is ``torch.distributed.all_gather`` in its list form (gloo takes CPU
    tensors, NCCL CUDA ones)."""
    out = torch.stack([p.to(mesh.devices[0]) for p in parts])
    if mesh.group is None:
        return out
    is_bool = out.dtype == torch.bool
    if is_bool:
        out = out.to(torch.uint8)
    bufs = [torch.empty_like(out) for _ in range(mesh.world)]
    dist.all_gather(bufs, out, group=mesh.group)
    out = torch.cat(bufs)
    return out.to(torch.bool) if is_bool else out


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over every shard (``lax.psum``): the gathered parts added in
    shard order, so every process computes the same value."""
    return all_gather(mesh, parts).sum(dim=0)


def gather_topk(mesh: Mesh, dists: Sequence[torch.Tensor],
                ids: Sequence[torch.Tensor], top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge each shard's (dists [B, k], global ids [B, k]) into the
    top_k smallest over all shards, ascending; among equal distances the
    candidate of the lower shard and rank comes first, as ``lax.top_k``
    keeps the lower index."""
    all_d, all_i = all_gather(mesh, dists), all_gather(mesh, ids)
    S, B, k = all_d.shape
    cat_d = all_d.permute(1, 0, 2).reshape(B, S * k)
    cat_i = all_i.permute(1, 0, 2).reshape(B, S * k)
    srt, pos = torch.sort(cat_d, dim=1, stable=True)
    return srt[:, :top_k], torch.gather(cat_i, 1, pos[:, :top_k])
