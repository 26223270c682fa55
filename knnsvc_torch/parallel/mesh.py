"""Device meshes of the port (counterpart of knnsvc_tpu/parallel/mesh.py).

The JAX package is single-controller: its Mesh('data', 'pool') is a grid of
devices owned by one process, and shard_map runs one body per device. The
port keeps that model. A `Mesh` is an (n_data, n_pool) grid of
torch.devices owned by this process, and the sharded matchers
(parallel/sharded_match.py) run each pool shard's work on its device from
here:

  'data'  the batch of the bulk loops' batched match: B / n_data
          utterances per grid row
  'pool'  the kNN matching pool (hours of target audio, 1e5-1e6 frames)
          split into n_pool shards of P / n_pool rows; each shard's device
          searches its rows, and only candidate rows cross between devices

A device may repeat in the grid: [cuda:0] * 4 is four logical shards on one
card, which is how one H100 runs the multi-shard code, and [cpu] * 8 stands
in for the JAX tests' eight virtual CPU devices. Shards on other CUDA
devices are read by the concat-cost kernel through peer access
(ops/concat_scan.py).

`data_sharding(mesh)` splits a batch over the grid rows and
`replicated(mesh)` copies a tensor to each, the roles of the JAX package's
NamedShardings in its data-parallel train step (train/trainer.py);
`pool_sharding(mesh)` splits a pool's frames over the 'pool' axis of every
grid row, as NamedSharding(mesh, P('pool')) does.
`initialize_distributed` brings up torch.distributed over TCP (NCCL on
cards, gloo on the CPU); the train step then averages its gradients over
the processes, each of which owns its own Mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


class Mesh:
    """An (n_data, n_pool) grid of torch.devices. Compared by identity: the
    pool caches (match/pipeline.py) key on the mesh object."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = tuple(tuple(row) for row in devices)
        if not self.devices or not self.devices[0] or any(
                len(row) != len(self.devices[0]) for row in self.devices):
            raise ValueError("a Mesh is a non-empty rectangular grid of devices")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "pool": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """The device of grid position (0, 0): the merges, the serial stages
        and every result of the single-utterance cores live there."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.devices]})"


def _normalized(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_data: int | None = None, n_pool: int = 1, devices=None) -> Mesh:
    """Mesh over (data, pool), row-major over `devices`. Defaults to every
    visible CUDA device on the data axis; without a card the caller passes
    the devices (e.g. [torch.device('cpu')] * 8)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch sees no CUDA device; pass devices= "
                               "(e.g. [torch.device('cpu')] * 8) to build a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_normalized(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_pool
    if n_data < 1 or n_pool < 1 or n_data * n_pool > len(devices):
        raise ValueError(f"a ({n_data}, {n_pool}) mesh needs {n_data * n_pool} devices, "
                         f"got {len(devices)}")
    return Mesh([devices[r * n_pool:(r + 1) * n_pool] for r in range(n_data)])


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor goes on a mesh: split on its leading axis over the grid
    rows (axis 'data', a batch) or over the positions of each row (axis
    'pool', a pool's frames), or copied whole to each row (axis None). A
    'data' or None part lands on its row's first device."""

    mesh: Mesh
    axis: str | None

    def __post_init__(self):
        if self.axis not in ("data", "pool", None):
            raise ValueError(f"a Sharding's axis is 'data', 'pool' or None, not {self.axis!r}")

    @property
    def devices(self) -> list[torch.device]:
        """The device of each part: each row's first ('data', None), or every
        grid position row by row ('pool')."""
        if self.axis == "pool":
            return [d for row in self.mesh.devices for d in row]
        return [row[0] for row in self.mesh.devices]

    def put(self, x: torch.Tensor) -> list[torch.Tensor]:
        """-> one tensor per device of `devices`: B / n_data rows of x each
        ('data'); x itself (None); or, at grid position (d, p), the p-th of
        n_pool equal blocks of x's rows ('pool', the blocks of `shard_rows`
        for a pool that n_pool divides)."""
        devices = self.devices
        if self.axis is None:
            return [x.to(d) for d in devices]
        n = self.mesh.shape[self.axis]
        if x.shape[0] % n:
            raise ValueError(f"a leading axis of {x.shape[0]} does not split over a {self.axis} "
                             f"axis of {n}")
        parts = x.chunk(n)
        if self.axis == "pool":
            parts = parts * self.mesh.shape["data"]
        return [part.to(d) for part, d in zip(parts, devices)]


def data_sharding(mesh: Mesh) -> Sharding:
    """The batch (leading) axis split over the mesh's 'data' axis."""
    return Sharding(mesh, "data")


def replicated(mesh: Mesh) -> Sharding:
    """A whole copy on each grid row."""
    return Sharding(mesh, None)


def pool_sharding(mesh: Mesh) -> Sharding:
    """The leading (frame) axis split over the mesh's 'pool' axis, the same
    blocks on every grid row."""
    return Sharding(mesh, "pool")


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None,
                           device: str | torch.device = "cuda") -> None:
    """Multi-process bring-up: torch.distributed.init_process_group over
    tcp://<coordinator_address> (host:port) with world size num_processes
    and rank process_id, NCCL on device 'cuda' (each process then takes card
    process_id % device_count as its current device) and gloo on 'cpu' (ref
    hifigan/ddsp_train.py:30-32). A no-op when the group is already up or
    for a single process without a coordinator, as the JAX package's
    jax.distributed bring-up is. A CUDA request without a card raises."""
    from knnsvc_torch.hub import resolve_device

    dev = resolve_device(device)
    if coordinator_address is None and (num_processes is None or num_processes <= 1):
        return
    if torch.distributed.is_initialized():
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs coordinator_address, num_processes "
                         "and process_id")
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    address = coordinator_address if "://" in coordinator_address else \
        f"tcp://{coordinator_address}"
    torch.distributed.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                         init_method=address, world_size=num_processes,
                                         rank=process_id)


def shard_rows(x: torch.Tensor, mesh: Mesh) -> list[list[torch.Tensor]]:
    """Pad x's leading (frame) axis with zero rows to a multiple of the pool
    axis and place block p on device [d][p] of every grid row d:
    -> [d][p] (P_pad / n_pool, ...). Each block is a tensor of its own (no
    view keeps the whole pool alive on one device), and a device that holds
    block p for several grid rows holds one copy."""
    n = mesh.shape["pool"]
    pad = (-x.shape[0]) % n
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    blocks = x.split(x.shape[0] // n)
    placed: dict[tuple[int, torch.device], torch.Tensor] = {}
    grid = []
    for row in mesh.devices:
        out = []
        for p, dev in enumerate(row):
            if (p, dev) not in placed:
                placed[(p, dev)] = blocks[p].to(dev, copy=True)
            out.append(placed[(p, dev)])
        grid.append(out)
    return grid


def gather_rows(shards: Sequence[torch.Tensor], idx: torch.Tensor,
                device: torch.device | None = None) -> torch.Tensor:
    """Rows of a sharded pool at global ids: shard s (rows s * shard_len ..)
    gathers the ids that fall in it, its other entries zeroed, and the S
    partial results are summed on `device` (default idx's): idx (...) ->
    (..., *row shape). Only the requested rows move; each entry is one
    shard's row plus zeros, so the sum is that row exactly (the JAX core's
    masked gather + psum)."""
    device = idx.device if device is None else device
    shard_len = shards[0].shape[0]
    on_dev: dict[torch.device, torch.Tensor] = {}
    total = None
    for s, shard in enumerate(shards):
        if shard.device not in on_dev:
            on_dev[shard.device] = idx.to(shard.device)
        local = on_dev[shard.device] - s * shard_len
        inside = (local >= 0) & (local < shard_len)
        rows = shard[local.clamp(0, shard_len - 1)]
        mask = inside.reshape(*inside.shape, *([1] * (rows.dim() - inside.dim())))
        part = torch.where(mask, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
        part = part.to(device)
        total = part if total is None else total + part
    return total
