"""Device mesh for data and tensor parallelism, port of
``modelcompression_tpu/core/mesh.py``.

A mesh is a (data, model) grid of devices. The JAX package hands it to
GSPMD, which partitions one program over it. Here the port does that by
hand (``parallel/sharding.py``): inference runs one step per device of
the ``data`` axis in one process, training runs one process per device
of the whole grid (``parallel/ranks.py``) with the collectives written
out. Rank ``r = d * model + m`` runs on ``devices[d][m]``, the JAX
order (``make_mesh`` reshapes the device list to (data, model)).

On CUDA the devices are the visible cards, so a mesh of N devices needs
N of them; a caller may name the devices itself, the same card more than
once. On the CPU every shard lives on ``cpu``, the analogue of the JAX
tests' forced host devices: a mesh of any size fits, and each shard runs
in turn.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from modelcompression_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[d][m]``: the device at data index d, model index m.
    ``shape`` maps the axis names to their sizes, as the JAX ``Mesh``'s
    does."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def size(self) -> int:
        """The number of devices, and of training ranks."""
        return len(self.devices) * len(self.devices[0])

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The device of each shard of the batch (model index 0)."""
        return tuple(row[0] for row in self.devices)

    @property
    def rank_devices(self) -> Tuple[torch.device, ...]:
        """The device of each rank, in rank order (row-major)."""
        return tuple(dev for row in self.devices for dev in row)

    def coords(self, rank: int) -> Tuple[int, int]:
        """(data index d, model index m) of ``rank``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        return divmod(rank, len(self.devices[0]))

    def rank_of(self, d: int, m: int) -> int:
        return d * len(self.devices[0]) + m


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """Build a (data, model) mesh.

    ``devices`` defaults to the visible cards when ``device`` (resolved by
    the port's device rule: ``None`` means ``cuda``) is CUDA, and to as
    many ``cpu`` entries as the mesh needs on the CPU. With
    ``config=None`` every device goes on the data axis. Raises
    ``ValueError`` (the JAX text) when the mesh needs more devices than
    there are.
    """
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            n = (config.data * config.model) if config is not None else 1
            devices = [dev] * n
    devices = [torch.device(d) for d in devices]
    if config is None:
        config = MeshConfig(data=len(devices), model=1)
    n = config.data * config.model
    if n > len(devices):
        raise ValueError(
            f"mesh {config} needs {n} devices, have {len(devices)}")
    grid = tuple(tuple(devices[d * config.model:(d + 1) * config.model])
                 for d in range(config.data))
    return Mesh(grid)
