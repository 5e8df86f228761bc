"""One process per device: the ranks of data- and tensor-parallel training.

The JAX package trains over a (data, model) mesh as one program that
GSPMD partitions. PyTorch's idiom is one process per device joined by a
process group; ``spawn`` starts one rank per device of a mesh
(``torch.multiprocessing``), rank ``r = d * model + m`` on the mesh's
r-th device, with backend ``nccl`` on CUDA and ``gloo`` on the CPU
unless the caller names one. The ranks meet through a ``file://`` store
in a fresh temporary directory that ``spawn`` creates and removes, so no
port is chosen before it is bound. Rank 0 keeps its standard output; the
others write theirs to ``os.devnull``.

Each rank belongs to one data group (the ranks of its model index m:
they hold the same filter slices and split the batch) and one model group
(the ranks of its data index d: they hold one row of the batch and split
the filters); ``grid()`` names them. The collectives the train step
writes out are here, each over a group (default: every rank):
``all_reduce_sum`` (with a gradient, for the BN statistics),
``all_reduce_sum_`` (in place, without one), ``all_gather_rows`` (dim 0,
for weights), and the two autograd functions of a sharded conv:
``copy_to_model`` (identity; its backward sums the input gradient over
the model group) and ``gather_channels`` (all-gathers the channels of an
NCHW map over the model group; its backward keeps this rank's slice).

Two ranks cannot share a card under NCCL (it refuses the second
communicator on a card). ``spawn(..., backend="gloo")`` runs a mesh whose
ranks share a card, what ``chip_smoke.py`` does on a one-card machine:
gloo takes CUDA tensors in every collective here (all-reduce and
all-gather into a tensor, float32, bfloat16, float64 and uint8, as a
probe on an H100 with torch 2.11 showed), so nothing is staged by hand.
A mesh of distinct cards runs NCCL unless the caller names a backend.

A script that counts kernel launches (``chip_smoke.py``) cannot read a
rank's counters: with ``LAUNCHES_DIR_ENV`` naming a directory, each rank
writes its ``ops.KERNELS`` counts and its ``COLLECTIVES`` there as
``rank<r>.json`` when it ends.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from modelcompression_tpu_torch.core.mesh import Mesh

LAUNCHES_DIR_ENV = "MC_TORCH_RANK_LAUNCHES_DIR"

# calls and host milliseconds of each collective in this process, by kind
COLLECTIVES: dict = {}


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place on the mesh: its coordinates, its data group
    (the ranks with model index ``m``) and model group (the ranks with
    data index ``d``), and the backend."""

    mesh: Mesh
    rank: int
    d: int
    m: int
    data_group: object
    model_group: object
    backend: str


_GRID: Optional[Grid] = None


def grid() -> Optional[Grid]:
    """This rank's ``Grid``, or None outside ``spawn``'s ranks."""
    return _GRID


def rank() -> Optional[int]:
    """This process's rank, or None outside a process group."""
    return dist.get_rank() if dist.is_initialized() else None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on rank 0 and outside a process group: the process that logs,
    evaluates, checkpoints and writes outputs."""
    return rank() in (None, 0)


def _timed(kind: str, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    c = COLLECTIVES.setdefault(kind, {"calls": 0, "host_ms": 0.0})
    c["calls"] += 1
    c["host_ms"] += (time.perf_counter() - t0) * 1e3
    return out


def reset_collectives() -> None:
    COLLECTIVES.clear()


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``, outside autograd."""
    _timed("all_reduce", dist.all_reduce, t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group; dL/dx = the sum of dL/dy over the
    group (each rank's loss depends on every rank's x through y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum_(
            x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(
            g.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (default: every rank), with a
    gradient."""
    return _AllReduceSum.apply(t, group)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ``t`` concatenated on dim 0 in group-rank order (each
    rank's ``t`` of one shape), outside autograd. Bool tensors travel as
    uint8."""
    src = t.contiguous()
    if src.dtype == torch.bool:
        return all_gather_rows(src.view(torch.uint8), group).bool()
    out = src.new_empty((dist.get_world_size(group) * src.shape[0],)
                        + tuple(src.shape[1:]))
    # all_gather_single is the newer name (torch 2.13 warns on the old)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    _timed("all_gather", gather, out, src, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    """Megatron's copy to the model-parallel region: the identity, whose
    backward sums the input gradient over the model group (each rank's
    filter slice contributes its part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(
            g.clone(memory_format=torch.contiguous_format), ctx.group), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


class _GatherChannels(torch.autograd.Function):
    """The channels of an NCHW map gathered over the model group, rank m's
    slice at channels [m c, (m + 1) c). The gradient that reaches the
    gather is the full map's and equal on every rank of the group (what
    follows runs replicated), so the backward keeps this rank's slice
    and reduces nothing."""

    @staticmethod
    def forward(ctx, y, group):
        n = dist.get_world_size(group)
        ctx.index, ctx.c = dist.get_rank(group), y.shape[1]
        nb, c, h, w = y.shape
        # NHWC rows (free for channels-last storage), gathered on dim 0,
        # then the slices interleaved into each pixel's channels
        rows = all_gather_rows(y.permute(0, 2, 3, 1), group)
        full = rows.view(n, nb, h, w, c).permute(1, 2, 3, 0, 4) \
            .reshape(nb, h, w, n * c)
        return full.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.c
        return g[:, lo:lo + ctx.c], None


def gather_channels(y: torch.Tensor, group) -> torch.Tensor:
    return _GatherChannels.apply(y, group)


def _determinism() -> dict:
    """The launching process's determinism settings, which each rank
    takes on (a rank is a fresh interpreter)."""
    return {"cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "algorithms": torch.are_deterministic_algorithms_enabled(),
            "warn_only":
                torch.is_deterministic_algorithms_warn_only_enabled()}


def _groups(mesh: Mesh, r: int):
    """(data group, model group) of rank r. Every rank creates every
    group, in the same order, as ``dist.new_group`` requires."""
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    d, m = mesh.coords(r)
    data = model = None
    for j in range(tp):
        g = dist.new_group([mesh.rank_of(i, j) for i in range(dp)])
        data = g if j == m else data
    for i in range(dp):
        g = dist.new_group([mesh.rank_of(i, j) for j in range(tp)])
        model = g if i == d else model
    return data, model


def init_grid(mesh: Mesh, r: int, backend: str, init_method: str) -> Grid:
    """Join the process group of ``mesh``'s ranks as rank ``r`` and build
    the data and model groups: what each of ``spawn``'s ranks does before
    its target runs (a one-rank mesh may join in the calling process).
    Returns the ``Grid``; ``destroy_grid`` leaves."""
    global _GRID
    dist.init_process_group(backend, init_method=init_method, rank=r,
                            world_size=mesh.size)
    data, model = _groups(mesh, r)
    _GRID = Grid(mesh, r, *mesh.coords(r), data, model, backend)
    return _GRID


def destroy_grid() -> None:
    global _GRID
    _GRID = None
    dist.destroy_process_group()


def _rank_main(r: int, target: str, argv: Sequence[str], mesh: Mesh,
               backend: str, store: str, threads: int,
               determinism: dict) -> None:
    if r > 0:
        sys.stdout = open(os.devnull, "w")
    torch.backends.cudnn.deterministic = determinism["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = determinism["cudnn_benchmark"]
    torch.use_deterministic_algorithms(determinism["algorithms"],
                                       warn_only=determinism["warn_only"])
    dev = mesh.rank_devices[r]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(threads)
    init_grid(mesh, r, backend, f"file://{store}")
    try:
        mod, fn = target.split(":")
        rc = getattr(importlib.import_module(mod), fn)(list(argv))
    finally:
        destroy_grid()
    out_dir = os.environ.get(LAUNCHES_DIR_ENV)
    if out_dir:
        from modelcompression_tpu_torch.ops import KERNELS
        with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
            json.dump({k.source: {"launches": k.launches,
                                  "at": {str(w): n for w, n in k.at.items()}}
                       for k in KERNELS}
                      | {"collectives": COLLECTIVES}, f)
    if rc:
        sys.exit(rc)


def spawn(target: str, argv: Sequence[str], mesh: Mesh,
          threads: Optional[int] = None,
          backend: Optional[str] = None) -> int:
    """Run ``module:function`` (a CLI ``main``) with ``argv`` in one rank
    per device of ``mesh``, rank r on ``mesh.rank_devices[r]`` (CUDA: that
    card made current; CPU: each rank with ``threads`` intra-op threads,
    default this process's share), each with this process's cuDNN and
    deterministic-algorithm settings, and its data and model groups built
    (``grid()``). ``backend`` defaults to ``nccl`` on CUDA and ``gloo`` on
    the CPU. Returns 0 when every rank returned 0, else the first failing
    rank's exit code (1 for a rank that raised; its traceback goes to
    standard error)."""
    import torch.multiprocessing as mp
    world = mesh.size
    if backend is None:
        backend = "nccl" if mesh.rank_devices[0].type == "cuda" else "gloo"
    if threads is None:
        threads = max(1, torch.get_num_threads() // world)
    tmp = tempfile.mkdtemp(prefix="ranks-")
    try:
        mp.spawn(_rank_main,
                 args=(target, tuple(argv), mesh, backend,
                       os.path.join(tmp, "store"), threads, _determinism()),
                 nprocs=world, join=True)
    except mp.ProcessExitedException as e:
        print(f"error: rank {e.error_index} exited with code "
              f"{e.exit_code}", file=sys.stderr)
        return e.exit_code or 1
    except mp.ProcessRaisedException as e:
        print(f"error: rank {e.error_index} raised:\n{e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0
