"""One process per device: the ranks of data-parallel training.

The JAX package trains data-parallel as one program that GSPMD
partitions. PyTorch's idiom is one process per device joined by a process
group; ``spawn`` starts them (``torch.multiprocessing``, rendezvous on
``127.0.0.1`` at a free port) with backend ``nccl`` on ``cuda:r`` and
``gloo`` on the CPU. Rank 0 keeps its standard output; the others write
theirs to ``os.devnull``. The collectives the train step writes out are
here: ``all_reduce_sum`` (with a gradient, for the BN statistics) and
``all_reduce_sum_`` (in place, without one).

A script that counts kernel launches (``chip_smoke.py``) cannot read a
rank's counters: with ``LAUNCHES_DIR_ENV`` naming a directory, each rank
writes its ``ops.KERNELS`` counts there as ``rank<r>.json`` when it ends.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import sys
from typing import Optional, Sequence

import torch
import torch.distributed as dist


LAUNCHES_DIR_ENV = "MC_TORCH_RANK_LAUNCHES_DIR"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank() -> Optional[int]:
    """This process's rank, or None outside a process group."""
    return dist.get_rank() if dist.is_initialized() else None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on rank 0 and outside a process group: the process that logs,
    evaluates, checkpoints and writes outputs."""
    return rank() in (None, 0)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; dL/dx = the sum of dL/dy over the
    ranks (each rank's loss depends on every rank's x through y)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the ranks, with a gradient."""
    return _AllReduceSum.apply(t)


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum of ``t`` over the ranks, outside autograd."""
    dist.all_reduce(t)
    return t


def _determinism() -> dict:
    """The launching process's determinism settings, which each rank
    takes on (a rank is a fresh interpreter)."""
    return {"cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "algorithms": torch.are_deterministic_algorithms_enabled(),
            "warn_only":
                torch.is_deterministic_algorithms_warn_only_enabled()}


def _rank_main(r: int, target: str, argv: Sequence[str], world: int,
               port: int, device: str, threads: int,
               determinism: dict) -> None:
    if r > 0:
        sys.stdout = open(os.devnull, "w")
    torch.backends.cudnn.deterministic = determinism["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = determinism["cudnn_benchmark"]
    torch.use_deterministic_algorithms(determinism["algorithms"],
                                       warn_only=determinism["warn_only"])
    if device == "cuda":
        torch.cuda.set_device(r)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=r, world_size=world)
    try:
        mod, fn = target.split(":")
        rc = getattr(importlib.import_module(mod), fn)(list(argv))
    finally:
        dist.destroy_process_group()
    out_dir = os.environ.get(LAUNCHES_DIR_ENV)
    if out_dir:
        from modelcompression_tpu_torch.ops import KERNELS
        with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
            json.dump({name: {"launches": w.LAUNCHES,
                              "at": {str(k): n for k, n
                                     in w.LAUNCHES_AT.items()}}
                       for name, w in KERNELS}, f)
    if rc:
        sys.exit(rc)


def spawn(target: str, argv: Sequence[str], world: int, device: str,
          threads: Optional[int] = None) -> int:
    """Run ``module:function`` (a CLI ``main``) with ``argv`` in ``world``
    ranks on ``device`` ('cuda': rank r on ``cuda:r``; 'cpu': each rank
    with ``threads`` intra-op threads, default this process's share), each
    with this process's cuDNN and deterministic-algorithm settings.
    Returns
    0 when every rank returned 0, else the first failing rank's exit code
    (1 for a rank that raised; its traceback goes to standard error)."""
    import torch.multiprocessing as mp
    if threads is None:
        threads = max(1, torch.get_num_threads() // world)
    try:
        mp.spawn(_rank_main, args=(target, tuple(argv), world, free_port(),
                                   device, threads, _determinism()),
                 nprocs=world, join=True)
    except mp.ProcessExitedException as e:
        print(f"error: rank {e.error_index} exited with code "
              f"{e.exit_code}", file=sys.stderr)
        return e.exit_code or 1
    except mp.ProcessRaisedException as e:
        print(f"error: rank {e.error_index} raised:\n{e}", file=sys.stderr)
        return 1
    return 0
