"""Sharding rules, port of ``modelcompression_tpu/parallel/sharding.py``.

The JAX package annotates arrays with shardings over a (data, model) mesh
and lets GSPMD partition the program. The port runs the partition it
asks for by hand:

* **Inference** (eval, serve, detect ``--dp``), one process:
  ``replicate`` puts a copy of the params on every device of the data
  axis, ``shard_batch`` splits the batch on dim 0 into equal contiguous
  chunks (``P("data")``), and ``data_parallel`` runs the step once per
  shard, each on its device's current stream, and concatenates the
  outputs in batch order.
* **Training**, one process per device (``parallel/ranks.py``):
  ``place_train_state`` moves the train state to this rank's device; the
  train step slices its rows of the global batch and all-reduces the BN
  statistics, the loss sums and the gradients
  (``train/train_step.py``).

``param_specs`` keeps the JAX package's tensor-parallel rule (filters
sharded over ``model`` where they divide it) as pure logic, on the port's
OIHW weights: the filter axis is dim 0 here, dim 3 of JAX's HWIO.
Tensor parallelism itself has no port yet: ``place_train_state`` rejects
it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from modelcompression_tpu_torch.core.mesh import Mesh
from modelcompression_tpu_torch.data.streaming import _tree_map
from modelcompression_tpu_torch.models.cfg import ConvLayer, NetworkSpec
from modelcompression_tpu_torch.models.darknet import Params, conv_key

TP_NOT_PORTED = ("tensor parallelism (--tp above 1) is not ported to the "
                 "PyTorch package yet (ROADMAP Queue 1 item 11)")


class PartitionSpec(tuple):
    """The axis name (or None) each tensor dim is sharded over; ``P()``
    is replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


def param_specs(spec: NetworkSpec, params: Params, tp: bool = False,
                tp_size: int = 1) -> Dict[str, Dict[str, PartitionSpec]]:
    """PartitionSpec tree for the params. DP: everything replicated. TP:
    conv filters (OIHW dim 0) and the matching BN/bias vectors sharded
    over 'model' where the filter count divides the axis; the other
    convs stay replicated."""
    specs: Dict[str, Dict[str, PartitionSpec]] = {}
    for i, l in enumerate(spec.layers):
        if not isinstance(l, ConvLayer):
            continue
        k = conv_key(i)
        if tp and tp_size > 1 and l.filters % tp_size == 0:
            w_spec, v_spec = P("model", None, None, None), P("model")
        else:
            w_spec, v_spec = P(), P()
        specs[k] = {n: (w_spec if n == "w" else v_spec) for n in params[k]}
    return specs


def replicate(tree, mesh: Mesh) -> List:
    """One copy of ``tree`` (nested dicts, lists and tuples of tensors)
    per device of the mesh's data axis. Copies on the same device share
    their tensors."""
    return [_tree_map(lambda t, d=dev: torch.as_tensor(t).to(d), tree)
            for dev in mesh.data_devices]


def shard_batch(tree, mesh: Mesh) -> List:
    """Split every array leaf of ``tree`` on dim 0 into one contiguous
    equal chunk per device of the data axis, each copied to its device
    (from pinned memory on CUDA, without blocking the host). Returns the
    per-shard trees in batch order."""
    devices = mesh.data_devices
    n = len(devices)

    def chunk(x, i, dev):
        t = torch.as_tensor(x)
        if t.shape[0] % n:
            raise ValueError(f"batch dim {t.shape[0]} not divisible by "
                             f"data-parallel size {n}")
        c = t.shape[0] // n
        t = t[i * c:(i + 1) * c]
        if t.device.type == "cpu" and dev.type == "cuda":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    return [_tree_map(lambda x, i=i, d=dev: chunk(x, i, d), tree)
            for i, dev in enumerate(devices)]


def _on(device: torch.device):
    """Make ``device`` current, so kernels launched through ctypes and the
    current stream are that card's."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def data_parallel(step, mesh: Mesh):
    """The data-parallel form of a serving step ``step(params, *batch) ->
    tuple of batch-first outputs``: ``fn(replicas, *batch)`` takes
    ``replicate(params, mesh)`` and the whole batch, runs ``step`` on each
    shard on its device and returns the outputs concatenated in batch
    order on the first device. ``fn.run_shards(replicas, shards)`` takes a
    batch already split by ``shard_batch``."""
    devices = mesh.data_devices

    def run_shards(replicas, shards):
        outs = []
        for dev, params, args in zip(devices, replicas, shards):
            with _on(dev):
                outs.append(step(params, *args))
        if len(outs) == 1:
            return tuple(outs[0])
        return tuple(torch.cat([o[i].to(devices[0], non_blocking=True)
                                for o in outs])
                     for i in range(len(outs[0])))

    def fn(replicas, *batch):
        return run_shards(replicas, shard_batch(batch, mesh))

    fn.run_shards = run_shards
    return fn


def place_train_state(state, mesh: Mesh, spec: NetworkSpec,
                      tp: bool = False, rank: int = 0):
    """Move a train state to the device of data index ``rank`` (this
    process's): the params in place, so the optimizer keeps them, its
    momentum buffers, the masks and the EMA shadow. Tensor-parallel
    placement raises. Returns the state."""
    if tp and mesh.shape["model"] > 1:
        raise NotImplementedError(TP_NOT_PORTED)
    dev = mesh.data_devices[rank]
    with torch.no_grad():
        for p in state["params"].values():
            for v in p.values():
                v.data = v.data.to(dev)
        for buf in state["optimizer"].state.values():
            for n, v in buf.items():
                if isinstance(v, torch.Tensor):
                    buf[n] = v.to(dev)
        for key in ("weight_masks", "channel_masks"):
            state[key] = {k: m.to(dev) for k, m in state[key].items()}
        if "ema_params" in state:
            state["ema_params"] = {
                k: {n: v.to(dev) for n, v in p.items()}
                for k, p in state["ema_params"].items()}
    return state
