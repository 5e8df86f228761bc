"""Sharding rules, port of ``modelcompression_tpu/parallel/sharding.py``.

The JAX package annotates arrays with shardings over a (data, model) mesh
and lets GSPMD partition the program. The port runs the partition it
asks for by hand:

* **Inference** (eval, serve, detect ``--dp``), one process:
  ``replicate`` puts a copy of the params on every device of the data
  axis, ``shard_batch`` splits the batch on dim 0 into equal contiguous
  chunks (``P("data")``), and ``data_parallel`` runs the step once per
  shard, each on its device's current stream, and concatenates the
  outputs in batch order. ``eval --tp`` replicates over the model axis,
  as the JAX package does.
* **Training**, one process per device of the mesh
  (``parallel/ranks.py``): ``place_train_state`` moves the train state
  to this rank's device and, with ``tp``, keeps this rank's filters of
  each sharded conv (``param_specs``): the params, the momentum buffers,
  the weight masks and the EMA shadow. The train step slices its rows of
  the global batch, runs each sharded conv on its filters and gathers
  the channels over the model group (``TensorParallel``), and
  all-reduces the BN statistics, the loss sums and the gradients
  (``train/train_step.py``). ``gather_params`` and
  ``gather_train_state`` put the full tensors back together on every
  rank (a collective: every rank calls them), for an eval, a checkpoint
  or the written weights.

``param_specs`` is the JAX package's tensor-parallel rule (filters
sharded over ``model`` where they divide it) on the port's OIHW weights:
the filter axis is dim 0 here, dim 3 of JAX's HWIO.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, FrozenSet, List

import torch

from modelcompression_tpu_torch.core.mesh import Mesh
from modelcompression_tpu_torch.data.streaming import _tree_map
from modelcompression_tpu_torch.models.cfg import ConvLayer, NetworkSpec
from modelcompression_tpu_torch.models.darknet import Params, conv_key
from modelcompression_tpu_torch.parallel import ranks


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
    sharded = sharded_keys(spec, tp_size if tp else 1)
    for i, l in enumerate(spec.layers):
        if not isinstance(l, ConvLayer):
            continue
        k = conv_key(i)
        if k in sharded:
            w_spec, v_spec = P("model", None, None, None), P("model")
        else:
            w_spec, v_spec = P(), P()
        specs[k] = {n: (w_spec if n == "w" else v_spec) for n in params[k]}
    return specs


def sharded_keys(spec: NetworkSpec, tp_size: int) -> FrozenSet[str]:
    """The conv keys whose filters ``param_specs`` shards over a model
    axis of ``tp_size``: every conv whose filter count it divides."""
    if tp_size <= 1:
        return frozenset()
    return frozenset(conv_key(i) for i, l in enumerate(spec.layers)
                     if isinstance(l, ConvLayer)
                     and l.filters % tp_size == 0)


def _rows(t: torch.Tensor, m: int, tp: int) -> torch.Tensor:
    """Model index m's rows of dim 0 (a view)."""
    c = t.shape[0] // tp
    return t[m * c:(m + 1) * c]


def shard_params(params: Params, mesh: Mesh, spec: NetworkSpec,
                 tp: bool = False, rank: int = 0) -> Params:
    """Rank ``rank``'s params on its device: the filters of each sharded
    conv (``param_specs``) at its model index, the rest whole."""
    dev = mesh.rank_devices[rank]
    _, m = mesh.coords(rank)
    tp_size = mesh.shape["model"]
    sharded = sharded_keys(spec, tp_size if tp else 1)
    return {k: {n: (_rows(v, m, tp_size) if k in sharded else v).to(dev)
                for n, v in p.items()}
            for k, p in params.items()}


def _model_group():
    g = ranks.grid()
    if g is None:
        raise ValueError("gathering tensor-parallel shards runs inside the "
                         "ranks of parallel.ranks.spawn")
    return g.model_group


def gather_params(params: Params, mesh: Mesh, spec: NetworkSpec) -> Params:
    """The counterpart of ``shard_params``: each sharded conv's tensors
    all-gathered over the model group, detached, on every rank. Every
    rank must call it. Without a model axis: the params, detached."""
    sharded = sharded_keys(spec, mesh.shape["model"])
    group = _model_group() if sharded else None
    with torch.no_grad():
        return {k: {n: (ranks.all_gather_rows(v.detach(), group)
                        if k in sharded else v.detach())
                    for n, v in p.items()}
                for k, p in params.items()}


def gather_train_state(state, mesh, spec: NetworkSpec):
    """A full copy of a tensor-parallel train state on every rank: the
    params, momentum buffers, weight masks and EMA shadow gathered
    (``gather_params``), in a fresh ``TrainState`` whose optimizer holds
    the full momentum, ready to save or evaluate (the unsharded tensors
    are the live state's). Every rank must call it. Returns ``state``
    itself without a mesh or a model axis."""
    if mesh is None or mesh.shape["model"] == 1:
        return state
    from modelcompression_tpu_torch.train.train_step import TrainState
    sharded = sharded_keys(spec, mesh.shape["model"])
    group = _model_group()

    def full(k, v):
        return ranks.all_gather_rows(v, group) if k in sharded else v

    opt = state["optimizer"]
    params = gather_params(state["params"], mesh, spec)
    owner = {id(v): k for k, p in state["params"].items() for v in p.values()}
    # the momentum keyed by the params' order; the per-param dicts are
    # the live optimizer's, so each is replaced, not written into
    saved = opt.state_dict()
    order = [v for g in opt.param_groups for v in g["params"]]
    with torch.no_grad():
        for i, buf in list(saved["state"].items()):
            if buf.get("momentum_buffer") is not None:
                saved["state"][i] = dict(buf, momentum_buffer=full(
                    owner[id(order[i])], buf["momentum_buffer"]))
        masks = {k: full(k, m) for k, m in state["weight_masks"].items()}
    out = TrainState.create(params, lambda ts: type(opt)(ts, **opt.defaults),
                            state["rng"], weight_masks=masks,
                            channel_masks=state["channel_masks"],
                            copy=False, seen=state["seen"])
    out["optimizer"].load_state_dict(saved)
    out["step"] = state["step"]
    if "ema_params" in state:
        out["ema_params"] = gather_params(state["ema_params"], mesh, spec)
    return out


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
    """Move a full train state to the device of ``rank`` (this process's)
    in place, so the optimizer keeps its params: the params, the momentum
    buffers, the masks and the EMA shadow. With ``tp`` each sharded conv
    (``param_specs``) keeps only the filters of the rank's model index in
    all of them; the channel masks stay whole (the step slices them).
    Returns the state."""
    dev = mesh.rank_devices[rank]
    _, m = mesh.coords(rank)
    tp_size = mesh.shape["model"]
    sharded = sharded_keys(spec, tp_size if tp else 1)

    def put(k, v):
        return (_rows(v, m, tp_size).clone() if k in sharded else v).to(dev)

    with torch.no_grad():
        for k, p in state["params"].items():
            for v in p.values():
                buf = state["optimizer"].state.get(v, {})
                for n, b in buf.items():
                    if isinstance(b, torch.Tensor) and b.dim():
                        buf[n] = put(k, b)
                v.data = put(k, v.data)
        state["weight_masks"] = {k: put(k, w)
                                 for k, w in state["weight_masks"].items()}
        state["channel_masks"] = {k: c.to(dev) for k, c
                                  in state["channel_masks"].items()}
        if "ema_params" in state:
            state["ema_params"] = {
                k: {n: put(k, v) for n, v in p.items()}
                for k, p in state["ema_params"].items()}
    return state


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's part of the model axis, for the train step's forward:
    the convs in ``sharded`` run on filters [m c, (m + 1) c) of their
    ``tp`` slices (``local``) on the full input taken through
    ``copy_in`` (its gradient summed over the model group), with their BN
    moments reduced by ``bn_reduce`` (over the data group), and their
    output channels gathered by ``gather``."""

    index: int
    size: int
    sharded: FrozenSet[str]
    model_group: object
    bn_reduce: Callable

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return _rows(t, self.index, self.size)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return ranks.copy_to_model(x, self.model_group)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        return ranks.gather_channels(y, self.model_group)
