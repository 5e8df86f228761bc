"""Checkpoint / resume, port of ``modelcompression_tpu/utils/checkpoint.py``.

The same directory layout as the JAX package (``<path>/step_%08d/`` with
``arch.cfg``, the cfg text of the possibly slimmed architecture, and
``meta.json``); the state is one ``torch.save`` file in place of orbax's
tree, and JAX checkpoints are not read. The state is any tree of dicts,
lists and tuples whose leaves are tensors (saved from the CPU), a
``torch.Generator`` (its state), a ``torch.optim.Optimizer`` (its
``state_dict``: the momentum buffers) or plain values.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from modelcompression_tpu_torch.models.cfg import (
    NetworkSpec, dump_cfg, parse_cfg,
)

_GEN = "__generator__"
_OPT = "__optimizer__"


def _ckpt_dir(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step:08d}")


def _to_host(node: Any) -> Any:
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().clone()
    if isinstance(node, torch.Generator):
        return {_GEN: node.get_state()}
    if isinstance(node, torch.optim.Optimizer):
        return {_OPT: _to_host(node.state_dict())}
    if isinstance(node, dict):
        return {k: _to_host(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_host(v) for v in node)
    return node


def _from_host(node: Any) -> Any:
    """Saved tree -> tensors, generators and optimizer state dicts (an
    optimizer needs its tensors to exist, so only a target rebuilds it)."""
    if isinstance(node, dict):
        if _GEN in node:
            gen = torch.Generator()
            gen.set_state(node[_GEN])
            return gen
        if _OPT in node:
            return node[_OPT]
        return {k: _from_host(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_from_host(v) for v in node)
    return node


def save_checkpoint(path: str, step: int, spec: NetworkSpec,
                    state: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Save a state tree and the architecture; returns the checkpoint
    directory."""
    d = _ckpt_dir(path, step)
    os.makedirs(d, exist_ok=True)
    torch.save(_to_host(state), os.path.join(d, "state.pt"))
    with open(os.path.join(d, "arch.cfg"), "w") as f:
        f.write(dump_cfg(spec))
    meta = {"step": step}
    meta.update(extra or {})
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    return d


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    return os.path.join(path, steps[-1]) if steps else None


def load_checkpoint(ckpt_dir: str, target: Any = None
                    ) -> Tuple[NetworkSpec, Dict[str, Any], Dict[str, Any]]:
    """Returns (spec, state, meta). Tensors come back on the CPU.

    ``target``: a tree of the same layout (e.g. a freshly built
    ``TrainState``) to restore INTO, matched by key: its tensors are
    overwritten in place (on their device), its generators take the saved
    state, its optimizers load the saved state dict, other values are
    replaced. Without a target an optimizer comes back as its state
    dict."""
    state = torch.load(os.path.join(ckpt_dir, "state.pt"),
                       map_location="cpu", weights_only=True)
    with open(os.path.join(ckpt_dir, "arch.cfg")) as f:
        spec = parse_cfg(f.read())
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    if target is None:
        return spec, _from_host(state), meta
    return spec, _restore_into(state, target), meta


def _restore_into(saved: Any, target: Any) -> Any:
    if isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(saved)
        return target
    if isinstance(target, torch.Generator):
        target.set_state(saved[_GEN])
        return target
    if isinstance(target, torch.optim.Optimizer):
        target.load_state_dict(saved[_OPT])
        return target
    if isinstance(target, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint node is {type(saved).__name__}, "
                             "the target expects a dict")
        missing = [k for k in target if k not in saved]
        if missing:
            raise ValueError(f"checkpoint lacks {missing}")
        return type(target)((k, _restore_into(saved[k], v))
                            for k, v in target.items())
    if isinstance(target, (list, tuple)):
        return type(target)(_restore_into(s, v)
                            for s, v in zip(saved, target))
    return saved
