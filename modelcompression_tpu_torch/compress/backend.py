"""Magnitude-mask backend selection (port of
``modelcompression_tpu/compress/backend.py``).

The JAX package has two fast routes: ``fused`` (one XLA program of
segmented bisection) and ``pallas`` (the same rule through hand-written
TPU kernels). Here the two are one route, ``ops/cuda_topk.magnitude_masks_*``:
the hand-written CUDA kernels for CUDA tensors and their plain PyTorch
versions for CPU tensors. ``pallas`` is kept as a name for it, so JAX
command lines (``--mask-backend pallas``, ``--use-pallas``) run unchanged.

* ``fused`` (default) and ``pallas``: ``ops/cuda_topk.py``.
* ``reference``: ``compress/criteria.py``, the stable-argsort definition
  of the rule that the other route is held against.
"""

from __future__ import annotations

from typing import Callable

MASK_BACKENDS = ("fused", "pallas", "reference")
DEFAULT_MASK_BACKEND = "fused"


def magnitude_mask_fn(mode: str, backend: str = DEFAULT_MASK_BACKEND
                      ) -> Callable:
    """The mask function ``fn(params, spec, sparsity, skip=())`` for a
    criterion ``mode`` ('magnitude' = per-layer, 'global' = one network
    threshold) and ``backend``. All backends share the signature and give
    equal, tie-stable masks."""
    if mode not in ("magnitude", "global"):
        raise ValueError(f"unknown magnitude criterion mode {mode!r} "
                         "(expected 'magnitude' or 'global')")
    per_layer = mode == "magnitude"
    if backend in ("fused", "pallas"):
        from modelcompression_tpu_torch.ops import cuda_topk as m
    elif backend == "reference":
        from modelcompression_tpu_torch.compress import criteria as m
    else:
        raise ValueError(f"unknown mask backend {backend!r} "
                         f"(expected one of {MASK_BACKENDS})")
    return m.magnitude_masks_perlayer if per_layer \
        else m.magnitude_masks_global
