"""The segmented-bisection threshold rule over |w| bit patterns, in plain
PyTorch (port of ``abs_bits`` and ``segmented_kth_bits`` of
``modelcompression_tpu/ops/topk_mask.py``), and the HWIO flat order.

* |w| >= 0, and non-negative IEEE-754 floats order exactly as their bit
  patterns do. The port keeps the patterns as int32 with the sign bit
  cleared (``torch.uint32`` supports few ops): every value is in
  [0, 0x7FFFFFFF], so int32 comparisons order them as |w| orders.
* The k-th smallest value of each segment is found in 31 rounds of
  bisection over those 31 bits, each round one masked per-segment count
  (``count_le_rule``) and no sort. Nothing in the loop reads a device value on
  the host.

``segmented_kth_bits`` is the rule the JAX package defines and the tests'
reference. ``ops/cuda_topk.prune_flat`` does not run it: it finds the
same k-th pattern with a radix select (``cuda_topk.radix_select``, four
histogram passes).

Flat order: the tie rule ranks ties by their index in the concatenation of
the JAX package's HWIO-flattened kernels. The port stores kernels OIHW, so
every kernel is permuted to HWIO before it is flattened (``hwio_flat``) and
its mask permuted back (``oihw_from_flat``); flattening OIHW would break
ties in another order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from modelcompression_tpu_torch.models.cfg import ConvLayer, NetworkSpec
from modelcompression_tpu_torch.models.darknet import conv_key

SIGN_MASK = 0x7FFFFFFF
BISECT_ROUNDS = 31


def _prunable_keys(spec: NetworkSpec, skip: Sequence[int]) -> List[str]:
    return [conv_key(i) for i, l in enumerate(spec.layers)
            if isinstance(l, ConvLayer) and i not in skip]


def hwio_flat(w_oihw: torch.Tensor) -> torch.Tensor:
    """An OIHW kernel flattened in the JAX package's HWIO order."""
    return w_oihw.permute(2, 3, 1, 0).reshape(-1)


def oihw_from_flat(flat: torch.Tensor, shape_oihw) -> torch.Tensor:
    """Inverse of ``hwio_flat``: an HWIO-ordered flat vector back to an
    OIHW tensor of ``shape_oihw``."""
    o, i, kh, kw = shape_oihw
    return flat.reshape(kh, kw, i, o).permute(3, 2, 0, 1).contiguous()


def abs_bits(w: torch.Tensor) -> torch.Tensor:
    """|w| as int32 bit patterns (sign bit cleared), ordered as |w| is."""
    return w.float().contiguous().view(torch.int32) & SIGN_MASK


def count_le_rule(bits: torch.Tensor, seg_ids: torch.Tensor,
                  mid: torch.Tensor, n_segments: int) -> torch.Tensor:
    """For each segment s, the count of elements with ``bits <= mid[s]``
    (int64, (S,))."""
    seg = seg_ids.long()
    below = bits.long() <= mid.long()[seg]
    out = torch.zeros(n_segments, dtype=torch.int64, device=bits.device)
    return out.index_add_(0, seg, below.long())


def segmented_kth_bits(bits: torch.Tensor, seg_ids: torch.Tensor,
                       k: torch.Tensor, n_segments: int) -> torch.Tensor:
    """For each segment s, the bit pattern of its k[s]-th smallest element
    (0-indexed, k[s] in [0, segment size)). 31 rounds of ``count_le_rule``;
    bounds are int64, so ``mid + 1`` cannot wrap. Returns int64 (S,)."""
    k = k.long()
    lo = torch.zeros(n_segments, dtype=torch.int64, device=bits.device)
    hi = torch.full((n_segments,), SIGN_MASK, dtype=torch.int64,
                    device=bits.device)
    for _ in range(BISECT_ROUNDS):
        mid = lo + ((hi - lo) >> 1)
        gt = count_le_rule(bits, seg_ids, mid, n_segments) > k
        # count(<= mid) > k: the answer is <= mid, else it is > mid
        hi = torch.where(gt, mid, hi)
        lo = torch.where(gt, lo, mid + 1)
    return lo
