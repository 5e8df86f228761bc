"""Hand-written kernels of the port, each beside its plain PyTorch version.

Every kernel wrapper carries a ``LAUNCHES`` integer, incremented where it
launches its kernel and nowhere else, and beside it ``LAUNCHES_AT``, the
same launches counted by the kernel's width (the input stage's output
channels C, the top-k kernels' segment count S). ``KERNELS`` lists them
for callers that build every kernel up front or read every count
(``chip_smoke.py``).
"""

from modelcompression_tpu_torch.ops.cuda_topk import (
    apply_threshold, apply_threshold_cuda, apply_threshold_plain, count_le,
    count_le_cuda, count_le_plain, prune_flat, radix_select,
    radix_select_cuda, radix_select_plain, tie_counts, tie_counts_cuda,
    tie_counts_plain,
)
from modelcompression_tpu_torch.ops.input_stage import (
    fused_conv1_pool, fused_conv1_pool_cuda, fused_conv1_pool_f32,
    fused_conv1_pool_mma, fused_conv1_pool_plain, input_stage_match,
    pack_mma_weights,
)

# (csrc source name, wrapper) for every kernel of the port;
# ``input_stage`` and ``topk_count_le`` are the yardsticks that no path
# launches
KERNELS = (("input_stage", fused_conv1_pool_cuda),
           ("input_stage_mma", fused_conv1_pool_mma),
           ("input_stage_f32", fused_conv1_pool_f32),
           ("topk_radix_select", radix_select_cuda),
           ("topk_count_le", count_le_cuda),
           ("topk_tie_counts", tie_counts_cuda),
           ("topk_apply", apply_threshold_cuda))

__all__ = ["KERNELS", "apply_threshold", "apply_threshold_cuda",
           "apply_threshold_plain", "count_le", "count_le_cuda",
           "count_le_plain", "fused_conv1_pool", "fused_conv1_pool_cuda",
           "fused_conv1_pool_f32", "fused_conv1_pool_mma",
           "fused_conv1_pool_plain", "input_stage_match",
           "pack_mma_weights", "prune_flat", "radix_select",
           "radix_select_cuda", "radix_select_plain", "tie_counts",
           "tie_counts_cuda", "tie_counts_plain"]
