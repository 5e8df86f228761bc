"""Hand-written kernels of the port, each beside its plain PyTorch version.

Every kernel launches through its ``_build.Kernel``, which counts its
launches in ``launches``, and in ``at`` by the kernel's width (the input
stages' and the conv epilogue's output channels C, the top-k kernels'
segment count S). ``KERNELS`` lists them for callers that build every
kernel up front or read every count (``chip_smoke.py``, the ranks of
``parallel/ranks.py``).
"""

from modelcompression_tpu_torch.ops import (
    conv_epilogue, cuda_topk, input_stage,
)
from modelcompression_tpu_torch.ops.conv_epilogue import (
    bias_act_cuda, bias_act_plain,
)
from modelcompression_tpu_torch.ops.cuda_topk import (
    apply_threshold, apply_threshold_cuda, apply_threshold_plain,
    count_le_plain, prune_flat, radix_select, radix_select_cuda,
    radix_select_plain, tie_counts, tie_counts_cuda, tie_counts_plain,
)
from modelcompression_tpu_torch.ops.input_stage import (
    fused_conv1_pool, fused_conv1_pool_f32, fused_conv1_pool_mma,
    fused_conv1_pool_plain, input_stage_match, pack_mma_weights,
)

# every csrc/ kernel of the port
KERNELS = (input_stage.MMA, input_stage.F32, cuda_topk.RADIX_SELECT,
           cuda_topk.TIE_COUNTS, cuda_topk.APPLY, conv_epilogue.KERNEL)

__all__ = ["KERNELS", "apply_threshold", "apply_threshold_cuda",
           "apply_threshold_plain", "bias_act_cuda", "bias_act_plain",
           "count_le_plain", "fused_conv1_pool", "fused_conv1_pool_f32",
           "fused_conv1_pool_mma", "fused_conv1_pool_plain",
           "input_stage_match", "pack_mma_weights", "prune_flat",
           "radix_select", "radix_select_cuda", "radix_select_plain",
           "tie_counts", "tie_counts_cuda", "tie_counts_plain"]
