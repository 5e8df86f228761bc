from modelcompression_tpu_torch.compress.backend import (
    DEFAULT_MASK_BACKEND, MASK_BACKENDS, magnitude_mask_fn,
)
from modelcompression_tpu_torch.compress.criteria import (
    apply_masks, csp_balanced_keep_sets, global_threshold,
    keep_sets_from_scores, l1_filter_keep_sets,
    l1_filter_keep_sets_scheduled, l1_filter_scores, magnitude_mask_layer,
    magnitude_masks_global, magnitude_masks_perlayer, mask_sparsity,
)
from modelcompression_tpu_torch.compress.graph import (
    channel_source_convs, protected_conv_indices, prunable_conv_indices,
    tied_conv_groups,
)
from modelcompression_tpu_torch.compress.repack import (
    channel_masks_from_keep, propagate_keep_sets, repack,
    uniform_filter_fraction_keep_sets,
)

__all__ = ["DEFAULT_MASK_BACKEND", "MASK_BACKENDS", "magnitude_mask_fn",
           "apply_masks", "csp_balanced_keep_sets", "global_threshold",
           "keep_sets_from_scores", "l1_filter_keep_sets",
           "l1_filter_keep_sets_scheduled", "l1_filter_scores",
           "magnitude_mask_layer", "magnitude_masks_global",
           "magnitude_masks_perlayer", "mask_sparsity",
           "channel_source_convs", "protected_conv_indices",
           "prunable_conv_indices", "tied_conv_groups",
           "channel_masks_from_keep", "propagate_keep_sets", "repack",
           "uniform_filter_fraction_keep_sets"]
