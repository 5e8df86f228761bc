from modelcompression_tpu_torch.compress.backend import (
    DEFAULT_MASK_BACKEND, MASK_BACKENDS, magnitude_mask_fn,
)
from modelcompression_tpu_torch.compress.criteria import (
    FILTER_CRITERIA, apply_masks, bn_gamma_scores_device,
    csp_balanced_keep_sets, csp_balanced_scores_device,
    csp_constrainable_indices, filter_scores_device, fpgm_filter_scores,
    fpgm_scores_device, global_threshold, keep_sets_from_scores,
    l1_filter_keep, l1_filter_keep_sets, l1_filter_keep_sets_scheduled,
    l1_filter_scores, l1_filter_scores_device, magnitude_mask_layer,
    magnitude_masks_global, magnitude_masks_perlayer, mask_sparsity,
    tied_group_keep_sets, tied_group_scores_device,
)
from modelcompression_tpu_torch.compress.codebook import (
    cluster_layer, cluster_network, load_cmodel, reconstruct, save_cmodel,
)
from modelcompression_tpu_torch.compress.flops import (
    SCORE_NORMS, conv_flops_by_layer, flop_targeted_keep_sets,
    total_conv_flops,
)
from modelcompression_tpu_torch.compress.graph import (
    channel_source_convs, head_producer_convs, protected_conv_indices,
    prunable_conv_indices, tied_conv_groups,
)
from modelcompression_tpu_torch.compress.gmp import (
    GMPSpec, gmp_init_masks, gmp_mask_update, gmp_masks, gmp_sparsity,
)
from modelcompression_tpu_torch.compress.lamp import (
    lamp_layer_sparsities, lamp_masks, lamp_scores_device,
)
from modelcompression_tpu_torch.compress.lowrank import (
    FactorEntry, breakeven_rank, factor_conv_weight, factor_network,
    rank_for_energy,
)
from modelcompression_tpu_torch.compress.packing import (
    huffman_decode, huffman_encode, pack_codes, unpack_codes,
)
from modelcompression_tpu_torch.compress.qat import (
    QATSpec, fake_quant, fake_quant_weight, qat_spec_from_batches,
    quantize_qat,
)
from modelcompression_tpu_torch.compress.quantize import (
    collect_act_absmax, forward_quantized, int8_layers_auto, load_qmodel,
    quantize_from_batches, quantize_network, save_qmodel,
)
from modelcompression_tpu_torch.compress.repack import (
    channel_masks_from_keep, propagate_keep_sets, repack,
    uniform_filter_fraction_keep_sets,
)
from modelcompression_tpu_torch.compress.taylor import (
    taylor_filter_keep_sets, taylor_filter_scores_device,
    taylor_gate_indices, taylor_scores_all, taylor_scores_with_groups,
)

__all__ = ["DEFAULT_MASK_BACKEND", "MASK_BACKENDS", "magnitude_mask_fn",
           "FILTER_CRITERIA", "apply_masks", "bn_gamma_scores_device",
           "csp_balanced_keep_sets", "csp_balanced_scores_device",
           "csp_constrainable_indices", "filter_scores_device",
           "fpgm_filter_scores", "fpgm_scores_device", "global_threshold",
           "keep_sets_from_scores", "l1_filter_keep", "l1_filter_keep_sets",
           "l1_filter_keep_sets_scheduled", "l1_filter_scores",
           "l1_filter_scores_device", "magnitude_mask_layer",
           "magnitude_masks_global", "magnitude_masks_perlayer",
           "mask_sparsity", "tied_group_keep_sets",
           "tied_group_scores_device",
           "SCORE_NORMS", "conv_flops_by_layer", "flop_targeted_keep_sets",
           "total_conv_flops",
           "channel_source_convs", "head_producer_convs",
           "protected_conv_indices", "prunable_conv_indices",
           "tied_conv_groups",
           "collect_act_absmax", "forward_quantized", "int8_layers_auto",
           "load_qmodel", "quantize_from_batches", "quantize_network",
           "save_qmodel",
           "QATSpec", "fake_quant", "fake_quant_weight",
           "qat_spec_from_batches", "quantize_qat",
           "channel_masks_from_keep", "propagate_keep_sets", "repack",
           "uniform_filter_fraction_keep_sets",
           "taylor_filter_keep_sets", "taylor_filter_scores_device",
           "taylor_gate_indices", "taylor_scores_all",
           "taylor_scores_with_groups",
           "cluster_layer", "cluster_network", "load_cmodel", "reconstruct",
           "save_cmodel",
           "GMPSpec", "gmp_init_masks", "gmp_mask_update", "gmp_masks",
           "gmp_sparsity",
           "lamp_layer_sparsities", "lamp_masks", "lamp_scores_device",
           "FactorEntry", "breakeven_rank", "factor_conv_weight",
           "factor_network", "rank_for_energy",
           "huffman_decode", "huffman_encode", "pack_codes", "unpack_codes"]
