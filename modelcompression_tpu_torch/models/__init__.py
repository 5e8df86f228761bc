from modelcompression_tpu_torch.models.cfg import (
    ConvLayer, MaxPoolLayer, NetConfig, NetworkSpec, RegionLayer, ReorgLayer,
    RouteLayer, ShortcutLayer, UnknownCfgKeyWarning, UpsampleLayer,
    YoloLayer, dump_cfg, load_cfg, out_channels, parse_cfg,
)
from modelcompression_tpu_torch.models.convert import (
    params_from_jax, params_to_jax,
)
from modelcompression_tpu_torch.models.darknet import (
    Params, conv_key, fold_batchnorm, forward, forward_folded, init_params,
    maxpool, num_conv_flops, num_params, params_to, reorg, route_part,
    upsample_nearest,
)
from modelcompression_tpu_torch.models.weights_io import (
    load_weights, roundtrip_bytes, save_weights,
)
from modelcompression_tpu_torch.models.zoo import (
    CONFIG_DIR, cfg_path, coco_names_path, tiny_yolov2_coco,
    tiny_yolov2_voc, voc_names_path, yolov2_coco, yolov2_voc, yolov3_coco,
    yolov3_spp_coco, yolov3_tiny_coco, yolov3_tiny_voc, yolov3_voc,
    yolov4_coco, yolov4_tiny_coco, yolov4_tiny_voc, yolov4_voc,
)

__all__ = [
    "ConvLayer", "MaxPoolLayer", "NetConfig", "NetworkSpec", "RegionLayer",
    "ReorgLayer", "RouteLayer", "ShortcutLayer", "UnknownCfgKeyWarning",
    "UpsampleLayer", "YoloLayer", "dump_cfg", "load_cfg", "out_channels",
    "parse_cfg", "params_from_jax", "params_to_jax", "Params", "conv_key",
    "fold_batchnorm", "forward", "forward_folded", "init_params", "maxpool",
    "num_conv_flops", "num_params", "params_to", "reorg", "route_part",
    "upsample_nearest", "load_weights", "roundtrip_bytes", "save_weights",
    "CONFIG_DIR", "cfg_path", "coco_names_path", "tiny_yolov2_coco",
    "tiny_yolov2_voc", "voc_names_path", "yolov2_coco", "yolov2_voc",
    "yolov3_coco", "yolov3_spp_coco", "yolov3_tiny_coco", "yolov3_tiny_voc",
    "yolov3_voc", "yolov4_coco", "yolov4_tiny_coco", "yolov4_tiny_voc",
    "yolov4_voc",
]
