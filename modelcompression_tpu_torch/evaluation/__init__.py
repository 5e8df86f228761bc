from modelcompression_tpu_torch.evaluation.decode import (
    center_to_corners, corners_to_image, decode_heads, decode_region,
    decode_yolo,
)
from modelcompression_tpu_torch.evaluation.nms import (
    batched_bisect_prefilter, batched_per_class_nms,
    batched_per_class_nms_padded, batched_per_class_nms_prefiltered,
    batched_per_class_soft_nms, diou_penalty, iou_corners, nms_padded,
    nms_topk, pairwise_diou_penalty, pairwise_iou, per_class_nms,
    per_class_nms_padded, per_class_nms_prefiltered, per_class_soft_nms,
    soft_nms_topk,
)
from modelcompression_tpu_torch.evaluation.voc_map import (
    COCO_AREA_RANGES, Detection, GroundTruth, class_ap, coco_map,
    coco_map_by_area, mean_ap, voc_ap,
)
from modelcompression_tpu_torch.evaluation.pipeline import (
    EvalConfig, EvalResult, dump_detections, evaluate, make_eval_step,
)
from modelcompression_tpu_torch.evaluation.recall import (
    RecallResult, evaluate_recall, make_recall_step,
)

__all__ = ["center_to_corners", "corners_to_image", "decode_heads",
           "decode_region", "decode_yolo", "batched_bisect_prefilter",
           "batched_per_class_nms", "batched_per_class_nms_padded",
           "batched_per_class_nms_prefiltered",
           "batched_per_class_soft_nms", "diou_penalty", "iou_corners",
           "nms_padded", "nms_topk", "pairwise_diou_penalty",
           "pairwise_iou", "per_class_nms", "per_class_nms_padded",
           "per_class_nms_prefiltered", "per_class_soft_nms",
           "soft_nms_topk",
           "COCO_AREA_RANGES", "Detection", "GroundTruth", "class_ap",
           "coco_map", "coco_map_by_area", "mean_ap", "voc_ap",
           "EvalConfig", "EvalResult", "dump_detections", "evaluate",
           "make_eval_step",
           "RecallResult", "evaluate_recall", "make_recall_step"]
