from modelcompression_tpu_torch.train.distill import (
    DistillPlan, detection_distill_loss, distill_loss, make_distill_plan,
)
from modelcompression_tpu_torch.train.region_loss import (
    RegionLossMetrics, region_loss,
)
from modelcompression_tpu_torch.train.yolo_loss import detection_loss
from modelcompression_tpu_torch.train.train_step import (
    TrainConfig, TrainState, augment_batch, darknet_lr_schedule,
    make_optimizer, make_train_step, merge_params, split_trainable,
)
from modelcompression_tpu_torch.train.loader import BatchLoader, load_sample
from modelcompression_tpu_torch.train.loop import (
    IterativeRound, iterative_prune_finetune, train,
)

__all__ = [
    "DistillPlan", "detection_distill_loss", "distill_loss",
    "make_distill_plan",
    "RegionLossMetrics", "region_loss", "detection_loss",
    "TrainConfig", "TrainState", "augment_batch", "darknet_lr_schedule",
    "make_optimizer", "make_train_step", "merge_params", "split_trainable",
    "BatchLoader", "load_sample",
    "IterativeRound", "iterative_prune_finetune", "train",
]
