from modelcompression_tpu_torch.data.preprocess import (
    GRAY, letterbox_device, letterbox_host, normalize, resize_host,
    stretch_resize_device,
)
from modelcompression_tpu_torch.data.coco import load_coco_json
from modelcompression_tpu_torch.data.voc import (
    Sample, VOC_CLASSES, load_list_dataset, load_voc_devkit, pad_labels,
    parse_voc_xml, read_data_cfg, read_names,
)
from modelcompression_tpu_torch.data.streaming import (
    prefetch_to_device, to_device,
)
from modelcompression_tpu_torch.data.fixtures import (
    FIXTURE_CLASSES, make_fake_coco, make_fake_voc, make_fake_voc_devkit,
    tiny_region_cfg,
)

__all__ = ["GRAY", "letterbox_device", "letterbox_host", "normalize",
           "resize_host", "stretch_resize_device", "load_coco_json",
           "Sample", "VOC_CLASSES", "load_list_dataset", "load_voc_devkit",
           "pad_labels", "parse_voc_xml", "read_data_cfg", "read_names",
           "prefetch_to_device", "to_device", "FIXTURE_CLASSES",
           "make_fake_coco", "make_fake_voc", "make_fake_voc_devkit",
           "tiny_region_cfg"]
