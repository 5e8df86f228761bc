"""The port's training stack learns, mirroring the first test of
tests/test_learnability.py: on the learnable fixture task (coloured boxes,
class == colour; 16 images at 96x96, the tiny region cfg) 600 steps of the
train step at batch 8, FAST precision, augment off, drop the loss more
than 5x and reach mAP@50 >= 0.8 under the port's own evaluate. The JAX
package's seed does not carry over (other generators), so the port's
init and draws are its own. About 40-60 s on the CPU."""

import pytest
import torch

from modelcompression_tpu_torch.core.precision import FAST
from modelcompression_tpu_torch.data.fixtures import (
    FIXTURE_CLASSES, make_fake_voc, tiny_region_cfg,
)
from modelcompression_tpu_torch.data.voc import (
    load_list_dataset, read_data_cfg,
)
from modelcompression_tpu_torch.evaluation import EvalConfig, evaluate
from modelcompression_tpu_torch.models import init_params, parse_cfg
from modelcompression_tpu_torch.train import (
    BatchLoader, TrainConfig, TrainState, make_optimizer, make_train_step,
)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_fixture_task_learns_to_high_map(tmp_path):
    data = make_fake_voc(str(tmp_path), n_images=16, image_size=96, seed=0)
    samples = load_list_dataset(read_data_cfg(data)["valid"])
    spec = parse_cfg(tiny_region_cfg(num_classes=3, width=96, height=96))
    config = TrainConfig.from_spec(spec, augment_flip=False,
                                   augment_jitter=0.0, max_boxes=8,
                                   precision=FAST)
    loader = BatchLoader(samples, batch_size=8, net_h=96, net_w=96,
                         max_boxes=8, seed=1, device="cpu")
    state = TrainState.create(init_params(spec, seed=0),
                              make_optimizer(config),
                              torch.Generator().manual_seed(1))
    step = make_train_step(spec, config)
    it = iter(loader)
    for i in range(600):
        state, m = step(state, *next(it))
        if i == 0:
            first = float(m["loss"])
    last = float(m["loss"])
    assert last < first / 5, (first, last)
    res = evaluate(state["params"], spec, samples, FIXTURE_CLASSES,
                   EvalConfig(batch_size=8, conf_thresh=0.005,
                              max_detections=20, device="cpu"))
    assert res.map50 >= 0.8, res.summary()
