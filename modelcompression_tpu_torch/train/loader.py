"""Host-side batch feeding with prefetch, port of
``modelcompression_tpu/train/loader.py``.

The loader produces fixed-shape (uint8 images, padded targets) batches:
images letterboxed (or stretched) to the network size on the host, GT
boxes remapped to the letterboxed frame. A background thread keeps
``prefetch`` batches ahead and copies them to the device
(``data/streaming.prefetch_to_device``), so the step never waits on image
decode. The letterbox needs no cv2 for images already at the network size
(as eval); the stretch resize always imports it.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from modelcompression_tpu_torch.core.device import resolve_device
from modelcompression_tpu_torch.data.preprocess import letterbox_host
from modelcompression_tpu_torch.data.streaming import prefetch_to_device
from modelcompression_tpu_torch.data.voc import (
    Sample, import_cv2, pad_labels,
)


def load_sample(sample: Sample, net_h: int, net_w: int, letterbox: bool,
                max_boxes: int) -> Tuple[np.ndarray, np.ndarray]:
    img = sample.load_image()
    h, w = img.shape[:2]
    labels = sample.labels.copy()
    if letterbox:
        canvas, r, px, py = letterbox_host(img, net_h, net_w)
        if len(labels):
            labels[:, 1] = (labels[:, 1] * w * r + px) / net_w
            labels[:, 2] = (labels[:, 2] * h * r + py) / net_h
            labels[:, 3] = labels[:, 3] * w * r / net_w
            labels[:, 4] = labels[:, 4] * h * r / net_h
    else:
        cv2 = import_cv2(f"the stretch resize of {sample.image_path}")
        canvas = cv2.resize(img, (net_w, net_h),
                            interpolation=cv2.INTER_LINEAR)
    return canvas, pad_labels(labels, max_boxes)


class BatchLoader:
    """Shuffled, prefetching batch iterator over Samples; yields (uint8
    images (B,H,W,3), float32 targets (B,max_boxes,5)) as tensors on
    ``device`` (default cuda, through the port's device rule).

    ``multi_scale=(lo, hi)`` enables Darknet's random-resize training
    (cfg ``[region] random=1``): every ``resize_every`` batches the network
    size is redrawn from the multiples of 32 in [lo, hi]."""

    def __init__(self, samples: Sequence[Sample], batch_size: int,
                 net_h: int, net_w: int, max_boxes: int = 30,
                 letterbox: bool = True, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2, drop_last: bool = True,
                 multi_scale: Tuple[int, int] | None = None,
                 resize_every: int = 10, device=None):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.net_h, self.net_w = net_h, net_w
        self.max_boxes = max_boxes
        self.letterbox = letterbox
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.device = resolve_device(device)
        if multi_scale is not None:
            lo, hi = multi_scale
            self.scales = [s for s in range(lo, hi + 1) if s % 32 == 0]
            if not self.scales:
                raise ValueError(f"no multiples of 32 in {multi_scale}")
        else:
            self.scales = None
        self.resize_every = resize_every
        self._batch_counter = 0
        self._cur_size = (net_h, net_w)
        self._skip = 0
        if not self.samples:
            raise ValueError("empty dataset")

    def skip_batches(self, n: int) -> None:
        """Fast-forward by ``n`` batches without touching disk: the skipped
        batches consume their shuffle order and multi-scale draws, so the
        stream stays identical to an uninterrupted run's (the resume
        contract: a run restored at step k sees the batch k+1 an
        uninterrupted run would)."""
        if n < 0:
            raise ValueError(f"cannot skip {n} batches")
        self._skip += n

    def batches_per_epoch(self) -> int:
        n = len(self.samples)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _epoch_order(self) -> List[int]:
        idx = np.arange(len(self.samples))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx.tolist()

    def _next_size(self) -> Tuple[int, int]:
        if self.scales is not None \
                and self._batch_counter % self.resize_every == 0:
            s = int(self.rng.choice(self.scales))
            self._cur_size = (s, s)
        self._batch_counter += 1
        return self._cur_size

    def _make_batch(self, indices: List[int]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        bs = self.batch_size
        net_h, net_w = self._next_size()
        images = np.zeros((bs, net_h, net_w, 3), np.uint8)
        targets = np.zeros((bs, self.max_boxes, 5), np.float32)
        for slot, si in enumerate(indices):
            img, t = load_sample(self.samples[si], net_h, net_w,
                                 self.letterbox, self.max_boxes)
            images[slot] = img
            targets[slot] = t
        return images, targets

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One pass over the data with background prefetch to the device
        (producer exceptions re-raise here)."""
        order = self._epoch_order()
        chunks = [order[i:i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            chunks = [c for c in chunks if len(c) == self.batch_size]
        else:
            # pad the tail by repeating from the front
            for c in chunks:
                while len(c) < self.batch_size:
                    c.append(order[0])

        def gen():
            for c in chunks:
                if self._skip > 0:
                    # consume this batch's multi-scale draw, skip the IO
                    self._skip -= 1
                    self._next_size()
                    continue
                yield self._make_batch(c)

        yield from prefetch_to_device(gen(), depth=self.prefetch,
                                      device=self.device)

    def __iter__(self):
        while True:
            yield from self.epoch()
