"""The port's evaluation against the JAX package's, on the CPU: VOC mAP
(exactly equal: both are the same numpy), the oracle raw map through the
port's decode and NMS (mAP 1.0), ``evaluate`` and ``evaluate_recall`` on
the fixture task with params carried across by ``models/convert.py``, the
eval CLI and ``prune --sweep --data``.

Tolerances: BITMATCH (fp32, BN unfolded on both sides) detections are the
same set in the same order, scores within 1e-5 relative and boxes within
1e-3 source pixels (fp32 summation order only), and mAP within 1e-6.
FAST (bf16) runs the port's fused input stage against the JAX package's
unfused forward: bf16 roundings differ, near-tie scores reorder, so only
the mAP is compared, within 0.05 absolute (5 points)."""

import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from modelcompression_tpu.cli import eval as jeval_cli
from modelcompression_tpu.cli import prune as jprune_cli
from modelcompression_tpu.core.precision import BITMATCH as J_BITMATCH
from modelcompression_tpu.core.precision import FAST as J_FAST
from modelcompression_tpu.data import fixtures as jfx
from modelcompression_tpu.data import voc as jvoc
from modelcompression_tpu.evaluation import pipeline as jpipe
from modelcompression_tpu.evaluation import recall as jrecall
from modelcompression_tpu.evaluation import voc_map as jmap
from modelcompression_tpu.models import fold_batchnorm as j_fold
from modelcompression_tpu.models import forward_folded as j_forward_folded
from modelcompression_tpu.models import init_params as j_init
from modelcompression_tpu.models import parse_cfg as j_parse
from modelcompression_tpu.models import save_weights as j_save
from modelcompression_tpu_torch.cli import eval as teval_cli
from modelcompression_tpu_torch.cli import prune as tprune_cli
from modelcompression_tpu_torch.core.precision import BITMATCH, FAST
from modelcompression_tpu_torch.data import fixtures as tfx
from modelcompression_tpu_torch.data import voc as tvoc
from modelcompression_tpu_torch.evaluation import (
    batched_per_class_nms, center_to_corners, decode_region,
)
from modelcompression_tpu_torch.evaluation import pipeline as tpipe
from modelcompression_tpu_torch.evaluation import recall as trecall
from modelcompression_tpu_torch.evaluation import voc_map as tmap
from modelcompression_tpu_torch.models import fold_batchnorm as t_fold
from modelcompression_tpu_torch.models import (
    forward_folded as t_forward_folded,
)
from modelcompression_tpu_torch.models import params_from_jax
from modelcompression_tpu_torch.models import parse_cfg as t_parse
from tests.test_eval_pipeline import encode_boxes_to_raw

CLASSES = jfx.FIXTURE_CLASSES


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The models here are tiny; few intra-op threads keep the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- voc_map: equal results on random detection / GT sets --------------

def _random_lists(seed, mod):
    """Per-class detections and GT over 6 images, boxes in ~100 px, a
    third of the detections jittered copies of a GT, some GT difficult,
    one class without GT."""
    rng = np.random.default_rng(seed)
    dets, gts = {}, {}
    for ci, c in enumerate(("a", "b", "c", "nogt")):
        g = []
        if c != "nogt":
            for i in range(int(rng.integers(3, 9))):
                x1, y1 = rng.uniform(0, 80, 2)
                w, h = rng.uniform(4, 60, 2)
                g.append(mod.GroundTruth(f"im{rng.integers(0, 6)}",
                                         (x1, y1, x1 + w, y1 + h),
                                         bool(rng.random() < 0.2)))
        d = []
        for i in range(int(rng.integers(5, 30))):
            if g and rng.random() < 0.4:
                src = g[int(rng.integers(len(g)))]
                box = tuple(float(v) for v in np.asarray(src.box)
                            + rng.normal(0, 4, 4))
                img = src.image_id
            else:
                x1, y1 = rng.uniform(0, 80, 2)
                w, h = rng.uniform(4, 60, 2)
                box = (x1, y1, x1 + w, y1 + h)
                img = f"im{rng.integers(0, 6)}"
            d.append(mod.Detection(img, float(rng.uniform(0.01, 1.0)), box))
        dets[c], gts[c] = d, g
    return dets, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_07", [True, False])
@pytest.mark.parametrize("devkit_iou", [True, False])
@pytest.mark.parametrize("iou", [0.5, 0.75])
def test_mean_ap_equals_jax(seed, use_07, devkit_iou, iou):
    jd, jg = _random_lists(seed, jmap)
    td, tg = _random_lists(seed, tmap)
    want = jmap.mean_ap(jd, jg, iou_thresh=iou, use_07_metric=use_07,
                        devkit_iou=devkit_iou)
    got = tmap.mean_ap(td, tg, iou_thresh=iou, use_07_metric=use_07,
                       devkit_iou=devkit_iou)
    assert got == want
    assert 0.0 < got[0] < 1.0  # a real, non-trivial AP


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("devkit_iou", [True, False])
def test_coco_map_and_area_bands_equal_jax(seed, devkit_iou):
    jd, jg = _random_lists(seed, jmap)
    td, tg = _random_lists(seed, tmap)
    assert tmap.coco_map(td, tg, devkit_iou=devkit_iou) == \
        jmap.coco_map(jd, jg, devkit_iou=devkit_iou)
    assert tmap.coco_map_by_area(td, tg, devkit_iou=devkit_iou) == \
        jmap.coco_map_by_area(jd, jg, devkit_iou=devkit_iou)


def test_voc_ap_equals_jax():
    rng = np.random.default_rng(7)
    for _ in range(5):
        rec = np.sort(rng.uniform(0, 1, 12))
        prec = rng.uniform(0, 1, 12)
        for use_07 in (True, False):
            assert tmap.voc_ap(rec, prec, use_07) == \
                jmap.voc_ap(rec, prec, use_07)


# ---- the oracle raw map through the port's decode and NMS -------------

def test_oracle_raw_map_gives_perfect_map(tmp_path):
    """tests/test_eval_pipeline.py's oracle, through the port: a raw map
    made by inverting the region decode for the fixture's ground truth
    scores mAP 1.0 after the port's decode, NMS and voc_map."""
    spec = t_parse(tfx.tiny_region_cfg(num_classes=3))
    region = spec.region
    data_cfg = tfx.make_fake_voc(str(tmp_path), n_images=6, image_size=416,
                                 seed=3)
    samples = tvoc.load_list_dataset(tvoc.read_data_cfg(data_cfg)["valid"])
    dets = {c: [] for c in CLASSES}
    gts = {c: [] for c in CLASSES}
    for s in samples:
        raw = torch.from_numpy(encode_boxes_to_raw(s.labels, region,
                                                   grid=13))
        boxes, obj, cls = decode_region(raw, region)
        sel, out_scores, valid = (t.numpy() for t in batched_per_class_nms(
            center_to_corners(boxes), obj[..., None] * cls,
            iou_thresh=0.45, score_thresh=0.1, max_out=20))
        for ci, cname in enumerate(CLASSES):
            for k in np.nonzero(valid[0, ci])[0]:
                dets[cname].append(tmap.Detection(
                    s.image_id, float(out_scores[0, ci, k]),
                    tuple(sel[0, ci, k])))
        for cls_id, cx, cy, w, h in s.labels:
            gts[CLASSES[int(cls_id)]].append(tmap.GroundTruth(
                s.image_id, (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)))
    for use_07 in (True, False):
        m, per_class = tmap.mean_ap(dets, gts, use_07_metric=use_07)
        assert m == pytest.approx(1.0), per_class


# ---- evaluate against the JAX package ----------------------------------

@pytest.fixture(scope="module")
def fixture_160(tmp_path_factory):
    """5 images at 160 px (letterboxed by cv2 to the 128 net, as in the
    JAX package's own evaluate tests), a tiny region model and its
    random JAX params."""
    root = tmp_path_factory.mktemp("eval160")
    data = jfx.make_fake_voc(str(root), n_images=5, image_size=160, seed=1)
    text = jfx.tiny_region_cfg(num_classes=3, width=128, height=128)
    jspec = j_parse(text)
    npp = jax.tree.map(np.asarray, j_init(jspec, jax.random.key(0)))
    return data, text, jspec, npp


def _samples(data):
    cfg = jvoc.read_data_cfg(data)
    return (jvoc.load_list_dataset(cfg["valid"]),
            tvoc.load_list_dataset(cfg["valid"]))


def _both_configs(precision, **kw):
    jprec = {"bitmatch": J_BITMATCH, "fast": J_FAST}[precision.name]
    return (jpipe.EvalConfig(precision=jprec, **kw),
            tpipe.EvalConfig(precision=precision, device="cpu", **kw))


def _assert_same_detections(got, want):
    assert got.keys() == want.keys()
    n = 0
    for c in want:
        g, w = got[c], want[c]
        assert [d.image_id for d in g] == [d.image_id for d in w], c
        if not w:
            continue
        np.testing.assert_allclose([d.score for d in g],
                                   [d.score for d in w], rtol=1e-5, atol=0)
        np.testing.assert_allclose([d.box for d in g], [d.box for d in w],
                                   atol=1e-3, rtol=0)
        n += len(w)
    assert n > 0  # the comparison saw real detections


@pytest.mark.parametrize("kw", [
    {},
    {"map_iou": 0.1, "coco_map": True},
    {"map_iou": 0.2, "use_07_metric": False, "devkit_iou": False},
])
def test_evaluate_bitmatch_matches_jax(fixture_160, kw):
    """fp32, BN unfolded, batch 2 over 5 images (a padded last batch):
    the same detections, mAP within 1e-6, the same NMS statistics (the
    padding rows excluded from both)."""
    data, text, jspec, npp = fixture_160
    js, ts = _samples(data)
    jc, tc = _both_configs(BITMATCH, batch_size=2, max_detections=10,
                           fold_bn=False, **kw)
    want = jpipe.evaluate(npp, jspec, js, CLASSES, jc)
    got = tpipe.evaluate(params_from_jax(npp), t_parse(text), ts, CLASSES,
                         tc)
    assert got.n_images == want.n_images == 5
    _assert_same_detections(got.detections, want.detections)
    assert abs(got.map50 - want.map50) <= 1e-6
    assert got.per_class_ap.keys() == want.per_class_ap.keys()
    for c in want.per_class_ap:
        assert abs(got.per_class_ap[c] - want.per_class_ap[c]) <= 1e-6
    if kw.get("coco_map"):
        assert abs(got.map_coco - want.map_coco) <= 1e-6
        assert got.map_coco_area.keys() == want.map_coco_area.keys()
    for f in ("nms_overflow_frac", "nms_max_candidates",
              "prefilter_max_candidates", "map_iou", "use_07_metric"):
        assert getattr(got, f) == getattr(want, f), f
    line = next(l for l in got.summary().splitlines() if "mAP@" in l
                and "images" in l)
    assert line.split("  [")[0] == next(
        l for l in want.summary().splitlines()
        if "mAP@" in l and "images" in l).split("  [")[0]
    assert got.images_per_sec_steady > 0 and "steady-state" in got.summary()


def test_evaluate_fast_fused_map_matches_jax(fixture_160):
    """FAST with the port's fused input stage (its plain version on the
    CPU) against the JAX package's unfused FAST forward, at map_iou 0.1
    (random weights score 0 at 0.5): the first batch's raw head maps within
    2 bf16 ulps of their largest magnitude, every JAX detection found in
    the port's (same image, score within 2% rel, box within 1 px) and mAP
    within 10% relative of a nonzero JAX mAP."""
    data, text, jspec, npp = fixture_160
    js, ts = _samples(data)
    jc, tc = _both_configs(FAST, batch_size=2, max_detections=10,
                           map_iou=0.1)
    assert tc.fuse_input_stage and tc.fold_bn
    tspec = t_parse(text)
    canvases = tpipe._prep_batch(ts[:2], 128, 128, True)[0]
    jraw = np.asarray(j_forward_folded(
        j_fold(npp, jspec),
        jax.numpy.asarray(canvases.astype(np.float32) / 255.0,
                          jax.numpy.bfloat16),
        jspec, J_FAST).astype(jax.numpy.float32))
    traw = t_forward_folded(
        t_fold(params_from_jax(npp), tspec),
        torch.as_tensor(canvases).to(torch.bfloat16) / 255.0, tspec, FAST,
        fuse_input_stage=True).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jraw).max())) - 7)
    assert np.abs(traw - jraw).max() <= 2 * ulp
    want = jpipe.evaluate(npp, jspec, js, CLASSES, jc)
    got = tpipe.evaluate(params_from_jax(npp), tspec, ts, CLASSES, tc)
    for c in CLASSES:
        assert len(got.detections[c]) == len(want.detections[c]), c
        for w in want.detections[c]:
            assert any(g.image_id == w.image_id
                       and abs(g.score - w.score) <= 0.02 * w.score
                       and np.abs(np.subtract(g.box, w.box)).max() <= 1.0
                       for g in got.detections[c]), (c, w)
    assert want.map50 > 0.0 and got.map50 > 0.0
    assert abs(got.map50 - want.map50) <= 0.1 * want.map50


def test_padding_rows_leave_the_statistics_alone(fixture_160):
    """5 images at batch 2 and at batch 8 (one batch, 3 padding rows) and
    batch 5 (no padding): the same detections and counters."""
    data, text, _, npp = fixture_160
    _, ts = _samples(data)
    runs = [tpipe.evaluate(params_from_jax(npp), t_parse(text), ts, CLASSES,
                           tpipe.EvalConfig(batch_size=b, max_detections=10,
                                            nms_prefilter=40,
                                            precision=BITMATCH,
                                            device="cpu"))
            for b in (2, 8, 5)]
    for r in runs[1:]:
        _assert_same_detections(r.detections, runs[0].detections)
        for f in ("n_images", "nms_overflow_frac", "nms_max_candidates",
                  "prefilter_overflow_frac", "prefilter_max_candidates"):
            assert getattr(r, f) == getattr(runs[0], f), f
    assert runs[0].prefilter_overflow_frac > 0  # the counter saw overflow


def test_evaluate_recall_matches_jax(fixture_160):
    data, text, jspec, npp = fixture_160
    js, ts = _samples(data)
    jc, tc = _both_configs(BITMATCH, batch_size=2, max_detections=20,
                           fold_bn=False)
    for recall_iou in (0.5, 0.05):
        want = jrecall.evaluate_recall(npp, jspec, js, jc,
                                       recall_iou=recall_iou)
        got = trecall.evaluate_recall(params_from_jax(npp), t_parse(text),
                                      ts, tc, recall_iou=recall_iou)
        for f in ("n_images", "n_gt", "n_correct", "n_proposals",
                  "max_candidates"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.recall == want.recall
        assert abs(got.avg_iou - want.avg_iou) <= 1e-5
        assert abs(got.proposals_per_image - want.proposals_per_image) \
            <= 1e-9
    assert want.n_correct > 0
    assert got.summary().splitlines()[0] == want.summary().splitlines()[0]


def test_416_fixture_evaluates_without_cv2(tmp_path, monkeypatch):
    """Images at the network size: the host letterbox is a copy and PNG
    decodes through the port's codec, so evaluate runs with cv2 blocked
    and gives what it gives with cv2 present, and what the JAX package
    (cv2.imread + cv2.resize) gives."""
    data = tfx.make_fake_voc(str(tmp_path), n_images=3, image_size=416,
                             seed=6)
    text = tfx.tiny_region_cfg(num_classes=3, width=416, height=416)
    jspec = j_parse(text)
    npp = jax.tree.map(np.asarray, j_init(jspec, jax.random.key(1)))
    js, ts = _samples(data)
    jc, tc = _both_configs(BITMATCH, batch_size=2, max_detections=10,
                           fold_bn=False, map_iou=0.1)
    with_cv2 = tpipe.evaluate(params_from_jax(npp), t_parse(text), ts,
                              CLASSES, tc)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        without = tpipe.evaluate(params_from_jax(npp), t_parse(text), ts,
                                 CLASSES, tc)
    assert without.detections == with_cv2.detections
    assert without.map50 == with_cv2.map50
    want = jpipe.evaluate(npp, jspec, js, CLASSES, jc)
    _assert_same_detections(without.detections, want.detections)
    assert abs(without.map50 - want.map50) <= 1e-6


def test_dump_detections_writes_what_jax_writes(tmp_path):
    jd, _ = _random_lists(4, jmap)
    td, _ = _random_lists(4, tmap)
    kw = dict(map50=0.0, per_class_ap={}, n_images=6, images_per_sec=1.0,
              use_07_metric=True)
    jpipe.dump_detections(jpipe.EvalResult(detections=jd, **kw),
                          str(tmp_path / "j"))
    tpipe.dump_detections(tpipe.EvalResult(detections=td, **kw),
                          str(tmp_path / "t"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 4
    for n in names:
        assert (tmp_path / "t" / n).read_text() == \
            (tmp_path / "j" / n).read_text()


def test_evaluate_rules(fixture_160, monkeypatch):
    data, text, _, npp = fixture_160
    _, ts = _samples(data)
    spec, params = t_parse(text), params_from_jax(npp)
    # mesh= runs data-parallel now (tests/test_torch_parallel.py); a batch
    # the mesh does not divide is the JAX error
    from modelcompression_tpu_torch.core.mesh import MeshConfig, make_mesh
    with pytest.raises(ValueError, match="eval batch 8 not divisible by "
                                         "data-parallel size 3"):
        tpipe.evaluate(params, spec, ts, CLASSES,
                       tpipe.EvalConfig(device="cpu"),
                       mesh=make_mesh(MeshConfig(data=3), device="cpu"))
    with pytest.raises(ValueError, match="map_iou"):
        tpipe.EvalConfig(device="cpu", map_iou=1.5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.evaluate(params, spec, ts, CLASSES, tpipe.EvalConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        trecall.evaluate_recall(params, spec, ts, tpipe.EvalConfig())


def test_evaluate_runs_the_fused_input_stage(fixture_160, monkeypatch):
    """FAST goes through fused_conv1_pool once per batch; BITMATCH with
    fold_bn=False never does."""
    from modelcompression_tpu_torch.ops import input_stage as tis
    calls = []
    real = tis.fused_conv1_pool

    def spy(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)
    monkeypatch.setattr(tis, "fused_conv1_pool", spy)
    data, text, _, npp = fixture_160
    _, ts = _samples(data)
    for prec, fold, want in ((FAST, True, [2, 2, 2]),
                             (BITMATCH, False, [])):
        calls.clear()
        tpipe.evaluate(params_from_jax(npp), t_parse(text), ts, CLASSES,
                       tpipe.EvalConfig(batch_size=2, precision=prec,
                                        fold_bn=fold, device="cpu"))
        assert calls == want


# ---- the eval CLI and prune --sweep --data -----------------------------

@pytest.fixture(scope="module")
def cli_model(tmp_path_factory):
    """A tiny region model at 96 px written as .weights by the JAX
    package, and a 5-image fixture at 96 px."""
    tmp = tmp_path_factory.mktemp("eval_cli")
    text = jfx.tiny_region_cfg(num_classes=3, width=96, height=96)
    cfg = str(tmp / "net.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    spec = j_parse(text)
    weights = str(tmp / "w.weights")
    j_save(weights, spec, jax.tree.map(
        np.asarray, j_init(spec, jax.random.key(2))), seen=0)
    data = jfx.make_fake_voc(str(tmp / "d"), n_images=5, image_size=96,
                             seed=2)
    return cfg, weights, data


_MAP_LINE = re.compile(r"^mAP@[0-9.]+ \([^)]*\): [0-9.]+", re.M)


@pytest.mark.parametrize("extra", [
    ["--precision", "bitmatch", "--map-iou", "0.1"],
    ["--precision", "bitmatch", "--metric", "continuous", "--map-coco",
     "--map-iou", "0.2", "--continuous-iou"],
    # the NMS variants (rejected with exit 2 before they were ported)
    ["--precision", "bitmatch", "--map-iou", "0.1", "--exact-nms"],
    ["--precision", "bitmatch", "--map-iou", "0.1", "--soft-nms",
     "linear"],
    ["--precision", "bitmatch", "--map-iou", "0.1", "--diou-nms"],
    ["--precision", "bitmatch", "--map-iou", "0.1", "--nms-prefilter",
     "64", "--nms-prefilter-impl", "bisect"],
])
def test_eval_cli_map_line_equals_jax(cli_model, capsys, tmp_path, extra):
    """The mAP line, the COCO line and the NMS lines (overflow and
    exactness report) equal the JAX CLI's."""
    cfg, weights, data = cli_model
    argv = ["--cfg", cfg, "--weights", weights, "--data", data,
            "--batch", "2", *extra]
    assert jeval_cli.main(argv + ["--dump-dir", str(tmp_path / "j")]) == 0
    want = capsys.readouterr().out
    assert teval_cli.main(argv + ["--device", "cpu", "--dump-dir",
                                  str(tmp_path / "t")]) == 0
    got = capsys.readouterr().out
    assert _MAP_LINE.findall(got) == _MAP_LINE.findall(want)
    assert len(_MAP_LINE.findall(got)) == 1
    for head in ("mAP@[", "NMS:"):
        lines = [l for l in want.splitlines() if l.startswith(head)]
        assert lines == [l for l in got.splitlines() if l.startswith(head)]
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))


def test_eval_cli_recall_equals_jax(cli_model, capsys):
    cfg, weights, data = cli_model
    argv = ["--cfg", cfg, "--weights", weights, "--data", data,
            "--batch", "2", "--recall", "--conf", "0.001", "--nms", "0.4",
            "--precision", "bitmatch"]
    assert jeval_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert teval_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "RPs/Img" in got
    assert [l for l in got.splitlines() if l.startswith("recall@")] == \
        [l for l in want.splitlines() if l.startswith("recall@")]


# the flags this test refused, naming their ROADMAP items until they were
# ported: the weight-sharing flags (item 6e), --dp (item 7) and --tp (item
# 11). Each now runs; the test keeps its name. {tmp} is the test's
# tmp_path.
NOT_PORTED = {
    "cmodel": ["--cmodel", "{tmp}/j.npz"],  # in place of --weights
    "cluster_bits": ["--cluster-bits", "4"],
    "save_cmodel": ["--cluster-bits", "4", "--save-cmodel", "{tmp}/c.npz"],
    "pack": ["--cluster-bits", "4", "--save-cmodel", "{tmp}/c.npz",
             "--pack"],
    "dp": ["--dp", "2"],
    "tp": ["--tp", "2"],
}


def _jax_cmodel(cfg, weights, bits=4):
    from modelcompression_tpu.compress import codebook as jcb
    from modelcompression_tpu.models import load_weights as j_load
    with open(cfg) as f:
        jspec = j_parse(f.read())
    params, _ = j_load(weights, jspec)
    return jcb, jspec, jcb.cluster_network(
        jax.tree.map(np.asarray, params), jspec, bits=bits)


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_eval_cli_not_ported_flags_exit_2_naming_their_item(cli_model,
                                                            capsys, tmp_path,
                                                            case):
    """--dp 2 evaluates over two CPU shards, and --tp 2 on a (1, 2) mesh
    (the model replicated over its model axis), each with the
    single-device run's mAP line, and the JAX CLI's --dp 2 / --tp 2 (its
    forced CPU devices) prints the same. The weight-sharing flags run
    (BITMATCH): --cluster-bits prints the JAX CLI's mAP; --save-cmodel
    (packed or not) writes an artifact the JAX package loads to its own
    clustering; --cmodel serves a JAX-written artifact with the summary of
    --cluster-bits on the same weights."""
    cfg, weights, data = cli_model
    extra = [a.format(tmp=tmp_path) for a in NOT_PORTED[case]]
    source = [] if case == "cmodel" else ["--weights", weights]
    argv = ["--cfg", cfg, *source, "--data", data, "--device", "cpu", *extra]
    bm = ["--precision", "bitmatch", "--map-iou", "0.1", "--batch", "2"]
    if case in ("dp", "tp"):
        lines = []
        for main, a in ((teval_cli.main, argv + bm),
                        (teval_cli.main, argv[:-2] + bm),
                        (jeval_cli.main, argv[:-4] + extra + bm)):
            assert main(a) == 0
            lines.append(_MAP_LINE.findall(capsys.readouterr().out))
        assert lines[0] == lines[1] and len(lines[0]) == 1
        (g,), (w,) = lines[0], lines[2]
        assert abs(float(g.split()[-1]) - float(w.split()[-1])) <= 1e-6
        if case == "tp":  # the data axis is 1: any batch divides it
            return
        assert teval_cli.main(argv + bm[:-1] + ["3"]) == 2
        assert "--batch 3 must be divisible by --dp 2" in \
            capsys.readouterr().err
        return
    jcb, jspec, jcm = _jax_cmodel(cfg, weights)
    if case == "cmodel":
        jcb.save_cmodel(str(tmp_path / "j.npz"), jcm, jspec)
    assert teval_cli.main(argv + bm) == 0
    got = capsys.readouterr()
    (g,) = _MAP_LINE.findall(got.out)
    if case == "cmodel":
        assert teval_cli.main(["--cfg", cfg, "--weights", weights, "--data",
                               data, "--device", "cpu", "--cluster-bits",
                               "4", *bm]) == 0
        assert _MAP_LINE.findall(capsys.readouterr().out) == [g]
        return
    assert "weight sharing: 4-bit codebooks" in got.err
    if case == "cluster_bits":
        assert jeval_cli.main(["--cfg", cfg, "--weights", weights, "--data",
                               data, "--cluster-bits", "4", *bm]) == 0
        (w,) = _MAP_LINE.findall(capsys.readouterr().out)
        assert abs(float(g.split()[-1]) - float(w.split()[-1])) <= 1e-6
        return
    assert ("bits/weight" in got.err) == (case == "pack")
    loaded, _ = jcb.load_cmodel(str(tmp_path / "c.npz"), spec=jspec)
    want = jcb.reconstruct(jcm)
    for k, p in want.items():
        for n, a in p.items():
            assert np.array_equal(np.asarray(loaded[k][n]), np.asarray(a))


@pytest.mark.parametrize("extra, message", [
    (["--exact-nms", "--nms-prefilter", "8"], "mutually exclusive"),
    (["--soft-nms", "linear", "--diou-nms"], "mutually exclusive"),
    (["--qmodel", "q", "--int8"], "pick one direction"),
    (["--save-qmodel", "q"], "requires --int8"),
    (["--pack"], "--pack entropy-codes"),
    (["--cmodel", "c"], "exactly one of --weights"),
    (["--recall", "--dump-dir", "x"], "objectness-only"),
    (["--recall", "--recall-iou", "1.5"], "--recall-iou must be"),
])
def test_eval_cli_usage_errors_worded_as_jax(cli_model, capsys, extra,
                                             message):
    cfg, weights, data = cli_model
    for main, dev in ((jeval_cli.main, []),
                      (teval_cli.main, ["--device", "cpu"])):
        assert main(["--cfg", cfg, "--weights", weights, "--data", data,
                     *extra, *dev]) == 2
        assert message in capsys.readouterr().err


def test_eval_cli_default_device_is_cuda(cli_model, monkeypatch):
    cfg, weights, data = cli_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        teval_cli.main(["--cfg", cfg, "--weights", weights, "--data", data])


def test_prune_sweep_data_map_column_equals_jax(cli_model, capsys,
                                                tmp_path):
    """``prune --sweep 0.5 --data``: the same per-point line and table as
    the JAX CLI (mAP@50 of FAST evaluation at --batch), the same
    weights."""
    cfg, weights, data = cli_model
    outs = {}
    for side, main, dev in (("jax", jprune_cli.main, []),
                            ("torch", tprune_cli.main,
                             ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        assert main(["--cfg", cfg, "--weights", weights, "--mode",
                     "magnitude", "--sweep", "0.5", "--data", data,
                     "--batch", "2", "--out", str(d / "out.weights"),
                     *dev]) == 0
        outs[side] = capsys.readouterr().out.replace(str(d), "<dir>")
    table = [l for l in outs["torch"].splitlines()
             if "mAP@50" in l or re.match(r"^\s+\d+%", l)]
    assert len(table) == 3 and "mAP@50" in table[1]
    assert table == [l for l in outs["jax"].splitlines()
                     if "mAP@50" in l or re.match(r"^\s+\d+%", l)]
    assert (tmp_path / "torch" / "out_50.weights").read_bytes() == \
        (tmp_path / "jax" / "out_50.weights").read_bytes()
