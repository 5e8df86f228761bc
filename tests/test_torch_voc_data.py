"""The port's data side against the JAX package's: the PNG codec, the
dataset loaders (list format, devkit XML, COCO json), the fixture writers,
the host letterbox and the host -> device prefetch. Loaders and writers
are compared exactly: the same label/XML/JSON text, equal ``Sample``
fields and pixel-equal images (read with cv2 here)."""

import os
import sys
import time

import cv2
import numpy as np
import pytest
import torch

from modelcompression_tpu.data import coco as jcoco
from modelcompression_tpu.data import fixtures as jfx
from modelcompression_tpu.data import preprocess as jpre
from modelcompression_tpu.data import voc as jvoc
from modelcompression_tpu_torch.data import coco as tcoco
from modelcompression_tpu_torch.data import fixtures as tfx
from modelcompression_tpu_torch.data import png
from modelcompression_tpu_torch.data import preprocess as tpre
from modelcompression_tpu_torch.data import voc as tvoc
from modelcompression_tpu_torch.data.streaming import prefetch_to_device


@pytest.fixture
def no_cv2(monkeypatch):
    """cv2 blocked: ``import cv2`` raises ImportError."""
    monkeypatch.setitem(sys.modules, "cv2", None)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_samples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.image_id == w.image_id
        assert os.path.basename(g.image_path) == \
            os.path.basename(w.image_path)
        np.testing.assert_array_equal(g.labels, w.labels)
        assert g.labels.dtype == w.labels.dtype
        if w.difficult is None:
            assert g.difficult is None
        else:
            np.testing.assert_array_equal(g.difficult, w.difficult)


# ---- PNG codec ----------------------------------------------------------

@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("shape", [(7, 5), (9, 6, 3), (4, 11, 4), (1, 1, 3)])
def test_png_roundtrip(tmp_path, shape, filter_type):
    img = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, img, filter_type)
    np.testing.assert_array_equal(png.read_png(path), img)
    # cv2 reads the port's files as written (cv2 gives BGR)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        want = want[:, :, [2, 1, 0, 3][:img.shape[2]]]
    np.testing.assert_array_equal(want, img)


def _smooth_image(rng, shape):
    """Gradients plus noise under a black top row: libpng's adaptive
    filter choice then uses every row filter (0-4), which the test
    asserts."""
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = (3 * xx + 5 * yy)[..., None] + rng.integers(0, 40, shape[:2] + (
        shape[2] if len(shape) == 3 else 1,))
    img = (base % 256).astype(np.uint8)
    img[0] = 0
    return img[..., 0] if len(shape) == 2 else img


@pytest.mark.parametrize("shape", [(40, 33), (40, 33, 3), (40, 33, 4)])
def test_png_decodes_cv2_files_like_cv2(tmp_path, shape):
    """cv2-written PNGs (zlib level 9, adaptive filters) decode to the
    pixels cv2.imread returns: IMREAD_COLOR replicates gray and drops
    alpha, then BGR -> RGB as ``Sample.load_image`` does."""
    img = _smooth_image(np.random.default_rng(1), shape)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    with open(path, "rb") as f:
        data = f.read()
    import zlib
    raw = []
    pos = 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            raw.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    ch = 1 if len(shape) == 2 else shape[2]
    rows = np.frombuffer(zlib.decompress(b"".join(raw)), np.uint8).reshape(
        shape[0], 1 + shape[1] * ch)
    assert set(rows[:, 0].tolist()) == {0, 1, 2, 3, 4}
    got = tvoc.Sample(path, "x", np.zeros((0, 5), np.float32)).load_image()
    np.testing.assert_array_equal(got,
                                  cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])


def test_png_rejects_what_it_does_not_decode(tmp_path):
    good = png.encode_png(np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + good[6:])
    bad_crc = bytearray(good)
    bad_crc[30] ^= 0xFF  # inside the IHDR chunk
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(bad_crc))
    path = str(tmp_path / "p16.png")
    cv2.imwrite(path, np.zeros((3, 3), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(path)


def test_png_kinds_the_codec_does_not_decode_go_to_cv2(tmp_path,
                                                       monkeypatch):
    """A 16-bit PNG loads through cv2, as in the JAX package; without cv2
    the error names cv2, the file and what the codec found."""
    img = np.random.default_rng(2).integers(0, 65536, (5, 7, 3), np.uint16)
    path = str(tmp_path / "p16.png")
    cv2.imwrite(path, img)
    s = tvoc.Sample(path, "p16", np.zeros((0, 5), np.float32))
    np.testing.assert_array_equal(
        s.load_image(), cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError,
                       match=r"p16\.png \(PNG bit depth 16.*cv2"):
        s.load_image()


# ---- loaders and fixture writers --------------------------------------

def test_make_fake_voc_matches_jax_without_cv2(tmp_path, monkeypatch):
    """The list-format fixture: same labels, lists and names text, and
    pixel-equal PNGs; the port writes and loads it with cv2 blocked."""
    want = jfx.make_fake_voc(str(tmp_path / "j"), n_images=4,
                             image_size=48, seed=5)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        got = tfx.make_fake_voc(str(tmp_path / "t"), n_images=4,
                                image_size=48, seed=5)
        samples = tvoc.load_list_dataset(tvoc.read_data_cfg(got)["valid"])
        images = [s.load_image() for s in samples]
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    for rel in _tree(tmp_path / "j"):
        if rel.endswith(".txt") or rel.endswith("names.list"):
            assert (tmp_path / "t" / rel).read_text() == \
                (tmp_path / "j" / rel).read_text()
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / "t" / rel)),
                cv2.imread(str(tmp_path / "j" / rel)))
    assert tvoc.read_data_cfg(got).keys() == jvoc.read_data_cfg(want).keys()
    jsamples = jvoc.load_list_dataset(jvoc.read_data_cfg(want)["valid"])
    _assert_same_samples(samples, jsamples)
    _assert_same_samples(  # the port's loader on the JAX-written tree
        tvoc.load_list_dataset(tvoc.read_data_cfg(want)["valid"]), jsamples)
    for img, s in zip(images, jsamples):
        np.testing.assert_array_equal(img, s.load_image())


def test_devkit_fixture_and_loader_match_jax(tmp_path):
    jroot = jfx.make_fake_voc_devkit(str(tmp_path / "j"), n_images=5,
                                     image_size=64, seed=2)
    troot = tfx.make_fake_voc_devkit(str(tmp_path / "t"), n_images=5,
                                     image_size=64, seed=2)
    assert _tree(troot) == _tree(jroot)
    for rel in _tree(jroot):
        if rel.endswith(".jpg"):
            np.testing.assert_array_equal(cv2.imread(os.path.join(troot, rel)),
                                          cv2.imread(os.path.join(jroot, rel)))
        else:
            with open(os.path.join(troot, rel)) as f, \
                    open(os.path.join(jroot, rel)) as g:
                assert f.read() == g.read()
    for image_set in ("test", "trainval"):
        got = tvoc.load_voc_devkit(troot, image_set=image_set)
        want = jvoc.load_voc_devkit(jroot, image_set=image_set)
        _assert_same_samples(got, want)
        _assert_same_samples(tvoc.load_voc_devkit(jroot, image_set=image_set),
                             want)
        assert any(s.difficult.any() for s in got)
    xml = os.path.join(troot, "VOC2007", "Annotations", "000000.xml")
    for a, b in zip(tvoc.parse_voc_xml(xml), jvoc.parse_voc_xml(xml)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tvoc.pad_labels(got[0].labels, 6),
                                  jvoc.pad_labels(got[0].labels, 6))


def test_coco_fixture_and_loader_match_jax(tmp_path):
    jann = jfx.make_fake_coco(str(tmp_path / "j"), n_images=4,
                              image_size=64, seed=3)
    tann = tfx.make_fake_coco(str(tmp_path / "t"), n_images=4,
                              image_size=64, seed=3)
    with open(tann) as f, open(jann) as g:
        assert f.read() == g.read()
    for name in sorted(os.listdir(tmp_path / "j" / "val2017")):
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "t" / "val2017" / name)),
            cv2.imread(str(tmp_path / "j" / "val2017" / name)))
    got, gnames = tcoco.load_coco_json(tann)
    want, wnames = jcoco.load_coco_json(jann)
    assert gnames == wnames
    _assert_same_samples(got, want)
    on_jax_tree, names = tcoco.load_coco_json(jann)
    assert names == wnames
    _assert_same_samples(on_jax_tree, want)
    assert [s.image_path for s in on_jax_tree] == [s.image_path for s in want]
    assert [os.path.dirname(s.image_path) for s in got] == \
        [os.path.dirname(s.image_path).replace(str(tmp_path / "j"),
                                               str(tmp_path / "t"))
         for s in want]


def test_label_path_and_devkit_errors_match_jax(tmp_path):
    d = tmp_path / "my_images_v2" / "images"
    (tmp_path / "my_images_v2" / "labels").mkdir(parents=True)
    d.mkdir()
    (tmp_path / "my_images_v2" / "labels" / "a.txt").write_text("0 .5 .5 .1 .1")
    for p in (str(d / "a.jpg"), str(d / "b.jpg"),
              str(tmp_path / "JPEGImages" / "c.png")):
        assert tvoc._label_path(p) == jvoc._label_path(p)
    root = tmp_path / "dk"
    (root / "VOC2007" / "ImageSets" / "Main").mkdir(parents=True)
    (root / "VOC2007" / "ImageSets" / "Main" / "test.txt").write_text(
        "000001 1\n000002 -1\n")
    for loader in (tvoc.load_voc_devkit, jvoc.load_voc_devkit):
        with pytest.raises(FileNotFoundError, match="annotations archive"):
            loader(str(root))


def test_non_png_without_cv2_names_cv2_and_the_file(tmp_path, no_cv2):
    s = tvoc.Sample(str(tmp_path / "x.jpg"), "x",
                    np.zeros((0, 5), np.float32))
    with pytest.raises(ImportError, match=r"cv2.*x\.jpg|x\.jpg.*cv2"):
        s.load_image()


# ---- host letterbox -----------------------------------------------------

@pytest.mark.parametrize("shape, net", [((48, 64, 3), (32, 32)),
                                        ((30, 50, 3), (40, 56)),
                                        ((32, 32, 3), (32, 32))])
def test_letterbox_host_matches_jax(shape, net):
    img = np.random.default_rng(4).integers(0, 256, shape, np.uint8)
    got = tpre.letterbox_host(img, *net)
    want = jpre.letterbox_host(img, *net)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_letterbox_host_same_size_needs_no_cv2(no_cv2):
    img = np.random.default_rng(5).integers(0, 256, (32, 32, 3), np.uint8)
    canvas, r, left, top = tpre.letterbox_host(img, 32, 32)
    np.testing.assert_array_equal(canvas, img)
    assert (r, left, top) == (1.0, 0, 0)
    with pytest.raises(ImportError, match="cv2"):
        tpre.letterbox_host(img, 16, 16)


# ---- prefetch -------------------------------------------------------------

def test_prefetch_order_content_and_nesting():
    items = [(np.ones(3) * i, {"k": np.zeros(2) + i}, ["meta", i])
             for i in range(5)]
    out = list(prefetch_to_device(items, depth=2, device="cpu"))
    assert len(out) == 5
    for i, (a, d, meta) in enumerate(out):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), np.ones(3) * i)
        np.testing.assert_array_equal(d["k"].numpy(), np.zeros(2) + i)
        assert meta == ["meta", i]


def test_prefetch_runs_ahead_and_reraises():
    produced = []

    def slow_source():
        for i in range(5):
            time.sleep(0.03)
            produced.append(i)
            yield np.asarray([i])
        raise ValueError("boom")

    seen = ran_ahead = 0
    it = prefetch_to_device(slow_source(), depth=2, device="cpu")
    with pytest.raises(ValueError, match="boom"):
        for _ in it:
            time.sleep(0.03)
            seen += 1
            ran_ahead = max(ran_ahead, len(produced) - seen)
    assert seen == 5 and ran_ahead >= 1


def test_prefetch_abandoned_iterator_releases_feeder():
    import threading
    n_before = threading.active_count()
    it = prefetch_to_device((np.full((4,), i) for i in range(100)),
                            depth=1, device="cpu")
    next(it)
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before


def test_prefetch_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device([np.zeros(1)]))
