"""The port's deploy CLI (modelcompression_tpu_torch/cli/deploy.py) on the
CPU: the whole recipe end to end on the tiny fixture (prune + fine-tune,
QAT with its int8 artifact, the packed weight-sharing artifact and the
``.pt2`` export), its report.json with the JAX CLI's keys, and at one
fraction — so the keep-set comes from the given weights alone — a
slim.cfg byte-equal to the JAX deploy's and the same params counts;
skipped stages leave no artifact. Worker time: ~35 s."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from modelcompression_tpu.data import fixtures as jfx
from modelcompression_tpu.models import init_params as j_init
from modelcompression_tpu.models import parse_cfg as j_parse
from modelcompression_tpu.models import save_weights as j_save
from modelcompression_tpu_torch.cli import deploy
from modelcompression_tpu_torch.models import load_cfg
from modelcompression_tpu_torch.models.cfg import ConvLayer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The JAX deploy test's tiny region net (written by the JAX package)
    and a 4-image 64x64 fixture."""
    tmp = tmp_path_factory.mktemp("deploy")
    text = jfx.tiny_region_cfg(num_classes=3, width=64, height=64)
    cfg = str(tmp / "tiny.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    weights = str(tmp / "init.weights")
    j_save(weights, j_parse(text),
           jax.tree.map(np.asarray, j_init(j_parse(text),
                                           jax.random.key(0))), seen=0)
    data = jfx.make_fake_voc(str(tmp / "voc"), n_images=4, image_size=64)
    return {"cfg": cfg, "weights": weights, "data": data, "tmp": tmp}


def _argv(f, out_dir, *extra):
    return ["--cfg", f["cfg"], "--weights", f["weights"], "--data",
            f["data"], "--out-dir", out_dir, "--batch", "2",
            "--eval-batch", "2", "--max-boxes", "8", *extra]


def test_deploy_cli_end_to_end(fixture, capsys):
    from modelcompression_tpu.compress import load_qmodel as j_load_qmodel
    from modelcompression_tpu_torch.compress import load_cmodel, load_qmodel
    out_dir = str(fixture["tmp"] / "art")
    assert deploy.main(_argv(
        fixture, out_dir, "--fractions", "0.5", "--steps", "2",
        "--qat-steps", "2", "--cluster-bits", "4", "--export",
        "saved_model", "--device", "cpu")) == 0
    printed = capsys.readouterr().out
    assert "verify ok" in printed
    for name in ("slim.weights", "slim.cfg", "slim-qat.weights",
                 "deploy.qz", "deploy.cz", "saved_model.pt2",
                 "report.json"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    report = json.load(open(os.path.join(out_dir, "report.json")))
    assert set(report) == {"stages", "artifacts", "wall_s"}
    assert set(report["stages"]) == {"baseline", "pruned", "int8"}
    assert set(report["artifacts"]) == {"slim.weights", "deploy.qz",
                                        "deploy.cz", "saved_model"}
    for st in report["stages"].values():
        assert set(st) == {"map50", "params"}
        assert 0.0 <= st["map50"] <= 100.0
    assert report["stages"]["pruned"]["params"] < \
        report["stages"]["baseline"]["params"]
    assert report["artifacts"]["slim.weights"] > \
        report["artifacts"]["deploy.qz"] > 0
    assert report["artifacts"]["saved_model"] == os.path.getsize(
        os.path.join(out_dir, "saved_model.pt2"))
    slim = load_cfg(os.path.join(out_dir, "slim.cfg"))
    spec = load_cfg(fixture["cfg"])
    convs = [l for l in slim.layers if isinstance(l, ConvLayer)]
    orig = [l for l in spec.layers if isinstance(l, ConvLayer)]
    assert convs[-1].filters == orig[-1].filters
    assert sum(c.filters for c in convs) < sum(c.filters for c in orig)
    # both packages load the artifacts
    load_qmodel(os.path.join(out_dir, "deploy.qz"), spec=slim)
    with open(os.path.join(out_dir, "slim.cfg")) as f:
        j_load_qmodel(os.path.join(out_dir, "deploy.qz"),
                      spec=j_parse(f.read()))
    load_cmodel(os.path.join(out_dir, "deploy.cz"), spec=slim)


def test_deploy_slim_cfg_and_params_equal_jax(fixture, capsys):
    """One fraction, one step: the keep-set is the given weights' L1
    ranking in both packages, so slim.cfg is byte-equal to the JAX
    deploy's and the baseline and pruned params counts are equal."""
    from modelcompression_tpu.cli import deploy as jdeploy
    reports, cfgs = {}, {}
    for side, main, dev in (("jax", jdeploy.main, []),
                            ("torch", deploy.main, ["--device", "cpu"])):
        out_dir = str(fixture["tmp"] / f"eq_{side}")
        assert main(_argv(fixture, out_dir, "--fractions", "0.5", "--steps",
                          "1", "--qat-steps", "0", "--cluster-bits", "0",
                          *dev)) == 0
        reports[side] = json.load(open(os.path.join(out_dir,
                                                    "report.json")))
        with open(os.path.join(out_dir, "slim.cfg"), "rb") as f:
            cfgs[side] = f.read()
    capsys.readouterr()
    assert cfgs["torch"] == cfgs["jax"]
    got, want = reports["torch"], reports["jax"]
    assert got.keys() == want.keys()
    assert got["stages"].keys() == want["stages"].keys() == \
        {"baseline", "pruned"}
    for st in want["stages"]:
        assert got["stages"][st]["params"] == want["stages"][st]["params"]
    assert got["artifacts"] == want["artifacts"]  # slim.weights bytes


def test_deploy_cli_skip_stages_and_rejections(fixture, capsys):
    """--qat-steps 0 and --cluster-bits 0 skip their stages cleanly; a bad
    fraction and the TFLite exports exit 2 before any work."""
    out_dir = str(fixture["tmp"] / "skip")
    assert deploy.main(_argv(
        fixture, out_dir, "--fractions", "0.25", "--steps", "1",
        "--qat-steps", "0", "--cluster-bits", "0", "--device", "cpu")) == 0
    report = json.load(open(os.path.join(out_dir, "report.json")))
    assert set(report["stages"]) == {"baseline", "pruned"}
    assert set(report["artifacts"]) == {"slim.weights"}
    for name in ("deploy.qz", "deploy.cz", "slim-qat.weights",
                 "saved_model.pt2"):
        assert not os.path.exists(os.path.join(out_dir, name)), name
    capsys.readouterr()
    bad = str(fixture["tmp"] / "bad")
    assert deploy.main(_argv(fixture, bad, "--fractions", "1.5",
                             "--device", "cpu")) == 2
    assert "bad fraction" in capsys.readouterr().err
    for kind in ("tflite", "both"):
        assert deploy.main(_argv(fixture, bad, "--export", kind,
                                 "--device", "cpu")) == 2
        assert "no PyTorch form" in capsys.readouterr().err
    assert not os.path.exists(bad)


def test_deploy_default_device_is_cuda(fixture, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        deploy.main(_argv(fixture, str(fixture["tmp"] / "nocuda")))
    assert not os.path.exists(fixture["tmp"] / "nocuda")
