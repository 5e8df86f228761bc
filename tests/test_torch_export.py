"""The port's export CLI (modelcompression_tpu_torch/cli/export.py) on the
CPU: the ``.pt2`` program reloads with ``torch.export.load`` and equals
the live serving step; at BITMATCH it is within the JAX CLI's verify
tolerance (rtol 1e-5, atol 1e-4) of the JAX package's live step on the
same numpy params, for the [region] and the multi-head [yolo] families;
``--qmodel`` and ``--cmodel`` export (a cmodel as its reconstructed
weights, exactly); every usage error exits 2, those the JAX CLI shares in
its words. Worker time: ~25 s."""

import os

import jax
import numpy as np
import pytest
import torch

from modelcompression_tpu.data import fixtures as jfx
from modelcompression_tpu.models import init_params as j_init
from modelcompression_tpu.models import parse_cfg as j_parse
from modelcompression_tpu.models import save_weights as j_save
from modelcompression_tpu_torch.cli import export
from modelcompression_tpu_torch.core.precision import BITMATCH
from modelcompression_tpu_torch.evaluation import EvalConfig, make_eval_step
from modelcompression_tpu_torch.models import (
    fold_batchnorm, load_weights, parse_cfg,
)

CFGS = {"region": jfx.tiny_region_cfg, "yolo3": jfx.tiny_yolo3_cfg}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(tmp_path, kind="region", seed=0):
    """A 64x64 fixture net written by the JAX package: (cfg path, weights
    path, numpy HWIO params)."""
    text = CFGS[kind](num_classes=3, width=64, height=64)
    cfg = str(tmp_path / f"{kind}.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    params = jax.tree.map(np.asarray, j_init(j_parse(text),
                                             jax.random.key(seed)))
    weights = str(tmp_path / f"{kind}.weights")
    j_save(weights, j_parse(text), params, seen=0)
    return cfg, weights, params


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8),
            np.full((b,), 96.0, np.float32), np.full((b,), 80.0, np.float32))


def _run_pt2(path, images, ws, hs):
    m = torch.export.load(path).module()
    with torch.inference_mode():
        return [t.numpy() for t in m(torch.from_numpy(images),
                                     torch.from_numpy(ws),
                                     torch.from_numpy(hs))]


def _export(cfg, src, out, *extra):
    return export.main(["--cfg", cfg, *src, "--out", out, "--platforms",
                        "cpu", *extra])


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_pt2_roundtrip_equals_live_step_and_jax(tmp_path, capsys, kind):
    """rc 0 includes the CLI's own reload-and-compare. On a fresh batch the
    program equals the port's live step (BITMATCH, the export's config)
    and is within the JAX CLI's verify tolerance of the JAX live step."""
    from modelcompression_tpu.core.precision import BITMATCH as J_BM
    from modelcompression_tpu.evaluation import EvalConfig as JConfig
    from modelcompression_tpu.evaluation import make_eval_step as j_step
    from modelcompression_tpu.models.darknet import fold_batchnorm as j_fold
    cfg, weights, np_params = _model(tmp_path, kind)
    out = str(tmp_path / "m.pt2")
    assert _export(cfg, ["--weights", weights], out, "--batch", "2",
                   "--conf", "0.05") == 0
    printed = capsys.readouterr().out
    assert "verify ok" in printed and "bitmatch compute" in printed
    images, ws, hs = _batch(2, seed=1)
    got = _run_pt2(out, images, ws, hs)

    spec = parse_cfg(open(cfg).read())
    params, _ = load_weights(weights, spec)
    kw = dict(conf_thresh=0.05, nms_thresh=0.45, max_detections=50)
    live = make_eval_step(spec, EvalConfig(precision=BITMATCH,
                                           fuse_input_stage=False,
                                           device="cpu", **kw))
    want = [t.numpy() for t in live(fold_batchnorm(params, spec), images,
                                    ws, hs)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
    assert got[2].sum() > 0 and got[0].shape[:3] == (2, 3, 50)

    jspec = j_parse(open(cfg).read())
    jwant = j_step(jspec, JConfig(precision=J_BM, **kw))(
        j_fold(jax.tree.map(jax.numpy.asarray, np_params), jspec),
        images, ws, hs)
    for g, w in zip(got, jwant):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-4)


def test_export_qmodel_and_cmodel(tmp_path, capsys):
    """An int8 artifact exports at FAST (advisory verify, as in the JAX
    CLI) and the program equals the live int8 step; bitmatch is the JAX
    usage error. A weight-sharing artifact exports to the program of its
    reconstructed weights, bit for bit."""
    from modelcompression_tpu_torch.cli.common import (
        quantized_eval_config,
    )
    from modelcompression_tpu_torch.compress import (
        cluster_network, load_qmodel, quantize_from_batches, reconstruct,
        save_cmodel, save_qmodel,
    )
    from modelcompression_tpu_torch.core.precision import FAST
    from modelcompression_tpu_torch.models import save_weights
    cfg, weights, _ = _model(tmp_path, seed=1)
    spec = parse_cfg(open(cfg).read())
    params, _ = load_weights(weights, spec)
    rng = np.random.default_rng(2)
    q = quantize_from_batches(
        fold_batchnorm(params, spec), spec,
        [rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)])
    qm = str(tmp_path / "model.qz")
    save_qmodel(qm, q, spec)
    out = str(tmp_path / "q.pt2")
    assert _export(cfg, ["--qmodel", qm], out, "--conf", "0.001") == 0
    printed = capsys.readouterr().out
    assert "int8 qmodel" in printed and "verify (fast/bf16, advisory)" \
        in printed and "agreement 100.00%" in printed
    images, ws, hs = _batch(1, seed=3)
    got = _run_pt2(out, images, ws, hs)
    qparams, _ = load_qmodel(qm, spec=spec)
    live = make_eval_step(spec, quantized_eval_config(EvalConfig(
        conf_thresh=0.001, max_detections=50, precision=FAST,
        fuse_input_stage=False, device="cpu")))
    for g, w in zip(got, live(qparams, images, ws, hs)):
        np.testing.assert_array_equal(g, w.numpy())
    assert _export(cfg, ["--qmodel", qm], out, "--precision",
                   "bitmatch") == 2
    assert "bitmatch is not available with --qmodel" in \
        capsys.readouterr().err

    cm = cluster_network(params, spec, bits=4)
    cz, rw = str(tmp_path / "c.npz"), str(tmp_path / "r.weights")
    save_cmodel(cz, cm, spec, pack="huffman")
    save_weights(rw, spec, reconstruct(cm), seen=0)
    outs = [str(tmp_path / "c.pt2"), str(tmp_path / "r.pt2")]
    assert _export(cfg, ["--cmodel", cz], outs[0], "--conf", "0.05") == 0
    assert _export(cfg, ["--weights", rw], outs[1], "--conf", "0.05") == 0
    a, b = (_run_pt2(o, images, ws, hs) for o in outs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


USAGE = {  # extra argv, message, shared with the JAX CLI
    "no_source": (["--out", "{o}"], "exactly one of --weights", True),
    "two_sources": (["--weights", "{w}", "--qmodel", "q", "--out", "{o}"],
                    "exactly one of --weights", True),
    "batch_zero": (["--weights", "{w}", "--out", "{o}", "--batch", "0"],
                   "--batch must be >= 1", True),
    "quantize_alone": (["--weights", "{w}", "--out", "{o}",
                        "--tflite-quantize", "dynamic"],
                       "--tflite-quantize only applies with --tflite", True),
    "tflite": (["--weights", "{w}", "--out", "{o}", "--tflite"],
               "--tflite has no PyTorch form", False),
    "tpu": (["--weights", "{w}", "--out", "{o}", "--platforms", "tpu"],
            "--platforms tpu has no PyTorch form", False),
    "two_platforms": (["--weights", "{w}", "--out", "{o}", "--platforms",
                       "cpu,cuda"], "takes one of 'cuda' or 'cpu'", False),
}


@pytest.mark.parametrize("case", sorted(USAGE))
def test_export_usage_errors(tmp_path, capsys, case):
    from modelcompression_tpu.cli import export as jexport
    cfg, weights, _ = _model(tmp_path)
    extra, message, shared = USAGE[case]
    argv = ["--cfg", cfg] + [a.format(w=weights, o=str(tmp_path / "x"))
                             for a in extra]
    mains = (export.main, jexport.main) if shared else (export.main,)
    for main in mains:
        assert main(argv) == 2
        assert message in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x")


def test_export_default_platform_is_cuda(tmp_path, monkeypatch):
    cfg, weights, _ = _model(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        export.main(["--cfg", cfg, "--weights", weights, "--out",
                     str(tmp_path / "x.pt2")])
