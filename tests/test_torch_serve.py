"""The port's serving daemon (modelcompression_tpu_torch/cli/serve.py) on
the CPU: /healthz, /stats, /metrics and a /detect POST, with detections
equal to the direct make_eval_step result (the same step on the same
canvas: exact), int8 --qmodel and weight-sharing --cmodel serving, plus
the flag surface and the rejections."""

import argparse
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from modelcompression_tpu.data.fixtures import tiny_region_cfg
from modelcompression_tpu_torch.cli import serve
from modelcompression_tpu_torch.models import (
    dump_cfg, init_params, parse_cfg, save_weights,
)


def _write_model(tmp, seed=0):
    spec = parse_cfg(tiny_region_cfg(num_classes=3, width=64, height=64))
    cfg_path = str(tmp / "net.cfg")
    with open(cfg_path, "w") as f:
        f.write(dump_cfg(spec))
    wpath = str(tmp / "w.weights")
    save_weights(wpath, spec, init_params(spec, seed=seed), seen=0)
    return spec, cfg_path, wpath


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve")
    spec, cfg_path, wpath = _write_model(tmp)
    args = serve.build_parser().parse_args(
        ["--cfg", cfg_path, "--weights", wpath, "--port", "0",
         "--device", "cpu", "--batch", "2", "--max-wait-ms", "30",
         "--conf", "0.05"])
    httpd, state = serve.build_server(args)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address[1], state, spec
    state.stop.set()
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=30)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, r.headers, r.read()


def _post(port, body, path="/detect"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_healthz_and_stats(server):
    port, state, spec = server
    status, _, body = _get(port, "/healthz")
    h = json.loads(body)
    assert status == 200 and h["ok"] and h["classes"] == 3
    assert h["net"] == [64, 64] and h["batch"] == 2
    assert h["device"] == "cpu" and h["conf"] == pytest.approx(0.05)
    assert h["max_detections"] == 50 and h["nms_prefilter"] == 0
    status, _, body = _get(port, "/stats")
    st = json.loads(body)
    assert status == 200 and st["compiled_batch"] == 2
    assert {"requests", "images", "batches", "latency_ms_p50"} <= set(st)


def test_submit_queue_serves_canvases(server):
    """The path chip_smoke.py drives: canvases into ServeState.submit."""
    port, state, spec = server
    n0 = state.stats()["images"]
    rng = np.random.default_rng(3)
    items = [state.submit(rng.integers(0, 256, (64, 64, 3), np.uint8),
                          100.0, 80.0) for _ in range(3)]
    for it in items:
        assert it.event.wait(60) and it.error is None
        assert isinstance(it.result, list)
    assert state.stats()["images"] >= n0 + 3


def test_detect_post_matches_direct_step(server):
    cv2 = pytest.importorskip("cv2")
    from modelcompression_tpu_torch.data.preprocess import letterbox_host
    port, state, spec = server
    img = np.random.default_rng(7).integers(0, 255, (80, 100, 3), np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    status, out = _post(port, bytes(buf))
    assert status == 200
    assert out["width"] == 100 and out["height"] == 80
    for d in out["detections"]:
        assert set(d) == {"class_id", "name", "score", "box"}
        x1, y1, x2, y2 = d["box"]
        assert 0 <= x1 <= x2 <= 100 and 0 <= y1 <= y2 <= 80
    scores = [d["score"] for d in out["detections"]]
    assert scores == sorted(scores, reverse=True)

    canvas, _, _, _ = letterbox_host(
        cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1], 64, 64)
    sel, sc, valid, _, _ = state.step(state.params, np.stack([canvas] * 2),
                                      [100.0, 100.0], [80.0, 80.0])
    direct = sorted((ci, float(sc[0, ci, k]))
                    for ci in range(sel.shape[1])
                    for k in np.nonzero(valid[0, ci].numpy())[0])
    got = sorted((d["class_id"], d["score"]) for d in out["detections"])
    assert got == direct
    assert len(got) > 0


def test_metrics_and_errors(server):
    port, state, spec = server
    status, headers, body = _get(port, "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    text = body.decode()
    assert "mc_torch_serve_requests_total" in text
    assert text.count("# HELP") == text.count("# TYPE") == 12
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, b"x", path="/nope")
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(port, "/nope")
    assert ei.value.code == 404


def test_deployment_preset_resolution():
    from modelcompression_tpu_torch.cli.common import (
        DEPLOYMENT_PRESET, resolve_serving_eval_config,
    )
    parser = serve.build_parser()
    base = ["--cfg", "x.cfg", "--device", "cpu"]
    cfg = resolve_serving_eval_config(parser.parse_args(base))
    assert (cfg.conf_thresh, cfg.max_detections, cfg.nms_prefilter) == \
        (0.25, 50, 0)
    assert cfg.device == "cpu" and cfg.fuse_input_stage
    cfg = resolve_serving_eval_config(parser.parse_args(
        base + ["--deployment"]))
    assert (cfg.conf_thresh, cfg.max_detections, cfg.nms_prefilter) == \
        (DEPLOYMENT_PRESET["conf"], DEPLOYMENT_PRESET["max_detections"],
         DEPLOYMENT_PRESET["nms_prefilter"]) == (0.01, 32, 128)
    cfg = resolve_serving_eval_config(parser.parse_args(
        base + ["--deployment", "--conf", "0.2", "--nms-prefilter", "64"]))
    assert (cfg.conf_thresh, cfg.nms_prefilter, cfg.max_detections) == \
        (0.2, 64, 32)
    assert parser.parse_args(["--cfg", "x.cfg"]).device == "cuda"


@pytest.mark.parametrize("extra, match", [
    # ids kept from when --qmodel was the first case (ported since);
    # --cmodel is ported too, and beside --weights the usage error; --dp
    # is ported too and serves (_serve_dp), a batch it does not divide the
    # JAX CLI's usage error
    pytest.param(["--cmodel", "c.npz"], "cmodel", id="extra1-cmodel"),
    pytest.param(["--dp", "2"], "dp", id="extra2-dp"),
])
def test_not_ported_options_are_rejected(tmp_path, capsys, extra, match):
    _, cfg_path, wpath = _write_model(tmp_path)
    argv = ["--cfg", cfg_path, "--weights", wpath, "--port", "0",
            "--device", "cpu"] + extra
    if match == "dp":
        _serve_dp(argv)
        argv += ["--batch", "3"]
    rc = serve.main(argv)
    assert rc == 2
    assert match in capsys.readouterr().err


def _serve_dp(argv):
    """serve --dp 2 on two CPU shards (the JAX test_serve.py case): the
    state holds a 2-wide mesh, /healthz and /stats say dp 2, and a posted
    image's detections equal the single-device step's on its canvas."""
    cv2 = pytest.importorskip("cv2")
    from modelcompression_tpu_torch.data.preprocess import letterbox_host
    from modelcompression_tpu_torch.evaluation import make_eval_step
    args = serve.build_parser().parse_args(
        argv + ["--batch", "4", "--max-wait-ms", "30", "--conf", "0.05"])
    httpd, state = serve.build_server(args)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        assert state.mesh.shape["data"] == 2 and len(state.params) == 2
        port = httpd.server_address[1]
        assert json.loads(_get(port, "/healthz")[2])["dp"] == 2
        assert json.loads(_get(port, "/stats")[2])["dp"] == 2
        img = np.random.default_rng(41).integers(0, 255, (80, 100, 3),
                                                 np.uint8)
        ok, buf = cv2.imencode(".png", img)
        status, out = _post(port, bytes(buf))
        assert status == 200
        canvas, _, _, _ = letterbox_host(
            cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1], 64, 64)
        step = make_eval_step(state.spec, state.cfg)
        sel, sc, valid, _, _ = step(state.params[0],
                                    np.stack([canvas] * 4), [100.0] * 4,
                                    [80.0] * 4)
        direct = sorted((ci, float(sc[0, ci, k]))
                        for ci in range(sel.shape[1])
                        for k in np.nonzero(valid[0, ci].numpy())[0])
        got = sorted((d["class_id"], d["score"])
                     for d in out["detections"])
        assert got == pytest.approx(direct, rel=1e-5) and len(got) > 0
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


def test_cuda_default_raises_without_cuda(tmp_path, monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg_path, wpath = _write_model(tmp_path)
    rc = serve.main(["--cfg", cfg_path, "--weights", wpath, "--port", "0"])
    assert rc == 2
    assert "CUDA" in capsys.readouterr().err


def test_submit_backpressure_bounded_queue():
    args = argparse.Namespace(batch=1, max_wait_ms=0.0, timeout_s=1.0,
                              verbose=False)
    state = serve.ServeState(spec=None, params=None, step=None,
                             names=["c"], args=args)
    canvas = np.zeros((4, 4, 3), np.uint8)
    cap = state.q.maxsize
    for _ in range(cap):
        assert state.submit(canvas, 4.0, 4.0) is not None
    assert state.submit(canvas, 4.0, 4.0) is None
    st = state.stats()
    assert st["rejected"] == 1 and st["requests"] == cap + 1


def _diou_cfg_text():
    """The v4-tiny fixture with darknet's nms_kind=diounms / beta_nms on
    its [yolo] heads."""
    from modelcompression_tpu.data.fixtures import tiny_yolo4_cfg
    return tiny_yolo4_cfg(num_classes=3).replace(
        "[yolo]\n", "[yolo]\nnms_kind=diounms\nbeta_nms=0.6\n")


@pytest.mark.parametrize("cfg_name", ["yolov2-voc.cfg", "diounms"])
@pytest.mark.parametrize("extra", [
    [], ["--diou-nms"], ["--diou-beta", "0.8"], ["--soft-nms", "linear"],
    ["--deployment", "--nms-prefilter-impl", "bisect"],
    ["--diou-nms", "--diou-beta", "0.3", "--nms-prefilter", "64"],
])
def test_serving_eval_config_resolves_as_jax(tmp_path, cfg_name, extra):
    """The same argv resolves the same EvalConfig in both packages: the
    cfg's nms_kind=diounms / beta_nms are the NMS defaults and explicit
    --diou-nms / --diou-beta / --soft-nms win."""
    from modelcompression_tpu.cli import common as jcommon
    from modelcompression_tpu.cli import serve as jserve
    from modelcompression_tpu.models import load_cfg as j_load
    from modelcompression_tpu_torch.cli.common import (
        resolve_serving_eval_config,
    )
    from modelcompression_tpu_torch.models import cfg_path, load_cfg
    if cfg_name == "diounms":
        path = str(tmp_path / "diou.cfg")
        with open(path, "w") as f:
            f.write(_diou_cfg_text())
    else:
        path = cfg_path(cfg_name)
    argv = ["--cfg", path, *extra]
    j = jcommon.resolve_serving_eval_config(
        jserve.build_parser().parse_args(argv), spec=j_load(path))
    t = resolve_serving_eval_config(
        serve.build_parser().parse_args(argv + ["--device", "cpu"]),
        spec=load_cfg(path))
    for name in ("conf_thresh", "nms_thresh", "max_detections",
                 "nms_prefilter", "nms_prefilter_impl", "soft_nms",
                 "soft_nms_sigma", "diou_nms", "diou_beta", "exact_nms"):
        assert getattr(t, name) == getattr(j, name), name
    if cfg_name == "diounms" and not extra:
        assert (t.diou_nms, t.diou_beta) == (True, 0.6)


@pytest.mark.parametrize("extra", [
    ["--soft-nms", "linear"],
    ["--diou-nms", "--diou-beta", "0.6"],
    ["--nms-prefilter", "16", "--nms-prefilter-impl", "bisect"],
])
def test_serve_yolo_family_with_nms_variants(tmp_path, extra):
    """The daemon serves a [yolo] (v4-tiny) cfg with each serving NMS
    variant (rejected before they were ported): a canvas through the
    dispatcher gives the direct step's detections."""
    from modelcompression_tpu.data.fixtures import tiny_yolo4_cfg
    spec = parse_cfg(tiny_yolo4_cfg(num_classes=3))
    cfg_path = str(tmp_path / "v4.cfg")
    with open(cfg_path, "w") as f:
        f.write(dump_cfg(spec))
    wpath = str(tmp_path / "v4.weights")
    save_weights(wpath, spec, init_params(spec, seed=11), seen=0)
    args = serve.build_parser().parse_args(
        ["--cfg", cfg_path, "--weights", wpath, "--port", "0",
         "--device", "cpu", "--batch", "1", "--max-wait-ms", "10",
         "--conf", "0.05", *extra])
    httpd, state = serve.build_server(args)
    try:
        canvas = np.random.default_rng(5).integers(0, 256, (64, 64, 3),
                                                   np.uint8)
        item = state.submit(canvas, 64.0, 64.0)
        assert item.event.wait(60) and item.error is None
        sel, sc, valid, _, _ = state.step(state.params, canvas[None],
                                          [64.0], [64.0])
        direct = sorted((ci, float(sc[0, ci, k]))
                        for ci in range(sel.shape[1])
                        for k in np.nonzero(valid[0, ci].numpy())[0])
        got = sorted((d["class_id"], d["score"]) for d in item.result)
        assert got == direct and len(got) > 0
    finally:
        state.stop.set()
        httpd.server_close()


def test_qmodel_serves_the_int8_forward(tmp_path):
    """--qmodel serves an int8 artifact through forward_quantized: the
    dispatcher's detections equal the int8 step's on the same canvas;
    --qmodel with --weights is refused."""
    from modelcompression_tpu_torch.compress import (
        forward_quantized, quantize_from_batches, save_qmodel,
    )
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, make_eval_step,
    )
    from modelcompression_tpu_torch.models import fold_batchnorm
    spec, cfg_path, wpath = _write_model(tmp_path, seed=4)
    rng = np.random.default_rng(4)
    q = quantize_from_batches(
        fold_batchnorm(init_params(spec, seed=4), spec), spec,
        [rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)])
    qpath = str(tmp_path / "q.npz")
    save_qmodel(qpath, q, spec)
    base = ["--cfg", cfg_path, "--port", "0", "--device", "cpu",
            "--batch", "2", "--max-wait-ms", "30", "--conf", "0.05"]
    assert serve.main(base + ["--qmodel", qpath, "--weights", wpath]) == 2
    httpd, state = serve.build_server(
        serve.build_parser().parse_args(base + ["--qmodel", qpath]))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        assert state.cfg.forward_fn is forward_quantized
        canvas = rng.integers(0, 256, (64, 64, 3), np.uint8)
        item = state.submit(canvas, 100.0, 80.0)
        assert item.event.wait(60) and item.error is None
        step = make_eval_step(spec, EvalConfig(
            conf_thresh=0.05, max_detections=50, device="cpu",
            forward_fn=forward_quantized))
        sel, sc, valid, _, _ = step(q, np.stack([canvas] * 2),
                                    [100.0, 100.0], [80.0, 80.0])
        direct = sorted((ci, float(sc[0, ci, k]))
                        for ci in range(sel.shape[1])
                        for k in np.nonzero(valid[0, ci].numpy())[0])
        assert sorted((d["class_id"], d["score"])
                      for d in item.result) == direct
        status, _, body = _get(httpd.server_address[1], "/healthz")
        assert status == 200 and json.loads(body)["ok"]
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


def test_cmodel_serves_the_reconstructed_params(tmp_path):
    """--cmodel serves a (Huffman-packed) weight-sharing artifact as its
    reconstructed float32 params: the dispatcher's detections equal the
    FAST step's on those params, BN-folded, on the same canvas."""
    from modelcompression_tpu_torch.compress import (
        cluster_network, reconstruct, save_cmodel,
    )
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, make_eval_step,
    )
    from modelcompression_tpu_torch.models import fold_batchnorm
    spec, cfg_path, _ = _write_model(tmp_path, seed=5)
    cmodel = cluster_network(init_params(spec, seed=5), spec, bits=4)
    cpath = str(tmp_path / "c.npz")
    save_cmodel(cpath, cmodel, spec, pack="huffman")
    base = ["--cfg", cfg_path, "--port", "0", "--device", "cpu",
            "--batch", "2", "--max-wait-ms", "30", "--conf", "0.05"]
    httpd, state = serve.build_server(
        serve.build_parser().parse_args(base + ["--cmodel", cpath]))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        rng = np.random.default_rng(5)
        canvas = rng.integers(0, 256, (64, 64, 3), np.uint8)
        item = state.submit(canvas, 100.0, 80.0)
        assert item.event.wait(60) and item.error is None
        step = make_eval_step(spec, EvalConfig(
            conf_thresh=0.05, max_detections=50, device="cpu"))
        sel, sc, valid, _, _ = step(
            fold_batchnorm(reconstruct(cmodel), spec),
            np.stack([canvas] * 2), [100.0, 100.0], [80.0, 80.0])
        direct = sorted((ci, float(sc[0, ci, k]))
                        for ci in range(sel.shape[1])
                        for k in np.nonzero(valid[0, ci].numpy())[0])
        assert direct
        assert sorted((d["class_id"], d["score"])
                      for d in item.result) == direct
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
