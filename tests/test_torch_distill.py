"""The port's knowledge distillation (modelcompression_tpu_torch/train/
distill.py and the distilled train step) against the JAX package's, on
the CPU at fixture size: ``distill_loss`` (softmax and sigmoid [region]
heads, temperatures 1 and 2) and ``detection_distill_loss`` (YOLOv3-tiny
and YOLOv4-tiny fixture heads) within max relative 1e-6; every
``make_distill_plan`` error with the JAX package's words; the folded
teacher and its forward; a distilled step (subdivisions 1 and 2) at the
tolerance of tests/test_torch_train_step.py; and finetune --distill."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.data import fixtures as jfx
from modelcompression_tpu.models import init_params as j_init
from modelcompression_tpu.models import parse_cfg as j_parse
from modelcompression_tpu.train import distill as jd
from modelcompression_tpu.train import train_step as jts
from modelcompression_tpu_torch.core.precision import BITMATCH
from modelcompression_tpu_torch.models import (
    params_from_jax, params_to_jax, parse_cfg,
)
from modelcompression_tpu_torch.train import distill as td
from modelcompression_tpu_torch.train import train_step as tts
from tests.test_torch_train_step import (
    BATCH, _batch, _compare, _copied, _np, _setup, _trace,
)

REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(rng, shape):
    return rng.normal(0, 2, shape).astype(np.float32)


def _rel(got, want):
    got, want = float(got.detach()), float(want)
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("softmax", [1, 0])
@pytest.mark.parametrize("temp", [1.0, 2.0])
def test_region_distill_loss_matches_jax(softmax, temp):
    text = jfx.tiny_region_cfg(num_classes=3, width=64, height=64)
    text = text.replace("softmax=1", f"softmax={softmax}")
    jspec, tspec = j_parse(text), parse_cfg(text)
    assert tspec.region.softmax == softmax
    rng = np.random.default_rng(softmax * 10 + int(temp))
    s, t = _raw(rng, (3, 2, 2, 40)), _raw(rng, (3, 2, 2, 40))
    kw = dict(temp=temp, coord_scale=0.5, obj_scale=2.0, class_scale=1.5)
    want = jd.distill_loss(jnp.asarray(s), jnp.asarray(t), jspec.region,
                           **kw)
    got = td.distill_loss(torch.from_numpy(s), torch.from_numpy(t),
                          tspec.region, **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert _rel(got, want) <= REL
    same = torch.from_numpy(t)
    assert float(td.distill_loss(same, same, tspec.region, **kw)) == 0.0


@pytest.mark.parametrize("family", ["yolov3_tiny", "yolov4_tiny"])
def test_detection_distill_loss_multihead_matches_jax(family):
    text = {"yolov3_tiny": jfx.tiny_yolo3_cfg,
            "yolov4_tiny": jfx.tiny_yolo4_cfg}[family](num_classes=3)
    jspec, tspec = j_parse(text), parse_cfg(text)
    heads = [tspec.layers[i] for i in tspec.head_indices()]
    rng = np.random.default_rng(len(family))
    s = tuple(_raw(rng, (2, 4 * (k + 1), 4 * (k + 1), h.n * (5 + h.classes)))
              for k, h in enumerate(heads))
    t = tuple(_raw(rng, a.shape) for a in s)
    want = jd.detection_distill_loss(tuple(map(jnp.asarray, s)),
                                     tuple(map(jnp.asarray, t)), jspec,
                                     temp=3.0)
    ts = tuple(torch.from_numpy(a).requires_grad_() for a in s)
    got = td.detection_distill_loss(ts, tuple(map(torch.from_numpy, t)),
                                    tspec, temp=3.0)
    assert _rel(got, want) <= REL
    got.backward()  # the gradient reaches every student scale
    assert all(float(a.grad.abs().max()) > 0 for a in ts)


def _plan_cases():
    v2 = jfx.tiny_region_cfg(num_classes=3, width=64, height=64)
    v2_4 = jfx.tiny_region_cfg(num_classes=4, width=64, height=64)
    m = re.search(r"anchors *= *([^\n]+)", v2)
    vals = [float(v) for v in m.group(1).split(",")]
    vals[0] += 1.0
    v2_b = v2.replace(m.group(1), ",".join(f"{v:g}" for v in vals))
    v3 = jfx.tiny_yolo3_cfg(num_classes=3)
    v3_b = v3.replace("anchors = 8,8,  16,16,  24,24,  48,48",
                      "anchors = 8,8,  16,16,  24,24,  50,48")
    v3_4 = jfx.tiny_yolo3_cfg(num_classes=4)
    from modelcompression_tpu_torch.models.zoo import cfg_path
    with open(cfg_path("yolov3-voc.cfg")) as f:
        v3_full = f.read()
    return {  # name: (teacher cfg, student cfg, kw, JAX message)
        "family_v2_v3": (v2, v3, {}, "head family"),
        "family_v3_v2": (v3, v2, {}, "head family"),
        "head_count": (v3_full, v3, {}, "[yolo] heads"),
        "yolo_classes": (v3_4, v3, {}, "does not match student"),
        "yolo_anchors": (v3_b, v3, {}, "anchor priors"),
        "region_classes": (v2_4, v2, {}, "does not match student head"),
        "region_anchors": (v2_b, v2, {}, "anchor priors differ"),
        "temperature": (v2, v2, {"temp": 0.0}, "temperature must be > 0"),
    }


@pytest.mark.parametrize("case", sorted(_plan_cases()))
def test_make_distill_plan_errors_worded_as_jax(case):
    t_text, s_text, kw, message = _plan_cases()[case]
    with pytest.raises(ValueError) as jerr:
        jd.make_distill_plan({}, j_parse(t_text), j_parse(s_text), **kw)
    with pytest.raises(ValueError) as terr:
        td.make_distill_plan({}, parse_cfg(t_text), parse_cfg(s_text), **kw)
    assert message in str(terr.value)
    assert str(terr.value) == str(jerr.value)


def test_plan_folds_teacher_and_forward_matches_jax():
    """The plan's teacher is BN-folded as the JAX package folds it, and
    teacher_forward (BITMATCH, no fused input stage) gives its map."""
    jspec, tspec, np_params, _, _ = _setup(seed=6)
    jplan = jd.make_distill_plan(jax.tree.map(jnp.asarray, np_params),
                                 jspec, jspec, weight=0.5)
    tplan = td.make_distill_plan(params_from_jax(np_params, tspec), tspec,
                                 tspec, weight=0.5)
    got_p = params_to_jax(tplan.teacher_params)
    for k, p in jplan.teacher_params.items():
        assert sorted(got_p[k]) == sorted(p) == ["bias", "w"]
        for n, a in p.items():
            a = np.asarray(a)
            assert np.abs(got_p[k][n] - a).max() <= 1e-6 * np.abs(a).max()
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    from modelcompression_tpu.core.precision import BITMATCH as J_BITMATCH
    want = np.asarray(jd.teacher_forward(jplan, jplan.teacher_params,
                                         jnp.asarray(x), J_BITMATCH))
    got = td.teacher_forward(tplan, tplan.teacher_params,
                             torch.from_numpy(x), BITMATCH)
    assert not got.requires_grad
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("subdivisions", [1, 2])
def test_distilled_step_matches_jax(subdivisions):
    """Two steps with a teacher (another init) at weight 0.5, T 2: the
    metrics (loss_distill included; loss stays the detection loss),
    gradients, momentum and params within the step tolerance."""
    jspec, tspec, np_params, jcfg, tcfg = _setup(
        seed=7, subdivisions=subdivisions)
    np_teacher = jax.tree.map(np.array, j_init(jspec, jax.random.key(8)))
    jplan = jd.make_distill_plan(jax.tree.map(jnp.asarray, np_teacher),
                                 jspec, jspec, weight=0.5, temp=2.0)
    tplan = td.make_distill_plan(params_from_jax(np_teacher, tspec), tspec,
                                 tspec, weight=0.5, temp=2.0)
    tx = jts.make_optimizer(jcfg)
    jstate = jts.TrainState.create(jax.tree.map(jnp.asarray, np_params), tx,
                                   jax.random.key(1))
    jstep = jts.make_train_step(jspec, jcfg, tx, distill=jplan)
    tstate = tts.TrainState.create(params_from_jax(np_params, tspec),
                                   tts.make_optimizer(tcfg),
                                   torch.Generator().manual_seed(1))
    tstep = tts.make_train_step(tspec, tcfg, distill=tplan)
    images, targets = _batch()
    prev = np_params
    for i in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(targets))
        tstate, tm = tstep(tstate, images, targets)
        p, opt = tstate["params"], tstate["optimizer"]
        want = {"metrics": {k: float(v) for k, v in jm.items()},
                "params": jax.tree.map(np.array, jstate["params"]),
                "trace": jax.tree.map(np.array, _trace(jstate["opt_state"]))}
        got = {"metrics": {k: float(v) for k, v in tm.items()},
               "params": _copied(params_to_jax(p)),
               "grads": {k: {n: _np(v.grad) for n, v in q.items()
                             if v.grad is not None} for k, q in p.items()},
               "bufs": {k: {n: _np(opt.state[v]["momentum_buffer"])
                            for n, v in q.items() if v in opt.state}
                        for k, q in p.items()}}
        assert got["metrics"]["loss_distill"] > 0
        _compare(got, want, tcfg.decay, prev, check_grads=i == 0)
        prev = want["params"]
    assert tstate["seen"] == 2 * BATCH


def test_finetune_distill_cli(tmp_path, capsys):
    """finetune --distill (the teacher another init of the same cfg) trains
    and evaluates on the CPU; a teacher cfg with another class count exits
    2 with the JAX CLI's words."""
    from modelcompression_tpu.cli import finetune as jft_cli
    from modelcompression_tpu.models import save_weights as j_save
    from modelcompression_tpu_torch.cli import finetune as ft_cli
    text = jfx.tiny_region_cfg(num_classes=3, width=64, height=64)
    cfg = str(tmp_path / "net.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    text4 = jfx.tiny_region_cfg(num_classes=4, width=64, height=64)
    cfg4 = str(tmp_path / "net4.cfg")
    with open(cfg4, "w") as f:
        f.write(text4)
    paths = {}
    for name, t, seed in (("student", text, 0), ("teacher", text, 9),
                          ("teacher4", text4, 10)):
        paths[name] = str(tmp_path / f"{name}.weights")
        jspec = j_parse(t)
        j_save(paths[name], jspec, jax.tree.map(
            np.asarray, j_init(jspec, jax.random.key(seed))), seen=0)
    data = jfx.make_fake_voc(str(tmp_path / "d"), n_images=4,
                             image_size=64, seed=1)
    base = ["--cfg", cfg, "--weights", paths["student"], "--data", data,
            "--steps", "2", "--batch", "2", "--out",
            str(tmp_path / "o.weights"), "--distill", paths["teacher"]]
    assert ft_cli.main(base + ["--distill-weight", "0.5", "--distill-temp",
                               "2", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert "distilling from teacher" in captured.err
    assert "mAP@50" in captured.out
    bad = base[:-1] + [paths["teacher4"], "--distill-cfg", cfg4]
    for main, dev in ((jft_cli.main, []), (ft_cli.main, ["--device", "cpu"])):
        assert main(bad + dev) == 2
        assert "error: --distill: teacher head (5 anchors, 4 classes) " \
            "does not match student head (5, 3)" in capsys.readouterr().err
