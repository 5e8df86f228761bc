"""The port's multi-head [yolo] loss (modelcompression_tpu_torch/train/
yolo_loss.py) against the JAX package's on the same numpy inputs, and the
YOLOv3 / YOLOv4 train step against the JAX step.

Loss cases: MSE, GIoU, DIoU and CIoU; scale_x_y 1.05; iou_thresh 0.213
(multi-anchor assignment); a finite max_delta; cls_normalizer 2; duplicate
(cell, anchor) GT rows (the later row wins); no targets at all (M = 0).
Each case holds the loss and its parts within 1e-5 relative, and the
gradient with respect to each raw map (torch.autograd against jax.grad)
within 1e-5 of its largest magnitude: only the gradient shows a mistake in
the IoU branch's truncated chain rule. The train step: one fp32 SGD step
of the tiny v4 spec (CIoU) from the same params, the params within the
tolerances of tests/test_torch_train_step.py, and TrainConfig.remat
bit-equal to the plain step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.core.precision import BITMATCH as JAX_BITMATCH
from modelcompression_tpu.data.fixtures import tiny_yolo4_cfg as j_v4_cfg
from modelcompression_tpu.models import init_params as jax_init
from modelcompression_tpu.models import parse_cfg as jax_parse
from modelcompression_tpu.train import train_step as jts
from modelcompression_tpu.train.yolo_loss import yolo_loss as jax_loss
from modelcompression_tpu_torch.core.precision import BITMATCH
from modelcompression_tpu_torch.data.fixtures import (
    tiny_region_cfg, tiny_yolo3_cfg, tiny_yolo4_cfg,
)
from modelcompression_tpu_torch.models import params_from_jax, parse_cfg
from modelcompression_tpu_torch.train import (
    detection_loss, region_loss, train_step as tts,
)
from modelcompression_tpu_torch.train.yolo_loss import (
    _iou_box_penalty, yolo_loss,
)

C, B, M = 3, 2, 8
RTOL = 1e-5
CASES = {
    "mse": {},
    "mse_scale_x_y": dict(scale_x_y=1.05),
    "giou": dict(iou_loss="giou", iou_normalizer=0.07),
    "diou": dict(iou_loss="diou", iou_normalizer=0.07),
    "ciou": dict(iou_loss="ciou", iou_normalizer=0.07),
    "ciou_scale_x_y": dict(iou_loss="ciou", iou_normalizer=0.07,
                           scale_x_y=1.05),
    "ciou_max_delta": dict(iou_loss="ciou", iou_normalizer=0.5,
                           max_delta=0.05),
    "giou_iou_thresh": dict(iou_loss="giou", iou_normalizer=0.07,
                            iou_thresh=0.213),
    "mse_iou_thresh": dict(iou_thresh=0.213),
    "diou_cls_normalizer": dict(iou_loss="diou", iou_normalizer=0.07,
                                cls_normalizer=2.0),
    "mse_cls_normalizer": dict(cls_normalizer=2.0),
}


def _specs(**head):
    text = tiny_yolo3_cfg(num_classes=C)
    out = []
    for parse in (parse_cfg, jax_parse):
        sp = dataclasses.replace(parse(text))
        sp.layers = list(sp.layers)
        for i in sp.head_indices():
            sp.layers[i] = dataclasses.replace(sp.layers[i], **head)
        out.append(sp)
    return out


def _inputs(spec, seed):
    """Random raw maps and targets: valid boxes, an invalid (w == 0) row,
    and a row duplicating another's cell and (nearly) its shape, so the
    later row must win."""
    rng = np.random.default_rng(seed)
    heads = [spec.layers[i] for i in spec.head_indices()]
    grids = (spec.net.height // 8, spec.net.height // 4)
    raws = tuple(rng.normal(0, 1.5, (B, g, g, l.n * (5 + C)))
                 .astype(np.float32) for g, l in zip(grids, heads))
    t = np.zeros((B, M, 5), np.float32)
    for b in range(B):
        for m in (0, 2, 3, 5, 6):
            t[b, m] = [rng.integers(0, C), rng.uniform(0.05, 0.95),
                       rng.uniform(0.05, 0.95), rng.uniform(0.05, 0.8),
                       rng.uniform(0.05, 0.8)]
    t[:, 4] = t[:, 2] + np.array([1, 0.001, 0.001, 0.002, 0.002],
                                 np.float32)
    t[:, 4, 0] = (t[:, 2, 0] + 1) % C
    t[:, 1] = [2, 0.5, 0.5, 0.0, 0.3]  # invalid: w == 0
    return raws, t


def _torch_run(raws, t, spec):
    rs = [torch.from_numpy(r).requires_grad_(True) for r in raws]
    m = yolo_loss(rs, torch.from_numpy(t), spec)
    m.loss.backward()
    return ({k: float(v.detach()) for k, v in m.as_dict().items()},
            [r.grad.numpy() for r in rs])


def _jax_run(raws, t, spec):
    """The JAX loss and its gradient as one compiled program (eager JAX
    compiles each operation for each new shape)."""
    def f(rs, tt):
        m = jax_loss(rs, tt, spec)
        return m.loss, m.as_dict()

    (_, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        tuple(jnp.asarray(r) for r in raws), jnp.asarray(t))
    return ({k: float(v) for k, v in m.items()},
            [np.asarray(x) for x in g])


def _check(got, want):
    (gm, gg), (wm, wg) = got, want
    assert set(gm) == set(wm)
    for k in wm:
        assert gm[k] == pytest.approx(wm[k], rel=RTOL, abs=1e-6), k
    for i, (a, b) in enumerate(zip(gg, wg)):
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= RTOL * scale, (i, np.abs(a - b).max(),
                                                     scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_jax(case):
    tspec, jspec = _specs(**CASES[case])
    raws, t = _inputs(tspec, seed=sorted(CASES).index(case))
    got = _torch_run(raws, t, tspec)
    _check(got, _jax_run(raws, t, jspec))
    assert got[0]["n_gt"] == B * 6  # rows 0 and 2-6 are valid
    assert got[0]["loss_coord"] > 0 and got[0]["loss_cls"] > 0


@pytest.mark.parametrize("case", ["mse", "ciou"])
def test_no_targets_match_jax(case):
    tspec, jspec = _specs(**CASES[case])
    raws, _ = _inputs(tspec, seed=3)
    for empty in (np.zeros((B, M, 5), np.float32),
                  np.zeros((B, 0, 5), np.float32)):
        got = _torch_run(raws, empty, tspec)
        _check(got, _jax_run(raws, empty, jspec))
        assert got[0]["loss_coord"] == 0 and got[0]["n_gt"] == 0


def test_duplicate_rows_later_wins_as_jax():
    """Rows 2 and 4 share a cell and an anchor: only row 4's class is
    trained there, in both packages."""
    tspec, jspec = _specs()
    raws, t = _inputs(tspec, seed=7)
    t2 = t.copy()
    t2[:, 2] = 0.0  # drop the losing row: the loss must not change
    a, b = _torch_run(raws, t, tspec), _torch_run(raws, t2, tspec)
    assert a[0]["loss_cls"] == pytest.approx(b[0]["loss_cls"], rel=1e-6)
    _check(a, _jax_run(raws, t, jspec))


def test_loss_under_no_grad_keeps_iou_value():
    """The IoU branch takes its own gradient inside the loss, so a loss
    evaluated under no_grad (an eval of the loss) still works and has the
    same value."""
    tspec, _ = _specs(**CASES["ciou"])
    raws, t = _inputs(tspec, seed=1)
    rs = [torch.from_numpy(r) for r in raws]
    with torch.no_grad():
        a = yolo_loss(rs, torch.from_numpy(t), tspec)
    b = yolo_loss(rs, torch.from_numpy(t), tspec)
    assert float(a.loss) == float(b.loss) and float(a.loss_coord) > 0


@pytest.mark.parametrize("kind", ["giou", "diou", "ciou"])
def test_penalty_value_and_grad_match_jax(kind):
    """_iou_box_penalty alone: value and the convention-laden partials in
    the decoded box, on random boxes."""
    from modelcompression_tpu.train.yolo_loss import (
        _iou_box_penalty as jax_pen,
    )
    rng = np.random.default_rng(5)
    p = [rng.uniform(0.1, 0.9, 64).astype(np.float32) for _ in range(4)]
    tgt = [rng.uniform(0.1, 0.9, 64).astype(np.float32) for _ in range(4)]
    tp = [torch.from_numpy(x).requires_grad_(True) for x in p]
    val = _iou_box_penalty(kind, *tp, *map(torch.from_numpy, tgt)).sum()
    tg = torch.autograd.grad(val, tp)
    jv, jg = jax.value_and_grad(
        lambda *a: jnp.sum(jax_pen(kind, *a, *map(jnp.asarray, tgt))),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, p))
    assert float(val.detach()) == pytest.approx(float(jv), rel=RTOL)
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= RTOL * np.abs(b).max()


def test_rejections_as_jax():
    tspec, _ = _specs(truth_thresh=0.5)
    raws, t = _inputs(tspec, seed=0)
    with pytest.raises(ValueError, match="truth_thresh"):
        yolo_loss([torch.from_numpy(r) for r in raws], t, tspec)
    tspec, _ = _specs()
    with pytest.raises(ValueError, match="2 \\[yolo\\] heads"):
        yolo_loss([torch.from_numpy(raws[0])], t, tspec)
    tspec.layers[tspec.head_indices()[1]] = dataclasses.replace(
        tspec.layers[tspec.head_indices()[1]], anchors=(1.0, 1.0) * 6)
    with pytest.raises(ValueError, match="share one anchor list"):
        yolo_loss([torch.from_numpy(r) for r in raws], t, tspec)


def test_detection_loss_dispatches_by_family():
    tspec, _ = _specs()
    raws, t = _inputs(tspec, seed=2)
    rs = [torch.from_numpy(r) for r in raws]
    a = detection_loss(rs, t, tspec, 0)
    b = yolo_loss(rs, t, tspec)
    assert all(torch.equal(x, y) for x, y in zip(
        dataclasses.astuple(a), dataclasses.astuple(b)))
    rspec = parse_cfg(tiny_region_cfg(num_classes=3, width=64, height=64))
    raw = torch.zeros((1, 2, 2, 5 * 8))
    a = detection_loss(raw, torch.zeros((1, 2, 5)), rspec, 0)
    b = region_loss(raw, torch.zeros((1, 2, 5)), rspec.region, 0)
    assert float(a.loss) == float(b.loss)


# ---------------------------------------------------------- train step

SIZE, BATCH = 64, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    targets = np.zeros((BATCH, 8, 5), np.float32)
    for i in range(BATCH):
        targets[i, 0] = [rng.integers(0, 3), 0.5, 0.5, 0.6, 0.6]
        targets[i, 1] = [rng.integers(0, 3), 0.25, 0.25, 0.12, 0.12]
    return images, targets


def _trace(opt_state):
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if isinstance(opt_state, tuple):
        for s in opt_state:
            t = _trace(s)
            if t is not None:
                return t
    return None


def _step_setup(text, seed, **kw):
    jspec, tspec = jax_parse(text), parse_cfg(text)
    np_params = jax.tree.map(np.array, jax_init(jspec, jax.random.key(seed)))
    base = dict(augment_flip=False, augment_jitter=0.0, learning_rate=1e-3)
    base.update(kw)
    jcfg = jts.TrainConfig.from_spec(jspec, precision=JAX_BITMATCH, **base)
    tcfg = tts.TrainConfig.from_spec(tspec, precision=BITMATCH, **base)
    return jspec, tspec, np_params, jcfg, tcfg


def _torch_step(tspec, tcfg, np_params, images, targets):
    state = tts.TrainState.create(
        params_from_jax(np_params, tspec), tts.make_optimizer(tcfg),
        torch.Generator().manual_seed(1))
    state, m = tts.make_train_step(tspec, tcfg)(state, images, targets)
    return state, {k: float(v) for k, v in m.items()}


def _close_scaled(got, want, frac, what):
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= frac * scale, f"{what}: max err {err}, scale {scale}"


def _step_tensors(state):
    """{key/name: (param, momentum buffer)} as HWIO numpy."""
    opt = state["optimizer"]
    out = {}
    for k, p in state["params"].items():
        for n, v in p.items():
            if n in ("mean", "var"):
                continue
            a = [v.detach(), opt.state[v]["momentum_buffer"]]
            a = [t.double().numpy() for t in a]
            if a[0].ndim == 4:
                a = [t.transpose(2, 3, 1, 0) for t in a]
            out[f"{k}/{n}"] = a
    return out


def test_train_step_matches_jax():
    """One fp32 SGD step of the tiny v4 spec (CIoU heads) from the same
    params.

    Against the JAX step: every metric within 1e-4 relative, and the
    detection convs (the last conv of each head, no batch-stat BN below
    the loss) within tests/test_torch_train_step.py's tolerances: params
    1e-4 of the update plus 1e-6 of the param, momentum buffers (the
    gradients plus decay) 1e-4 of their largest magnitude. Every other
    tensor's gradient passes a batch-stat BN backward, whose terms nearly
    cancel at random init; there the JAX package's fp32 step on the CPU
    is farther than that from a float64 step (its BN statistics are
    E[y^2] - mu^2 in float32 with XLA's summation order), and the port's
    is not. So every tensor of the port's fp32 step is held to the port's
    float64 step from the same params, at the same tolerances."""
    text = j_v4_cfg(num_classes=3, iou_loss="ciou")
    assert text == tiny_yolo4_cfg(num_classes=3, iou_loss="ciou")
    jspec, tspec, np_params, jcfg, tcfg = _step_setup(text, seed=3)
    images, targets = _batch(seed=3)
    tx = jts.make_optimizer(jcfg)
    jstate = jts.TrainState.create(jax.tree.map(jnp.asarray, np_params), tx,
                                   jax.random.key(1))
    jstate, jm = jts.make_train_step(jspec, jcfg, tx)(
        jstate, jnp.asarray(images), jnp.asarray(targets))
    tstate, tm = _torch_step(tspec, tcfg, np_params, images, targets)
    for k, v in jm.items():
        assert tm[k] == pytest.approx(float(v), rel=1e-4, abs=1e-6), k
    f64 = dataclasses.replace(BITMATCH, name="float64",
                              compute_dtype=torch.float64,
                              param_dtype=torch.float64)
    p64 = {k: {n: v.double() for n, v in p.items()}
           for k, p in params_from_jax(np_params, tspec).items()}
    state64 = tts.TrainState.create(p64, tts.make_optimizer(
        dataclasses.replace(tcfg, precision=f64)),
        torch.Generator().manual_seed(1))
    state64, _ = tts.make_train_step(
        tspec, dataclasses.replace(tcfg, precision=f64))(
        state64, images, targets)
    jax_params = jax.tree.map(np.array, jstate["params"])
    jax_trace = jax.tree.map(np.array, _trace(jstate["opt_state"]))
    heads = {f"conv{i - 1}" for i in tspec.head_indices()}
    want64 = _step_tensors(state64)
    for key, (param, buf) in _step_tensors(tstate).items():
        k, n = key.split("/")
        if k in heads:
            ref = (jax_params[k][n], jax_trace[k][n])
        else:
            ref = want64[key]
        w0 = np_params[k][n]
        tol = 1e-4 * np.abs(ref[0] - w0).max() + 1e-6 * np.abs(ref[0]).max()
        assert np.abs(param - ref[0]).max() <= tol, f"param {key}"
        _close_scaled(buf, ref[1], 1e-4, f"momentum {key}")


def test_remat_step_bit_equal_to_plain():
    """TrainConfig.remat recomputes each conv block in the backward: on
    the CPU the step's loss, params, batch stats and gradients are the
    plain step's bit for bit (v4: mish, CSP split, two heads)."""
    text = tiny_yolo4_cfg(num_classes=3, iou_loss="ciou")
    _, tspec, np_params, _, tcfg = _step_setup(text, seed=4, subdivisions=2)
    images, targets = _batch(seed=4)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        state, m = _torch_step(tspec, cfg, np_params, images, targets)
        out[remat] = (m, {f"{k}/{n}": (v.detach().clone(),
                                       None if v.grad is None
                                       else v.grad.clone())
                          for k, p in state["params"].items()
                          for n, v in p.items()})
    assert out[False][0] == out[True][0]
    for key, (v, g) in out[False][1].items():
        rv, rg = out[True][1][key]
        assert torch.equal(v, rv), key
        assert (g is None and rg is None) or torch.equal(g, rg), key


def test_train_cli_trains_a_yolo_cfg(tmp_path):
    """The train CLI on the tiny v4 fixture (two CIoU [yolo] heads) from
    random init: finite logged losses, a checkpoint at the last step."""
    import json

    from modelcompression_tpu_torch.cli import train as train_cli
    from modelcompression_tpu_torch.data.fixtures import make_fake_voc
    from modelcompression_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )
    cfg = tmp_path / "v4.cfg"
    cfg.write_text(tiny_yolo4_cfg(num_classes=3, iou_loss="ciou"))
    data = make_fake_voc(str(tmp_path / "voc"), n_images=4, image_size=64)
    jl = tmp_path / "m.jsonl"
    assert train_cli.main(["--cfg", str(cfg), "--data", data, "--steps",
                           "2", "--batch", "2", "--max-boxes", "8",
                           "--checkpoint-dir", str(tmp_path / "ck"),
                           "--log-jsonl", str(jl), "--device", "cpu"]) == 0
    losses = [json.loads(line)["loss"] for line in open(jl)
              if json.loads(line)["prefix"] == "train"]
    assert losses and np.isfinite(losses).all()
    assert latest_checkpoint(str(tmp_path / "ck")).endswith("step_00000002")
