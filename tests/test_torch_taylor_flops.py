"""The port's FLOP-targeted allocation (modelcompression_tpu_torch/compress/
flops.py) and Taylor criterion (compress/taylor.py) against the JAX
package's, mirroring tests/test_flop_target.py and tests/test_taylor.py;
plus the prune CLI's taylor mode and ``finetune --iterate-mode taylor
--tied group`` against the JAX CLIs.

FLOPs: the per-layer accounting equals the JAX package's on every bundled
YOLOv2 / v3 / v4 cfg and the fixtures, and ``total_conv_flops`` of a
keep-set equals ``num_conv_flops`` of the repacked spec. The allocator
gives equal keep-sets and schedules from the same scores (tied groups, CSP
units, each score norm, a min-filters floor) and the same errors. Taylor
(fp32, BITMATCH): the scores within 1e-4 of the largest score of each
layer or group, and equal keep-sets, on the [region], v3 and v4
fixtures."""

import jax
import numpy as np
import pytest
import torch

from modelcompression_tpu import compress as jc
from modelcompression_tpu.cli import finetune as jax_finetune
from modelcompression_tpu.cli import prune as jax_prune
from modelcompression_tpu.data.fixtures import (
    make_fake_voc, tiny_region_cfg, tiny_yolo3_cfg, tiny_yolo4_cfg,
)
from modelcompression_tpu.models import init_params as jax_init
from modelcompression_tpu.models import parse_cfg as jax_parse
from modelcompression_tpu.models import save_weights as jax_save
from modelcompression_tpu_torch import compress as tc
from modelcompression_tpu_torch.cli import finetune, prune
from modelcompression_tpu_torch.models import (
    cfg_path, load_cfg, load_weights, num_conv_flops, params_from_jax,
    parse_cfg,
)

FIXTURES = {
    "region": lambda: tiny_region_cfg(num_classes=3, width=64, height=64),
    "v3": lambda: tiny_yolo3_cfg(num_classes=3),
    "v4": lambda: tiny_yolo4_cfg(num_classes=3),
}
BUNDLED = ("yolov2-voc.cfg", "tiny-yolo-voc.cfg", "yolov3-voc.cfg",
           "yolov3-tiny-voc.cfg", "yolov3-spp.cfg", "yolov4-voc.cfg",
           "yolov4-tiny-voc.cfg")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name, seed=0):
    text = FIXTURES[name]()
    jspec, tspec = jax_parse(text), parse_cfg(text)
    np_params = jax.tree.map(np.array, jax_init(jspec, jax.random.key(seed)))
    return jspec, tspec, np_params, params_from_jax(np_params, tspec)


def _same_keep(got, want):
    assert set(got) == set(want)
    for i in want:
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want[i]),
                                      err_msg=str(i))


# ---------------------------------------------------------------- FLOPs

@pytest.mark.parametrize("name", BUNDLED + tuple(FIXTURES))
def test_flop_accounting_matches_jax(name):
    text = (open(cfg_path(name)).read() if name.endswith(".cfg")
            else FIXTURES[name]())
    jspec, tspec = jax_parse(text), parse_cfg(text)
    assert tc.conv_flops_by_layer(tspec) == jc.conv_flops_by_layer(jspec)
    assert tc.total_conv_flops(tspec) == num_conv_flops(tspec)
    alive = {i: max(1, tspec.layers[i].filters // 3)
             for i in tc.prunable_conv_indices(tspec)[::2]}
    assert tc.total_conv_flops(tspec, alive) \
        == jc.total_conv_flops(jspec, alive)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_total_flops_equal_the_repacked_spec(name):
    _, tspec, _, tparams = _model(name)
    for fraction in (0.25, 0.5):
        keep = tc.uniform_filter_fraction_keep_sets(
            tspec, tparams, fraction,
            tied="group" if name == "v3" else "protect")
        slim, _ = tc.repack(tspec, tparams, keep)
        assert tc.total_conv_flops(
            tspec, {i: len(k) for i, k in keep.items()}) \
            == num_conv_flops(slim)


ALLOC = {
    "v3_l2": ("v3", dict(target=0.5)),
    "v3_group": ("v3", dict(target=0.35, groups=True)),
    "v3_group_mean_min2": ("v3", dict(target=0.5, groups=True, norm="mean",
                                      min_filters=2)),
    "v4_csp": ("v4", dict(target=0.5, csp=True)),
    "v4_csp_none": ("v4", dict(target=0.6, csp=True, norm="none")),
    "region_min3": ("region", dict(target=0.4, min_filters=3)),
}


@pytest.mark.parametrize("case", sorted(ALLOC))
def test_flop_targeted_keep_sets_match_jax(case):
    name, kw = ALLOC[case]
    jspec, tspec, np_params, tparams = _model(name)
    kw = dict(kw)
    args = {"target": kw.pop("target"),
            "min_filters": kw.pop("min_filters", 1),
            "norm": kw.pop("norm", "l2")}
    scores = {}
    for side, spec, params, c in (("jax", jspec, np_params, jc),
                                  ("torch", tspec, tparams, tc)):
        scores[side] = dict(
            scores=c.filter_scores_device(params, spec),
            group_scores=(c.tied_group_scores_device(params, spec)
                          if kw.get("groups") else None),
            csp_scores=(c.csp_balanced_scores_device(params, spec)
                        if kw.get("csp") else None))
    got = tc.flop_targeted_keep_sets(tspec, **scores["torch"], **args)
    want = jc.flop_targeted_keep_sets(jspec, **scores["jax"], **args)
    _same_keep(got[0], want[0])
    assert got[1] == want[1]
    slim, _ = tc.repack(tspec, tparams, got[0])
    fl = tc.total_conv_flops(tspec, {i: len(k) for i, k in got[0].items()})
    assert fl == num_conv_flops(slim)
    assert fl <= args["target"] * tc.total_conv_flops(tspec)


@pytest.mark.parametrize("target, match", [(0.01, "reachable floor"),
                                           (1.2, "must be in")])
def test_flop_target_errors_match_jax(target, match):
    jspec, tspec, np_params, tparams = _model("v3")
    errs = []
    for spec, params, c in ((jspec, np_params, jc), (tspec, tparams, tc)):
        with pytest.raises(ValueError, match=match) as e:
            c.flop_targeted_keep_sets(spec, c.filter_scores_device(
                params, spec), target)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# --------------------------------------------------------------- Taylor

def _batches(spec, seed, n=2, b=2, m=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.integers(0, 256, (b, spec.net.height, spec.net.width,
                                       3), dtype=np.uint8)
        targets = np.zeros((b, m, 5), np.float32)
        for bi in range(b):
            for j in range(2):
                cx, cy = rng.uniform(0.3, 0.7, 2)
                w, h = rng.uniform(0.2, 0.4, 2)
                targets[bi, j] = [rng.integers(0, 3), cx, cy, w, h]
        out.append((images, targets))
    return out


def _close_to_max(got, want, frac, what):
    assert set(got) == set(want), what
    for i in want:
        w = np.asarray(want[i], np.float64)
        g = np.asarray(got[i], np.float64)
        assert np.abs(g - w).max() <= frac * np.abs(w).max(), (what, i)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_taylor_scores_and_keep_sets_match_jax(name):
    jspec, tspec, np_params, tparams = _model(name, seed=2)
    batches = _batches(tspec, seed=3)
    # the squared form on one fixture: each JAX scoring call compiles anew
    for sq in (False, True) if name == "v3" else (False,):
        jall = jc.taylor_scores_all(np_params, jspec, batches, seen=0,
                                    second_moment=sq)
        tall = tc.taylor_scores_all(tparams, tspec, batches, seen=0,
                                    second_moment=sq)
        _close_to_max(tall[0], jall[0], 1e-4, "untied")
        _close_to_max(tall[1], jall[1], 1e-4, "groups")
        assert {i: p for i, (p, _) in tall[2].items()} \
            == {i: p for i, (p, _) in jall[2].items()}
        _close_to_max({i: s for i, (_, s) in tall[2].items()},
                      {i: s for i, (_, s) in jall[2].items()}, 1e-4, "csp")
    # tied='group' ranks the untied convs as 'protect' does, and the groups
    _same_keep(tc.taylor_filter_keep_sets(tparams, tspec, batches, 0.5,
                                          tied="group"),
               jc.taylor_filter_keep_sets(np_params, jspec, batches, 0.5,
                                          tied="group"))
    assert tc.taylor_gate_indices(tspec) == jc.taylor_gate_indices(jspec)
    untied, groups = tc.taylor_scores_with_groups(tparams, tspec, batches)
    assert set(untied) == set(tc.taylor_filter_scores_device(
        tparams, tspec, batches))
    for s in list(untied.values()) + list(groups.values()):
        assert np.linalg.norm(s) == pytest.approx(1.0, rel=1e-5)
    if name == "v3":
        assert set(groups) == {(2, 5)}


def test_taylor_needs_a_batch_and_a_tied_policy():
    _, tspec, _, tparams = _model("region")
    with pytest.raises(ValueError, match="at least one batch"):
        tc.taylor_filter_scores_device(tparams, tspec, [])
    with pytest.raises(ValueError, match="tied must be"):
        tc.taylor_filter_keep_sets(tparams, tspec, _batches(tspec, 0), 0.5,
                                   tied="x")


def test_taylor_takes_float_images_as_scaled():
    """uint8 images are scaled by 1/255; float images are taken as already
    scaled (the train step's convention): the same scores either way."""
    _, tspec, _, tparams = _model("v3", seed=1)
    batches = _batches(tspec, seed=2, n=1)
    want = tc.taylor_filter_scores_device(tparams, tspec, batches)
    scaled = [(torch.from_numpy(im).float() / 255.0, t) for im, t in batches]
    got = tc.taylor_filter_scores_device(tparams, tspec, scaled)
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])


def test_batch_stat_bn_stays_float64_at_float64():
    """The scoring forward's batch-stat BN keeps float64 at float64
    compute (its rsqrt too), so float64 scores compared across devices
    see no fp32 rounding."""
    from modelcompression_tpu_torch.core.precision import Precision
    from modelcompression_tpu_torch.models.darknet import conv_bn_act
    _, tspec, _, tparams = _model("v3", seed=3)
    f64 = Precision(name="float64", compute_dtype=torch.float64,
                    param_dtype=torch.float64)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, 16, 16)))
    p = {n: v.double() for n, v in tparams["conv0"].items()}
    p["gamma"] = torch.linspace(0.5, 1.5, p["gamma"].numel(),
                                dtype=torch.float64)
    got = conv_bn_act(x, p, tspec.layers[0], f64, train_stats=True)
    y = torch.nn.functional.conv2d(x, p["w"], padding=1)
    mu = y.mean(dim=(0, 2, 3), keepdim=True)
    var = (y - mu).square().mean(dim=(0, 2, 3), keepdim=True)
    want = torch.nn.functional.leaky_relu(
        (y - mu) / torch.sqrt(var + 1e-5) * p["gamma"][None, :, None, None]
        + p["beta"][None, :, None, None], 0.1)
    assert got.dtype == torch.float64
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()


def test_taylor_scores_under_no_grad():
    """The iterative loop scores inside torch.no_grad(): the gate
    gradients are taken all the same."""
    _, tspec, _, tparams = _model("v4", seed=1)
    batches = _batches(tspec, seed=1, n=1)
    want = tc.taylor_filter_scores_device(tparams, tspec, batches)
    with torch.no_grad():
        got = tc.taylor_filter_scores_device(tparams, tspec, batches)
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])


# ----------------------------------------------------------------- CLIs

@pytest.fixture(scope="module")
def cli_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("taylor_cli")
    text = FIXTURES["v3"]()
    cfg = str(tmp / "v3.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    weights = str(tmp / "v3.weights")
    jspec = jax_parse(text)
    jax_save(weights, jspec, jax.tree.map(
        np.asarray, jax_init(jspec, jax.random.key(4))), seen=0)
    data = make_fake_voc(str(tmp / "voc"), n_images=4, image_size=64)
    return cfg, weights, data


def _same_written(cfg_a, w_a, cfg_b, w_b):
    with open(cfg_a) as fa, open(cfg_b) as fb:
        assert fa.read() == fb.read()
    spec = load_cfg(cfg_b)
    got, gs = load_weights(w_a, spec)
    want, ws = load_weights(w_b, spec)
    assert gs == ws and set(got) == set(want)
    for k in want:
        for n in want[k]:
            assert torch.equal(got[k][n], want[k][n]), (k, n)


TAYLOR_CLI = {
    "fraction": ["--fraction", "0.5"],
    "tied_group": ["--fraction", "0.5", "--tied", "group", "--taylor-sq"],
    "target_flops_tied": ["--target-flops", "0.5", "--tied", "group"],
}


@pytest.mark.parametrize("case", sorted(TAYLOR_CLI))
def test_prune_cli_taylor_writes_what_jax_writes(cli_fixture, tmp_path,
                                                 case):
    cfg, weights, data = cli_fixture
    outs = {}
    for side, main, extra in (
            ("jax", jax_prune.main, ["--score-batches", "2",
                                     "--score-seed", "1"]),
            ("torch", prune.main, ["--taylor-batches", "2",
                                   "--taylor-seed", "1", "--device",
                                   "cpu"])):
        out = str(tmp_path / f"{side}.weights")
        assert main(["--cfg", cfg, "--weights", weights, "--mode", "taylor",
                     "--data", data, "--batch", "2", *TAYLOR_CLI[case],
                     *extra, "--out", out]) == 0
        outs[side] = out
    _same_written(str(tmp_path / "torch.cfg"), outs["torch"],
                  str(tmp_path / "jax.cfg"), outs["jax"])


def _train_precision(monkeypatch, jax_prec, torch_prec):
    """Both packages' TrainConfig.from_spec with ``precision`` set."""
    from modelcompression_tpu.train import TrainConfig as JaxConfig
    from modelcompression_tpu_torch.train import TrainConfig
    for cls, prec in ((JaxConfig, jax_prec), (TrainConfig, torch_prec)):
        real = cls.from_spec.__func__
        monkeypatch.setattr(cls, "from_spec", classmethod(
            lambda c, spec, _r=real, _p=prec, **kw:
            _r(c, spec, **{**kw, "precision": _p})))


def test_finetune_iterate_taylor_tied_group_writes_what_jax_writes(
        cli_fixture, tmp_path, monkeypatch):
    """One round at 0.5 with no fine-tune steps: the Taylor keep-sets of
    the v3 model (the tied group pruned as one) and the repacked weights
    and cfg equal the JAX CLI's; then one fine-tune step runs through the
    multi-head loss. The loop scores in the train config's precision,
    FAST by default, where the two packages' bf16 convs round differently
    and can reorder near-equal filters; so both CLIs run here with
    BITMATCH (fp32), as the other parity tests do."""
    from modelcompression_tpu.core.precision import BITMATCH as JAX_BITMATCH
    from modelcompression_tpu_torch.core.precision import BITMATCH
    _train_precision(monkeypatch, JAX_BITMATCH, BITMATCH)
    cfg, weights, data = cli_fixture
    base = ["--cfg", cfg, "--weights", weights, "--data", data, "--batch",
            "2", "--max-boxes", "8", "--iterate", "0.5", "--iterate-mode",
            "taylor", "--taylor-batches", "2", "--tied", "group"]
    outs = {}
    for side, main, extra in (("jax", jax_finetune.main, []),
                              ("torch", finetune.main,
                               ["--device", "cpu"])):
        out = str(tmp_path / f"{side}.weights")
        assert main(base + ["--steps", "0", "--out", out] + extra) == 0
        outs[side] = out
    _same_written(str(tmp_path / "torch.cfg"), outs["torch"],
                  str(tmp_path / "jax.cfg"), outs["jax"])
    slim = load_cfg(str(tmp_path / "torch.cfg"))
    assert slim.layers[2].filters == slim.layers[5].filters == 16
    out = str(tmp_path / "trained.weights")
    assert finetune.main(base + ["--steps", "1", "--out", out, "--device",
                                 "cpu"]) == 0
    params, _ = load_weights(out, load_cfg(str(tmp_path / "trained.cfg")))
    assert all(torch.isfinite(v).all() for p in params.values()
               for v in p.values())
