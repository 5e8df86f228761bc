"""The port's structured criteria (modelcompression_tpu_torch/compress/
criteria.py, repack.py) and the prune CLI's filter modes against the JAX
package's, mirroring tests/test_fpgm.py, test_slimming.py and
test_tied_pruning.py.

On the tiny v3 (one [shortcut] group), v4-tiny (CSP split) and [region]
fixtures, from the same numpy params (BN gammas drawn at random, so the
bn_gamma ranks are not index ties): the l1, bn_gamma and FPGM filter
scores, the tied-group and CSP scores within 1e-6 relative (FPGM 1e-5) of
the largest score, and every keep-set built from them equal. The tied
group's slimmed forward equals its masked forward. The prune CLI writes
the same .weights and cfg as the JAX CLI in every filter mode and tied
policy, and exits 2 on the same invalid flag combinations."""

import jax
import numpy as np
import pytest
import torch

from modelcompression_tpu import compress as jc
from modelcompression_tpu.cli import prune as jax_prune
from modelcompression_tpu.data.fixtures import (
    tiny_region_cfg, tiny_yolo3_cfg, tiny_yolo4_cfg,
)
from modelcompression_tpu.models import init_params as jax_init
from modelcompression_tpu.models import parse_cfg as jax_parse
from modelcompression_tpu.models import save_weights as jax_save
from modelcompression_tpu_torch import compress as tc
from modelcompression_tpu_torch.cli import prune
from modelcompression_tpu_torch.core.precision import BITMATCH
from modelcompression_tpu_torch.models import (
    forward, load_cfg, load_weights, params_from_jax, parse_cfg,
)

CRITERIA = ("l1", "bn_gamma", "fpgm")
FIXTURES = {
    "v3": lambda: tiny_yolo3_cfg(num_classes=3),
    "v4": lambda: tiny_yolo4_cfg(num_classes=3),
    "region": lambda: tiny_region_cfg(num_classes=3, width=64, height=64),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(jspec, seed):
    """JAX init params with BN gammas, betas and running stats drawn from
    numpy."""
    params = jax.tree.map(np.array, jax_init(jspec, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for p in params.values():
        if "gamma" in p:
            n = p["gamma"].shape[0]
            p["gamma"] = rng.uniform(-1.5, 1.5, n).astype(np.float32)
            p["beta"] = rng.normal(0, 0.1, n).astype(np.float32)
            p["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            p["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return params


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def model(request):
    text = FIXTURES[request.param]()
    jspec, tspec = jax_parse(text), parse_cfg(text)
    np_params = _np_params(jspec, seed=sorted(FIXTURES).index(request.param))
    return request.param, text, jspec, tspec, np_params, \
        params_from_jax(np_params, tspec)


def _close(got, want, rtol, what, slack=None):
    """Within ``rtol`` of the largest score, plus ``slack[i]`` per entry
    where given."""
    assert set(got) == set(want), what
    for i in want:
        w = np.asarray(want[i], np.float64)
        g = np.asarray(got[i], np.float64)
        assert g.shape == w.shape, (what, i)
        scale = max(np.abs(w).max(), 1e-30)
        tol = rtol * scale + np.asarray((slack or {}).get(i, 0.0))
        assert (np.abs(g - w) <= tol).all(), (what, i,
                                              np.abs(g - w).max(), scale)


def _fpgm_self_rounding(np_params):
    """{conv idx: (O,)} bound on the JAX FPGM score's self-distance term:
    its Gram form gives sqrt(|2||F||^2 - 2 F.F|), the square root of fp32
    rounding over D terms, where the port (and the definition) has 0."""
    out = {}
    for k, p in np_params.items():
        x = p["w"].reshape(-1, p["w"].shape[-1]).T.astype(np.float64)
        sq = (x * x).sum(1)
        out[int(k[4:])] = np.sqrt(2 * x.shape[1] * 2.0 ** -23 * 2 * sq)
    return out


def _same_keep(got, want, what):
    assert set(got) == set(want), what
    for i in want:
        np.testing.assert_array_equal(np.asarray(got[i]),
                                      np.asarray(want[i]), err_msg=str(i))


@pytest.mark.parametrize("criterion", CRITERIA)
def test_scores_and_keep_sets_match_jax(model, criterion):
    name, _, jspec, tspec, np_params, tparams = model
    rtol = 1e-5 if criterion == "fpgm" else 1e-6
    slack = _fpgm_self_rounding(np_params) if criterion == "fpgm" else {}
    _close(tc.filter_scores_device(tparams, tspec, criterion),
           jc.filter_scores_device(np_params, jspec, criterion), rtol,
           "filter scores", slack)
    tg = tc.tied_group_scores_device(tparams, tspec, criterion)
    _close(tg, jc.tied_group_scores_device(np_params, jspec, criterion),
           rtol, "tied group scores",
           {g: sum(slack.get(i, 0.0) for i in g) for g in tg})
    tcsp = tc.csp_balanced_scores_device(tparams, tspec, criterion)
    jcsp = jc.csp_balanced_scores_device(np_params, jspec, criterion)
    assert {i: p for i, (p, _) in tcsp.items()} \
        == {i: p for i, (p, _) in jcsp.items()}
    _close({i: s for i, (_, s) in tcsp.items()},
           {i: s for i, (_, s) in jcsp.items()}, rtol, "csp scores", slack)
    for fraction in (0.25, 0.5):
        for tied in ("protect", "group"):
            _same_keep(tc.uniform_filter_fraction_keep_sets(
                           tspec, tparams, fraction, criterion=criterion,
                           tied=tied),
                       jc.uniform_filter_fraction_keep_sets(
                           jspec, np_params, fraction, criterion=criterion,
                           tied=tied), (fraction, tied))
        _same_keep(tc.tied_group_keep_sets(tparams, tspec, fraction,
                                           criterion=criterion),
                   jc.tied_group_keep_sets(np_params, jspec, fraction,
                                           criterion=criterion), "tied")
    sched = {i: 0.5 for i in list(jc.filter_scores_device(
        np_params, jspec, criterion))[:2]}
    _same_keep(tc.l1_filter_keep_sets_scheduled(
                   tparams, tspec, sched, default=0.25, criterion=criterion),
               jc.l1_filter_keep_sets_scheduled(
                   np_params, jspec, sched, default=0.25,
                   criterion=criterion), "scheduled")
    if name == "v3":
        assert set(tc.tied_group_keep_sets(tparams, tspec, 0.5)) == {2, 5}
    if name == "v4":
        assert tcsp  # the CSP split's source conv is scored


def test_fpgm_filter_scores_match_jax_and_numpy():
    """One layer's FPGM scores against the JAX function and a float64
    numpy oracle of the distance sums, including near-identical filters
    (where the Gram form cancels)."""
    rng = np.random.default_rng(3)
    w = rng.normal(0, 1, (16, 8, 3, 3)).astype(np.float32)
    w[5] = w[4] + 1e-3 * rng.normal(0, 1, (8, 3, 3)).astype(np.float32)
    x = w.reshape(16, -1).astype(np.float64)
    oracle = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).sum(1)
    got = tc.fpgm_filter_scores(torch.from_numpy(w)).numpy()
    want = np.asarray(jc.fpgm_filter_scores(w.transpose(2, 3, 1, 0)))
    assert np.abs(got - oracle).max() <= 1e-5 * oracle.max()
    self_rounding = np.sqrt(2 * x.shape[1] * 2.0 ** -23 * 2 * (x * x).sum(1))
    assert (np.abs(got - want) <= 1e-5 * want.max() + self_rounding).all()
    assert np.array_equal(np.argsort(got, kind="stable"),
                          np.argsort(want, kind="stable"))


def test_bn_gamma_falls_back_to_scaled_l1_without_bn():
    """A conv without BN (the detection conv) scores by its L1 over its
    largest L1 under bn_gamma, as in the JAX package."""
    text = tiny_region_cfg(num_classes=3, width=64, height=64)
    jspec, spec = jax_parse(text), parse_cfg(text)
    np_params = _np_params(jspec, 5)
    params = params_from_jax(np_params, spec)
    last = spec.conv_indices()[-1]
    assert not spec.layers[last].batch_normalize
    got = tc.criteria._criterion_scores(params, spec, [last], "bn_gamma")
    want = jc.criteria._criterion_scores(np_params, jspec, [last],
                                         "bn_gamma")
    _close(got, want, 1e-6, "bn_gamma fallback")
    l1 = tc.l1_filter_scores(params[f"conv{last}"]["w"]).numpy()
    np.testing.assert_allclose(got[last], l1 / l1.max(), rtol=1e-6)


def test_tied_group_slimmed_equals_masked():
    """Repacking the shared keep-set of the v3 group gives the masked
    forward's raw maps: the [shortcut] add stays channel-aligned."""
    text = tiny_yolo3_cfg(num_classes=3)
    spec = parse_cfg(text)
    params = params_from_jax(_np_params(jax_parse(text), 7), spec)
    keep = tc.uniform_filter_fraction_keep_sets(spec, params, 0.5,
                                                tied="group")
    assert np.array_equal(keep[2], keep[5]) and len(keep[2]) == 16
    slim_spec, slim = tc.repack(spec, params, keep)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    masks = tc.channel_masks_from_keep(spec, keep)
    want = forward(params, x, spec, BITMATCH, channel_masks=masks)
    got = forward(slim, x, slim_spec, BITMATCH)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5)
    bad = dict(keep)
    bad[5] = keep[5][::-1][:15]
    with pytest.raises(ValueError, match="shortcut"):
        tc.repack(spec, params, bad)


def test_unknown_criterion_and_tied_rejected():
    text = tiny_yolo3_cfg(num_classes=3)
    spec = parse_cfg(text)
    params = params_from_jax(_np_params(jax_parse(text), 1), spec)
    with pytest.raises(ValueError, match="unknown filter criterion"):
        tc.filter_scores_device(params, spec, "lamp")
    with pytest.raises(ValueError, match="unknown filter criterion"):
        tc.tied_group_scores_device(params, spec, "taylor")
    with pytest.raises(ValueError, match="tied must be"):
        tc.uniform_filter_fraction_keep_sets(spec, params, 0.5, tied="x")


# ------------------------------------------------------------ prune CLI

@pytest.fixture(scope="module")
def cli_models(tmp_path_factory):
    """The v3 and v4 fixtures written by the JAX package, random BN."""
    tmp = tmp_path_factory.mktemp("structured_cli")
    out = {}
    for name in ("v3", "v4"):
        text = FIXTURES[name]()
        cfg = str(tmp / f"{name}.cfg")
        with open(cfg, "w") as f:
            f.write(text)
        weights = str(tmp / f"{name}.weights")
        jax_save(weights, jax_parse(text), _np_params(jax_parse(text), 11),
                 seen=0)
        out[name] = (cfg, weights)
    return out


def _run_both(cfg, weights, extra, tmp_path):
    rcs, dirs = {}, {}
    for side, main, dev in (("jax", jax_prune.main, []),
                            ("torch", prune.main, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        rcs[side] = main(["--cfg", cfg, "--weights", weights, *extra,
                          "--out", str(d / "out.weights")] + dev)
        dirs[side] = d
    return rcs, dirs


def _assert_same_outputs(dirs):
    with open(dirs["torch"] / "out.cfg") as f:
        got_cfg = f.read()
    with open(dirs["jax"] / "out.cfg") as f:
        assert got_cfg == f.read()
    spec = load_cfg(str(dirs["jax"] / "out.cfg"))
    got, gs = load_weights(str(dirs["torch"] / "out.weights"), spec)
    want, ws = load_weights(str(dirs["jax"] / "out.weights"), spec)
    assert gs == ws and set(got) == set(want)
    for k in want:
        for n in want[k]:
            assert torch.equal(got[k][n], want[k][n]), (k, n)


CLI_CASES = {
    "bn_gamma": ("v3", ["--mode", "bn_gamma", "--fraction", "0.5"]),
    "fpgm": ("v4", ["--mode", "fpgm", "--fraction", "0.5"]),
    "l1_tied_group": ("v3", ["--mode", "l1_filter", "--fraction", "0.5",
                             "--tied", "group"]),
    "fpgm_tied_group": ("v3", ["--mode", "fpgm", "--fraction", "0.25",
                               "--tied", "group"]),
    "bn_gamma_fractions": ("v4", ["--mode", "bn_gamma", "--fractions",
                                  "0:0.25,3:0.5"]),
    "bn_gamma_target_flops": ("v4", ["--mode", "bn_gamma", "--target-flops",
                                     "0.5"]),
    "l1_target_flops_tied": ("v3", ["--mode", "l1_filter", "--target-flops",
                                    "0.6", "--tied", "group",
                                    "--min-filters", "2"]),
    "fpgm_target_flops_mean": ("v3", ["--mode", "fpgm", "--target-flops",
                                      "0.5", "--score-norm", "mean"]),
    "fpgm_sweep_tied": ("v3", ["--mode", "fpgm", "--tied", "group",
                               "--sweep", "0.5"]),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_prune_cli_filter_modes_write_what_jax_writes(cli_models, tmp_path,
                                                      case, capsys):
    name, extra = CLI_CASES[case]
    cfg, weights = cli_models[name]
    rcs, dirs = _run_both(cfg, weights, extra, tmp_path)
    assert rcs == {"jax": 0, "torch": 0}
    if "--sweep" in extra:
        for d in dirs.values():
            (d / "out_50.weights").rename(d / "out.weights")
            (d / "out_50.cfg").rename(d / "out.cfg")
    _assert_same_outputs(dirs)
    if "--target-flops" in extra:
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if "discovered schedule" in ln or "GFLOP/img" in ln]
        assert len(lines) == 4 and lines[:2] == lines[2:]


USAGE = {
    "no_fraction": ["--mode", "fpgm"],
    "flops_and_fraction": ["--mode", "bn_gamma", "--target-flops", "0.5",
                           "--fraction", "0.5"],
    "tied_with_fractions": ["--mode", "l1_filter", "--tied", "group",
                            "--fractions", "0:0.5"],
    "fraction_range": ["--mode", "fpgm", "--fraction", "1.0"],
    "taylor_without_data": ["--mode", "taylor", "--fraction", "0.5"],
    "flops_unreachable": ["--mode", "l1_filter", "--target-flops", "0.01"],
    "flops_range": ["--mode", "fpgm", "--target-flops", "1.5"],
    "bad_fractions": ["--mode", "bn_gamma", "--fractions", "9:0.5"],
}


@pytest.mark.parametrize("case", sorted(USAGE))
def test_prune_cli_invalid_combinations_exit_as_jax(cli_models, tmp_path,
                                                    capsys, case):
    cfg, weights = cli_models["v3"]
    rcs, dirs = _run_both(cfg, weights, USAGE[case], tmp_path)
    assert rcs == {"jax": 2, "torch": 2}
    err = [ln for ln in capsys.readouterr().err.splitlines()
           if ln.startswith("error:")]
    assert len(err) == 2 and err[0] == err[1], err
    assert not (dirs["torch"] / "out.weights").exists()
