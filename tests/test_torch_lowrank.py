"""The port's low-rank factorization (modelcompression_tpu_torch/compress/
lowrank.py, prune --mode lowrank) against the JAX package's, on the CPU.

Both run the same numpy SVD on the same HWIO matrices, so the rewritten
cfg (``dump_cfg`` text), the factored weights and the report are equal
bit for bit, and the two prune CLIs write identical files. The factored
forward (BITMATCH, fp32) agrees with the JAX package's within 1e-4 of the
map's largest magnitude (the two packages' convs sum in other orders);
at full rank the port's factored forward equals its unfactored one within
5e-4 of the largest magnitude (float roundoff of the split)."""

import jax
import numpy as np
import pytest
import torch

from modelcompression_tpu.cli import prune as jprune_cli
from modelcompression_tpu.compress import lowrank as jlr
from modelcompression_tpu.core.precision import BITMATCH as J_BITMATCH
from modelcompression_tpu.data.fixtures import tiny_region_cfg
from modelcompression_tpu.models import dump_cfg as j_dump
from modelcompression_tpu.models import forward as j_forward
from modelcompression_tpu.models import init_params as j_init
from modelcompression_tpu.models import parse_cfg as j_parse
from modelcompression_tpu.models import save_weights as j_save
from modelcompression_tpu_torch.cli import prune as tprune_cli
from modelcompression_tpu_torch.compress import lowrank as tlr
from modelcompression_tpu_torch.core.precision import BITMATCH
from modelcompression_tpu_torch.models import (
    dump_cfg, forward, init_params, params_from_jax, params_to_jax,
    parse_cfg,
)
from modelcompression_tpu_torch.models.zoo import cfg_path

NET = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(seed=0):
    text = tiny_region_cfg(num_classes=3, width=NET, height=NET)
    jspec, tspec = j_parse(text), parse_cfg(text)
    np_params = jax.tree.map(np.array, j_init(jspec, jax.random.key(seed)))
    return jspec, tspec, np_params


def _factor_both(jspec, tspec, np_params, **kw):
    want = jlr.factor_network(np_params, jspec, **kw)
    got = tlr.factor_network(params_from_jax(np_params, tspec), tspec, **kw)
    return want, got


def _assert_equal(want, got):
    (jspec2, jparams2, jrep), (tspec2, tparams2, trep) = want, got
    assert dump_cfg(tspec2) == j_dump(jspec2)
    assert [vars(e) for e in trep] == [vars(e) for e in jrep]
    tp = params_to_jax(tparams2)
    assert sorted(tp) == sorted(jparams2)
    for k, p in jparams2.items():
        assert sorted(tp[k]) == sorted(p)
        for n, a in p.items():
            assert tp[k][n].dtype == np.float32
            assert np.array_equal(tp[k][n], np.asarray(a)), (k, n)


@pytest.mark.parametrize("kw", [
    dict(energy=0.5), dict(energy=0.9, max_cost=10.0),
    dict(energy=1e-6, ranks={2: 3, 6: 2}, max_cost=10.0),
], ids=["energy0.5", "energy0.9-maxcost10", "surgical"])
def test_factor_network_bit_equal_jax(kw):
    jspec, tspec, np_params = _tiny(1)
    want, got = _factor_both(jspec, tspec, np_params, **kw)
    assert got[2], "the case must factor something"
    _assert_equal(want, got)


def test_yolov2_route_reorg_remap_bit_equal_jax():
    """Two 1x1 convs before YOLOv2's route targets, factored at full rank
    (the JAX package's index-surgery case): the rewritten cfg with its
    remapped routes and the weights equal the JAX package's; the port's
    factored forward (64 px) equals its unfactored one."""
    with open(cfg_path("yolov2-voc.cfg")) as f:
        text = f.read()
    text = text.replace("width=416", "width=64").replace("height=416",
                                                          "height=64")
    jspec, tspec = j_parse(text), parse_cfg(text)
    np_params = params_to_jax(init_params(tspec, seed=0))
    c1x1 = [i for i in tspec.conv_indices()
            if tspec.layers[i].size == 1][:2]
    ranks = {i: min(tspec.layers[i].in_channels, tspec.layers[i].filters)
             for i in c1x1}
    want, got = _factor_both(jspec, tspec, np_params, ranks=ranks,
                             energy=1e-6, max_cost=100.0)
    _assert_equal(want, got)
    tspec2, tparams2, _ = got
    assert len(tspec2.layers) == len(tspec.layers) + 2
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 64, 64, 3)).astype(np.float32))
    y0 = forward(params_from_jax(np_params, tspec), x, tspec, BITMATCH)
    y1 = forward(tparams2, x, tspec2, BITMATCH)
    assert (y1 - y0).abs().max() <= 5e-4 * y0.abs().max()


def test_factored_forward_matches_jax():
    jspec, tspec, np_params = _tiny(2)
    (jspec2, jparams2, _), (tspec2, tparams2, _) = _factor_both(
        jspec, tspec, np_params, energy=0.8, max_cost=10.0)
    x = np.random.default_rng(4).normal(size=(2, NET, NET, 3)).astype(
        np.float32)
    want = np.asarray(j_forward(jax.tree.map(jax.numpy.asarray, jparams2),
                                jax.numpy.asarray(x), jspec2, J_BITMATCH))
    got = forward(tparams2, torch.from_numpy(x), tspec2, BITMATCH).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_helpers_and_errors_match_jax():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    for r in (1, 3, 6):
        for a, b in zip(jlr.factor_conv_weight(w, r),
                        tlr.factor_conv_weight(w, r)):
            assert np.array_equal(a, b)
    s = np.linalg.svd(w.reshape(-1, 6).astype(np.float64), compute_uv=False)
    for e in (1e-6, 0.3, 0.9, 1.0):
        assert tlr.rank_for_energy(s, e) == jlr.rank_for_energy(s, e)
    jspec, tspec, np_params = _tiny()
    for i in tspec.conv_indices():
        assert tlr.breakeven_rank(tspec.layers[i]) == \
            jlr.breakeven_rank(jspec.layers[i])
    for ranks, message in (({1: 2}, "not a conv layer"),
                           ({0: 0}, "explicit rank must be >= 1")):
        with pytest.raises(ValueError, match=message):
            jlr.factor_network(np_params, jspec, ranks=ranks)
        with pytest.raises(ValueError, match=message):
            tlr.factor_network(params_from_jax(np_params, tspec), tspec,
                               ranks=ranks)
    with pytest.raises(ValueError, match="energy"):
        tlr.rank_for_energy(s, 0.0)


def test_prune_cli_lowrank_writes_the_jax_files(tmp_path, capsys):
    jspec, _, np_params = _tiny(3)
    cfg = str(tmp_path / "net.cfg")
    with open(cfg, "w") as f:
        f.write(tiny_region_cfg(num_classes=3, width=NET, height=NET))
    weights = str(tmp_path / "w.weights")
    j_save(weights, jspec, np_params, seen=11)
    outs = {}
    for name, main, dev in (("jax", jprune_cli.main, []),
                            ("port", tprune_cli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.weights")
        assert main(["--cfg", cfg, "--weights", weights, "--mode",
                     "lowrank", "--energy", "0.6", "--max-cost", "10",
                     "--out", out, *dev]) == 0
        outs[name] = (out, capsys.readouterr().out)
    for suffix in (".weights", ".cfg"):
        paths = [o[:-len(".weights")] + suffix for o, _ in outs.values()]
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read(), suffix
    assert [l for l in outs["port"][1].splitlines() if "conv" in l] == \
        [l for l in outs["jax"][1].splitlines() if "conv" in l]
    for extra, message in ((["--sweep", "0.5"], "lowrank mode selects"),
                           (["--rank", "1:2"], "not a conv layer"),
                           (["--rank", "x"], "bad --rank"),
                           (["--energy", "0"], "--energy must be in")):
        assert tprune_cli.main(["--cfg", cfg, "--weights", weights,
                                "--mode", "lowrank", "--device", "cpu",
                                "--out", str(tmp_path / "e.weights"),
                                *extra]) == 2
        assert message in capsys.readouterr().err
