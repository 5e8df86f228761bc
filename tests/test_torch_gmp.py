"""The port's gradual magnitude pruning (modelcompression_tpu_torch/
compress/gmp.py) and its train step against the JAX package's, on the
CPU at fixture size.

Tolerances: the schedule's sparsity and every zero count are bit-equal to
the jitted JAX function; masks are equal; the GMP train step is held as
tests/test_torch_train_step.py holds the plain step (metrics 1e-4
relative; params within 1e-4 of the update's largest magnitude + 1e-6 of
the param's), with its masks equal at every step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.compress import gmp as jg
from modelcompression_tpu.data.fixtures import tiny_region_cfg
from modelcompression_tpu.models import init_params as j_init
from modelcompression_tpu.models import parse_cfg as j_parse
from modelcompression_tpu.train import train_step as jts
from modelcompression_tpu_torch.cli import finetune as ft_cli
from modelcompression_tpu_torch.compress import gmp as tg
from modelcompression_tpu_torch.models import (
    load_cfg, load_weights, params_from_jax, params_to_jax, parse_cfg,
)
from modelcompression_tpu_torch.train import train_step as tts
from tests.test_torch_train_step import (
    SIZE, _batch, _compare, _copied, _np, _setup, _trace,
)

SPECS = {  # (final, initial): dyadic and non-dyadic ramps
    "dyadic": (0.75, 0.0), "nondyadic": (0.7, 0.1), "small": (0.33, 0.05)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net(seed=0):
    text = tiny_region_cfg(num_classes=3, width=SIZE, height=SIZE)
    jspec, tspec = j_parse(text), parse_cfg(text)
    np_params = jax.tree.map(np.array, j_init(jspec, jax.random.key(seed)))
    return jspec, tspec, np_params


def _hwio(m):
    return m.permute(2, 3, 1, 0).numpy()


@pytest.mark.parametrize("case", sorted(SPECS))
def test_sparsity_and_zero_counts_bit_equal_jit(case):
    final, initial = SPECS[case]
    kw = dict(final_sparsity=final, initial_sparsity=initial, begin=3,
              end=17, frequency=4)
    jspec_g, tspec_g = jg.GMPSpec(**kw), tg.GMPSpec(**kw)
    sizes = [27 * 16, 144 * 8, 1000, 50634592]

    @jax.jit
    def jax_counts(step):
        s = jg.gmp_sparsity(step, jspec_g)
        per = jnp.floor(s * jnp.asarray(sizes, jnp.float32)).astype(
            jnp.int32)
        return s, per, jnp.floor(s * sum(sizes)).astype(jnp.int32)

    for step in range(-1, 17 + 3):
        s, per, glob = jax_counts(step)
        got = tg.gmp_sparsity(step, tspec_g)
        assert np.asarray(s).tobytes() == np.float32(got).tobytes(), step
        assert tg.gmp_zero_counts(sizes, got) == np.asarray(per).tolist()
        assert tg.gmp_zero_counts(sizes, got, per_layer=False) == \
            [int(glob)]
        assert tg.gmp_due(tspec_g, step) == (
            3 <= step <= 17 and ((step - 3) % 4 == 0 or step == 17))


def test_spec_validation_matches_jax():
    for kw in (dict(final_sparsity=1.0),
               dict(final_sparsity=0.5, initial_sparsity=0.6),
               dict(final_sparsity=0.5, begin=4, end=4),
               dict(final_sparsity=0.5, frequency=0),
               dict(final_sparsity=0.5, initial_sparsity=-0.1)):
        with pytest.raises(ValueError):
            jg.GMPSpec(**kw)
        with pytest.raises(ValueError):
            tg.GMPSpec(**kw)


@pytest.mark.parametrize("per_layer", [True, False])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.75, 0.3])
def test_masks_equal_jax(per_layer, sparsity):
    jspec, tspec, np_params = _net(seed=1)
    s = np.float32(sparsity)
    want = jg.gmp_masks(jax.tree.map(jnp.asarray, np_params), jspec,
                        jnp.float32(s), per_layer=per_layer)
    got = tg.gmp_masks(params_from_jax(np_params, tspec), tspec, s,
                       per_layer=per_layer)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.bool
        assert np.array_equal(_hwio(got[k]), np.asarray(want[k])), k


def test_mask_update_tick_offtick_and_missing_masks():
    jspec, tspec, np_params = _net()
    params = params_from_jax(np_params, tspec)
    g = tg.GMPSpec(final_sparsity=0.5, begin=0, end=10, frequency=5)
    masks = tg.gmp_init_masks(params, tspec, g)
    out = tg.gmp_mask_update(g, tspec, params, masks, 3)  # off tick
    assert all(bool(m.all()) for m in out.values())
    g2 = dataclasses.replace(g, frequency=7)  # end off the tick grid
    out = tg.gmp_mask_update(g2, tspec, params, masks, 10)
    want = jg.gmp_mask_update(
        jg.GMPSpec(final_sparsity=0.5, begin=0, end=10, frequency=7),
        jspec, jax.tree.map(jnp.asarray, np_params),
        jg.gmp_init_masks(np_params, jspec, jg.GMPSpec(0.5, end=10)),
        jnp.int32(10))
    for k in want:
        assert np.array_equal(_hwio(out[k]), np.asarray(want[k])), k
    with pytest.raises(ValueError, match="gmp_init_masks"):
        tg.gmp_mask_update(g, tspec, params, {}, 0)


def test_once_pruned_never_reenters_on_exact_zero_ties():
    """tests/test_gmp.py's tie case: after a prune at s, a surviving weight
    with a smaller HWIO index than a pruned one is driven to exactly 0 and
    the masks recomputed at the same s. The index tie break alone would
    re-admit the later pruned weight; the intersection keeps it out, as in
    the JAX package (the masks equal its masks)."""
    jspec, tspec, np_params = _net()
    g_kw = dict(final_sparsity=0.5, begin=0, end=100, frequency=1)
    jgs, tgs = jg.GMPSpec(**g_kw), tg.GMPSpec(**g_kw)
    j_params = jax.tree.map(jnp.asarray, np_params)
    j_masks = jg.gmp_mask_update(jgs, jspec, j_params,
                                 jg.gmp_init_masks(j_params, jspec, jgs),
                                 jnp.int32(100))
    t_params = params_from_jax(np_params, tspec)
    t_masks = tg.gmp_mask_update(tgs, tspec, t_params,
                                 tg.gmp_init_masks(t_params, tspec, tgs),
                                 100)
    key = next(iter(j_masks))
    m0 = np.asarray(j_masks[key]).ravel()
    assert np.array_equal(_hwio(t_masks[key]).ravel(), m0)
    w = np.array(np_params[key]["w"], np.float32).ravel()
    w[~m0] = 0.0
    p_last = int(np.nonzero(~m0)[0][-1])
    kept_before = np.nonzero(m0[:p_last])[0]
    w[int(kept_before[0])] = 0.0
    tied = dict(np_params, **{key: dict(np_params[key],
                                        w=w.reshape(np_params[key]["w"]
                                                    .shape))})
    j_out = jg.gmp_mask_update(jgs, jspec, jax.tree.map(jnp.asarray, tied),
                               j_masks, jnp.int32(100))
    t_out = tg.gmp_mask_update(tgs, tspec, params_from_jax(tied, tspec),
                               t_masks, 100)
    for k in j_masks:
        new, old = _hwio(t_out[k]), _hwio(t_masks[k])
        assert not np.any(new & ~old), f"{k}: pruned weight re-entered"
        assert np.array_equal(new, np.asarray(j_out[k])), k
    assert not _hwio(t_out[key]).ravel()[p_last]


def _run_gmp(jspec, tspec, np_params, jcfg, tcfg, n_steps):
    """n steps of each package's GMP step on the same batch: per step the
    metrics, params, masks (HWIO numpy) and, for the port, the grads and
    momentum buffers."""
    tx = jts.make_optimizer(jcfg)
    j_params = jax.tree.map(jnp.asarray, np_params)
    jstate = jts.TrainState.create(
        j_params, tx, jax.random.key(1),
        weight_masks=jg.gmp_init_masks(j_params, jspec, jcfg.gmp))
    jstep = jts.make_train_step(jspec, jcfg, tx)
    t_params = params_from_jax(np_params, tspec)
    tstate = tts.TrainState.create(
        t_params, tts.make_optimizer(tcfg), torch.Generator().manual_seed(1),
        weight_masks=tg.gmp_init_masks(t_params, tspec, tcfg.gmp))
    tstep = tts.make_train_step(tspec, tcfg)
    images, targets = _batch()
    jres, tres = [], []
    for _ in range(n_steps):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(targets))
        jres.append({"metrics": {k: float(v) for k, v in jm.items()},
                     "params": jax.tree.map(np.array, jstate["params"]),
                     "trace": jax.tree.map(np.array,
                                           _trace(jstate["opt_state"])),
                     "masks": {k: np.asarray(m) for k, m in
                               jstate["weight_masks"].items()}})
        tstate, tm = tstep(tstate, images, targets)
        p, opt = tstate["params"], tstate["optimizer"]
        tres.append({
            "metrics": {k: float(v) for k, v in tm.items()},
            "params": _copied(params_to_jax(p)),
            "grads": {k: {n: _np(v.grad) for n, v in q.items()
                          if v.grad is not None} for k, q in p.items()},
            "bufs": {k: {n: _np(opt.state[v]["momentum_buffer"])
                         for n, v in q.items() if v in opt.state}
                     for k, q in p.items()},
            "masks": {k: _hwio(m) for k, m in
                      tstate["weight_masks"].items()}})
    return jres, tres


@pytest.mark.parametrize("per_layer", [True, False])
@pytest.mark.parametrize("case", ["dyadic", "nondyadic"])
def test_gmp_train_step_matches_jax(per_layer, case):
    """Three steps, a recompute at each (begin 0, end 2, frequency 1): at
    every step the masks are equal to the JAX step's, the pruned weights
    exactly 0 and the metrics (sparsity included) within 1e-4; the first
    two steps' updates, gradients and momentum within the step tolerance
    (a third step's update is small next to the drift of two, which that
    tolerance does not cover); the last zero counts at least floor(f32(s)
    * f32(n)) (more only in exact-zero ties)."""
    final, initial = SPECS[case]
    kw = dict(final_sparsity=final, initial_sparsity=initial, begin=0,
              end=2, frequency=1, per_layer=per_layer)
    jspec, tspec, np_params, jcfg, tcfg = _setup(seed=5)
    jcfg = dataclasses.replace(jcfg, gmp=jg.GMPSpec(**kw))
    tcfg = dataclasses.replace(tcfg, gmp=tg.GMPSpec(**kw))
    jres, tres = _run_gmp(jspec, tspec, np_params, jcfg, tcfg, 3)
    prev = np_params
    for i, (j, t) in enumerate(zip(jres, tres)):
        for k in j["masks"]:
            assert np.array_equal(t["masks"][k], j["masks"][k]), (i, k)
            assert (t["params"][k]["w"][~t["masks"][k]] == 0).all(), (i, k)
        if i < 2:  # the two steps test_torch_train_step.py compares
            _compare(t, j, tcfg.decay, prev, check_grads=i == 0)
        for k, v in j["metrics"].items():
            assert t["metrics"][k] == pytest.approx(v, rel=1e-4,
                                                    abs=1e-6), (i, k)
        prev = j["params"]
    s = tg.gmp_sparsity(2, tcfg.gmp)
    sizes = [m.size for m in tres[-1]["masks"].values()]
    zeros = [int((~m).sum()) for m in tres[-1]["masks"].values()]
    want = tg.gmp_zero_counts(sizes, s, per_layer)
    if per_layer:
        assert all(z >= w for z, w in zip(zeros, want))
    else:
        assert sum(zeros) >= want[0]
    assert tres[-1]["metrics"]["sparsity"] == pytest.approx(
        sum(zeros) / sum(sizes), rel=1e-6)


def test_finetune_gmp_cli(tmp_path, capsys):
    """finetune --gmp on the CPU: the final sparsity is baked into the
    written weights and printed; the JAX CLI's --gmp-end / --gmp-begin
    bounds exit 2 with its words."""
    from modelcompression_tpu.cli import finetune as jft_cli
    from modelcompression_tpu.data.fixtures import make_fake_voc
    from modelcompression_tpu.models import save_weights as j_save
    text = tiny_region_cfg(num_classes=3, width=SIZE, height=SIZE)
    cfg = str(tmp_path / "net.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    jspec = j_parse(text)
    weights = str(tmp_path / "w.weights")
    j_save(weights, jspec, jax.tree.map(
        np.asarray, j_init(jspec, jax.random.key(3))), seen=0)
    data = make_fake_voc(str(tmp_path / "d"), n_images=4, image_size=SIZE,
                         seed=2)
    out = str(tmp_path / "out.weights")
    base = ["--cfg", cfg, "--weights", weights, "--data", data,
            "--batch", "2", "--subdivisions", "1", "--out", out]
    assert ft_cli.main(base + ["--steps", "3", "--gmp", "0.5",
                               "--gmp-freq", "1", "--device", "cpu"]) == 0
    text_out = capsys.readouterr().out
    assert "gmp: final sparsity 50.00%" in text_out
    got, _ = load_weights(out, load_cfg(cfg))
    for p in got.values():
        assert int((p["w"] == 0).sum()) == int(np.floor(
            np.float32(0.5) * np.float32(p["w"].numel())))
    for extra, message in (
            (["--steps", "4", "--gmp-end", "4"], "--gmp-end 4 is past"),
            (["--steps", "4", "--gmp-begin", "3"], "--gmp-begin 3 leaves"),
            (["--steps", "4", "--gmp-initial", "0.6"], "--gmp:")):
        for main, dev in ((jft_cli.main, []),
                          (ft_cli.main, ["--device", "cpu"])):
            assert main(base + extra + ["--gmp", "0.5"] + dev) == 2
            assert message in capsys.readouterr().err
