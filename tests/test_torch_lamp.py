"""The port's LAMP (modelcompression_tpu_torch/compress/lamp.py, prune
--mode lamp) against the JAX package's, on the CPU at fixture size, on a
net of 12 convs (keys conv0..conv11, so ``conv10`` sorts before ``conv2``
in the global concatenation).

Tolerance: the suffix sums are float32 cumsums, which XLA:CPU and
torch.cumsum associate differently; the scores agree within 2e-6
relative (measured: at most 3.3e-7 on these nets). The masks are equal
wherever no score lies within that tolerance of the cut (here: equal
everywhere), the zero count is exactly int(sparsity * n_total), and the
per-layer allocation (zeros per layer) is equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.compress import lamp as jl
from modelcompression_tpu.models import init_params as j_init
from modelcompression_tpu.models import parse_cfg as j_parse
from modelcompression_tpu.models import save_weights as j_save
from modelcompression_tpu_torch.cli import prune as tprune_cli
from modelcompression_tpu_torch.compress import lamp as tl
from modelcompression_tpu_torch.models import (
    load_weights, params_from_jax, parse_cfg,
)
from modelcompression_tpu_torch.ops import cuda_topk as ct

SCORE_RTOL = 2e-6

TWELVE_CONVS = """
[net]
width=32
height=32
channels=3
""" + "".join(f"""
[convolutional]
batch_normalize=1
filters={8 + 4 * (i % 3)}
size=3
stride=1
pad=1
activation=leaky
""" for i in range(11)) + """
[convolutional]
size=1
stride=1
pad=1
filters=40
activation=linear

[region]
anchors=1,1, 2,2, 3,3, 4,4, 5,5
classes=3
num=5
softmax=1
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net(seed):
    jspec, tspec = j_parse(TWELVE_CONVS), parse_cfg(TWELVE_CONVS)
    np_params = jax.tree.map(np.array, j_init(jspec, jax.random.key(seed)))
    return jspec, tspec, np_params


def _hwio(t):
    return t.permute(2, 3, 1, 0).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_scores_within_tolerance_of_jax(seed):
    jspec, tspec, np_params = _net(seed)
    want = jl.lamp_scores_device(jax.tree.map(jnp.asarray, np_params),
                                 jspec)
    got = tl.lamp_scores_device(params_from_jax(np_params, tspec), tspec)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(want[k]), _hwio(got[k])
        assert np.all(np.abs(b - a) <= SCORE_RTOL * np.abs(a)), k
        assert b.max() == 1.0  # the layer's largest weight


def _check_masks(jspec, tspec, np_params, sparsity):
    j_params = jax.tree.map(jnp.asarray, np_params)
    want = jl.lamp_masks(j_params, jspec, sparsity)
    got = tl.lamp_masks(params_from_jax(np_params, tspec), tspec, sparsity)
    assert list(got) == sorted(want)  # conv0, conv1, conv10, conv11, conv2
    scores = {k: np.asarray(v) for k, v in
              jl.lamp_scores_device(j_params, jspec).items()}
    cat = np.concatenate([scores[k].ravel() for k in sorted(scores)])
    n_zero = int(sparsity * cat.size)
    cut = np.sort(cat, kind="stable")[max(n_zero - 1, 0)]
    for k in want:
        differ = _hwio(got[k]) != np.asarray(want[k])
        near = np.abs(scores[k] - cut) <= SCORE_RTOL * cut
        assert not np.any(differ & ~near), k
    assert sum(int((~m).sum()) for m in got.values()) == n_zero
    # the allocation: per-layer zero counts equal; the sparsities, float32
    # means of different summation orders, within 1e-6
    assert {k: int((~m).sum()) for k, m in got.items()} == \
        {k: int((~np.asarray(m)).sum()) for k, m in want.items()}
    assert tl.lamp_layer_sparsities(got) == pytest.approx(
        jl.lamp_layer_sparsities(want), abs=1e-6)
    return got, want


@pytest.mark.parametrize("sparsity", [0.3, 0.75, 0.95])
def test_masks_zero_count_and_allocation_equal_jax(sparsity):
    got, want = _check_masks(*_net(2), sparsity)
    for k in want:
        assert np.array_equal(_hwio(got[k]), np.asarray(want[k])), k


def test_cut_in_the_unit_score_ties_follows_sorted_key_order():
    """Every layer's largest weight scores exactly 1.0: a cut that leaves 5
    of the 12 prunes the other 7 in the concatenation order, conv0,
    conv1, conv10, conv11, conv2, conv3, conv4, keeping conv5..conv9's."""
    jspec, tspec, np_params = _net(3)
    n_total = sum(p["w"].size for p in np_params.values())
    sparsity = (n_total - 5 + 0.5) / n_total
    got, _ = _check_masks(jspec, tspec, np_params, sparsity)
    kept = {k for k, m in got.items() if m.any()}
    assert kept == {f"conv{i}" for i in range(5, 10)}


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.95])
def test_prune_flat_cut_equals_stable_argsort_rank(sparsity):
    """The cut through prune_flat's plain versions (S = 2 with the padding
    segment) equals its definition, lamp_cut_plain, on the same scores."""
    _, tspec, np_params = _net(4)
    params = params_from_jax(np_params, tspec)
    keys = sorted(params)
    cat, sizes = tl._scores_layout(params, keys)
    n = sum(sizes)
    seg = ct._seg_ids_for(sizes, cat.numel(), False, 1, cat.device)
    got = ct.prune_flat(cat, seg, torch.tensor([int(sparsity * n), 0]), 2,
                        return_mask=True)[:n] != 0
    assert torch.equal(got, tl.lamp_cut_plain(cat[:n], int(sparsity * n)))


def test_prune_cli_lamp_and_sweep_write_jax_masks(tmp_path, capsys):
    """prune --mode lamp --sparsity 0.75 writes the weights the JAX masks
    give (the masked weights exactly the JAX-pruned ones) and prints the
    allocation line; --sweep writes one file per point."""
    jspec, tspec, np_params = _net(5)
    cfg = str(tmp_path / "net.cfg")
    with open(cfg, "w") as f:
        f.write(TWELVE_CONVS)
    weights = str(tmp_path / "w.weights")
    j_save(weights, jspec, np_params, seen=7)
    out = str(tmp_path / "lamp.weights")
    assert tprune_cli.main(["--cfg", cfg, "--weights", weights, "--mode",
                            "lamp", "--sparsity", "0.75", "--device", "cpu",
                            "--out", out]) == 0
    text = capsys.readouterr().out
    assert "lamp per-layer allocation: min" in text and "over 12 convs" in text
    got, seen = load_weights(out, tspec)
    assert seen == 7
    want = jl.lamp_masks(jax.tree.map(jnp.asarray, np_params), jspec, 0.75)
    for k, m in want.items():
        w = _hwio(got[k]["w"])
        assert np.array_equal(w != 0, np.asarray(m)), k
        assert np.array_equal(w[np.asarray(m)],
                              np_params[k]["w"][np.asarray(m)]), k
    assert tprune_cli.main(["--cfg", cfg, "--weights", weights, "--mode",
                            "lamp", "--sweep", "0.5,0.75", "--device", "cpu",
                            "--out", out]) == 0
    rows = capsys.readouterr().out
    for pct in (50, 75):
        assert f"lamp_{pct}.weights" in rows
        assert (tmp_path / f"lamp_{pct}.weights").exists()
