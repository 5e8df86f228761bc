"""The port's mask backends and prune CLI (modelcompression_tpu_torch/
compress/backend.py, cli/prune.py) against the JAX package's, mirroring
tests/test_mask_backend.py: the selector maps each name to its function,
the CLI defaults to the kernel route, and ``prune.main([..., '--device',
'cpu'])`` writes the same ``.weights`` (and cfg) as the JAX CLI on the
same input. Weights are compared exactly: the masks and keep-sets are
rank rules, and a masked weight is a copy or a zero."""

import jax
import numpy as np
import pytest
import torch

from modelcompression_tpu.cli import prune as jax_prune
from modelcompression_tpu.data.fixtures import tiny_region_cfg
from modelcompression_tpu.models import init_params as jax_init_params
from modelcompression_tpu.models import parse_cfg as jax_parse_cfg
from modelcompression_tpu.models import save_weights as jax_save_weights
from modelcompression_tpu_torch.cli import prune
from modelcompression_tpu_torch.compress import (
    DEFAULT_MASK_BACKEND, criteria, magnitude_mask_fn,
)
from modelcompression_tpu_torch.models import load_cfg, load_weights
from modelcompression_tpu_torch.ops import cuda_topk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny; one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_selector_maps_backends_to_exact_functions():
    assert DEFAULT_MASK_BACKEND == "fused"
    for backend in ("fused", "pallas"):
        assert magnitude_mask_fn("magnitude", backend) \
            is cuda_topk.magnitude_masks_perlayer
        assert magnitude_mask_fn("global", backend) \
            is cuda_topk.magnitude_masks_global
    assert magnitude_mask_fn("magnitude") is cuda_topk.magnitude_masks_perlayer
    assert magnitude_mask_fn("magnitude", "reference") \
        is criteria.magnitude_masks_perlayer
    assert magnitude_mask_fn("global", "reference") \
        is criteria.magnitude_masks_global
    with pytest.raises(ValueError):
        magnitude_mask_fn("l1_filter")
    with pytest.raises(ValueError):
        magnitude_mask_fn("magnitude", "cuda")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A tiny region model written by the JAX package."""
    tmp = tmp_path_factory.mktemp("prune_cli")
    text = tiny_region_cfg(num_classes=3, width=64, height=64)
    cfg = str(tmp / "net.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    spec = jax_parse_cfg(text)
    weights = str(tmp / "w.weights")
    jax_save_weights(weights, spec, jax.tree.map(
        np.asarray, jax_init_params(spec, jax.random.key(0))), seen=0)
    return cfg, weights


def _assert_same_weights(cfg, got_path, want_path):
    spec = load_cfg(cfg)
    got, got_seen = load_weights(got_path, spec)
    want, want_seen = load_weights(want_path, spec)
    assert got_seen == want_seen and set(got) == set(want)
    for k in want:
        assert set(got[k]) == set(want[k])
        for name in want[k]:
            assert torch.equal(got[k][name], want[k][name]), (k, name)


# (extra argv, output stems written: (weights, cfg or None))
CLI_CASES = {
    "magnitude": (["--mode", "magnitude", "--sparsity", "0.5"],
                  [("out", None)]),
    "global": (["--mode", "global", "--sparsity", "0.75"], [("out", None)]),
    "global_reference": (["--mode", "global", "--sparsity", "0.6",
                          "--mask-backend", "reference"], [("out", None)]),
    "magnitude_pallas": (["--mode", "magnitude", "--sparsity", "0.9",
                          "--use-pallas"], [("out", None)]),
    "l1_filter": (["--mode", "l1_filter", "--fraction", "0.5"],
                  [("out", "out")]),
    "l1_fractions": (["--mode", "l1_filter", "--fractions", "0:0.25,2:0.5"],
                     [("out", "out")]),
    "magnitude_sweep": (["--mode", "magnitude", "--sweep", "0.25,0.75"],
                        [("out_25", None), ("out_75", None)]),
    "l1_sweep": (["--mode", "l1_filter", "--sweep", "0.5"],
                 [("out_50", "out_50")]),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_prune_cli_writes_what_the_jax_cli_writes(model, tmp_path, case):
    cfg, weights = model
    extra, outputs = CLI_CASES[case]
    runs = {}
    for side, main, device in (("jax", jax_prune.main, []),
                               ("torch", prune.main, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        assert main(["--cfg", cfg, "--weights", weights, *extra,
                     "--out", str(d / "out.weights")] + device) == 0
        runs[side] = d
    for stem, cfg_stem in outputs:
        out_cfg = cfg
        if cfg_stem:
            out_cfg = str(runs["jax"] / f"{cfg_stem}.cfg")
            with open(runs["torch"] / f"{cfg_stem}.cfg") as f:
                got_cfg = f.read()
            with open(out_cfg) as f:
                assert got_cfg == f.read()
        _assert_same_weights(out_cfg, str(runs["torch"] / f"{stem}.weights"),
                             str(runs["jax"] / f"{stem}.weights"))


def test_prune_cli_defaults_to_the_kernel_route(model, tmp_path,
                                                monkeypatch):
    cfg, weights = model
    calls = []
    for mod, name in ((cuda_topk, "magnitude_masks_perlayer"),
                      (cuda_topk, "magnitude_masks_global"),
                      (criteria, "magnitude_masks_perlayer")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _tag=(mod.__name__, name), **kw):
            calls.append(_tag)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    for mode in ("magnitude", "global"):
        assert prune.main(["--cfg", cfg, "--weights", weights, "--mode",
                           mode, "--sparsity", "0.5", "--device", "cpu",
                           "--out", str(tmp_path / f"{mode}.weights")]) == 0
    assert [n for _, n in calls] == ["magnitude_masks_perlayer",
                                     "magnitude_masks_global"]
    assert all(m == cuda_topk.__name__ for m, _ in calls)


# the modes this test rejected, naming ROADMAP Queue 1 item 6, before they
# were ported (the test keeps its name): each now writes the JAX CLI's
# files byte for byte
PORTED_SINCE = {
    "lamp": ["--mode", "lamp", "--sparsity", "0.5"],
    "lowrank": ["--mode", "lowrank", "--energy", "0.7", "--max-cost", "10"],
}


@pytest.mark.parametrize("case", sorted(PORTED_SINCE))
def test_not_ported_paths_exit_2_naming_their_item(model, tmp_path, capsys,
                                                   case):
    cfg, weights = model
    outs = []
    for name, main, dev in (("jax", jax_prune.main, []),
                            ("port", prune.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}.weights"
        assert main(["--cfg", cfg, "--weights", weights, *PORTED_SINCE[case],
                     "--out", str(out), *dev]) == 0
        assert "not ported" not in capsys.readouterr().err
        outs.append(out)
    assert outs[0].read_bytes() == outs[1].read_bytes()
    if case == "lowrank":
        assert outs[0].with_suffix(".cfg").read_text() == \
            outs[1].with_suffix(".cfg").read_text()


@pytest.mark.parametrize("extra, message", [
    (["--mode", "magnitude"], "--sparsity is required"),
    (["--mode", "global", "--sparsity", "1.0"], "must be in [0, 1)"),
    # the JAX CLI's message; the id is the test's from before
    # --target-flops was ported
    pytest.param(["--mode", "l1_filter"],
                 "--fraction, --fractions or --target-flops is required",
                 id="extra2---fraction or --fractions is required"),
    (["--mode", "l1_filter", "--fractions", "1:0.5"], "bad --fractions"),
    (["--mode", "magnitude", "--sweep", "0.5,1.5"], "out of [0, 1)"),
])
def test_bad_values_exit_2(model, tmp_path, capsys, extra, message):
    cfg, weights = model
    rc = prune.main(["--cfg", cfg, "--weights", weights, *extra,
                     "--device", "cpu", "--out",
                     str(tmp_path / "out.weights")])
    assert rc == 2
    assert message in capsys.readouterr().err
