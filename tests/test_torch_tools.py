"""The port's user tools (``modelcompression_tpu_torch/tools``, and
``cli/profile_train``) against the repository's JAX tools and functions,
on the CPU at fixture size.

* Anchors, partial weights and the low-rank scan are host numpy in both
  packages: the k-means and IoU arrays, the ``anchors =`` line, the
  written ``.weights`` bytes and the printed table are EQUAL.
* The sensitivity scan and the sweeps evaluate: both sides run BITMATCH
  (fp32, BN unfolded), where the port's mAP is within 1e-6 of the JAX
  package's (``test_torch_eval.py``), at ``map_iou`` 0.1 so that random or
  barely trained weights score above 0. The sensitivity matrix as printed
  (two decimals) is equal cell for cell. The sweeps' masks and keep-sets
  are equal to the JAX functions' on the same params (the port's, carried
  across by ``models/convert.py``), and the first pruned mAP is within
  1e-6 of the JAX package's on the JAX-pruned params. Fine-tuned rows are
  checked for form only: training runs in bf16 and diverges from a JAX
  run.
* ``bitmatch_check --device cpu`` holds the CPU against itself: bit-equal.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from modelcompression_tpu import evaluation as jeval
from modelcompression_tpu.compress import apply_masks as j_apply_masks
from modelcompression_tpu.compress import lamp_masks as j_lamp_masks
from modelcompression_tpu.compress import (
    magnitude_masks_global as j_masks_global,
)
from modelcompression_tpu.compress import (
    magnitude_masks_perlayer as j_masks_perlayer,
)
from modelcompression_tpu.compress import repack as j_repack
from modelcompression_tpu.compress import (
    uniform_filter_fraction_keep_sets as j_uniform_keep,
)
from modelcompression_tpu.core.precision import BITMATCH as J_BITMATCH
from modelcompression_tpu.data import fixtures as jfx
from modelcompression_tpu.data import voc as jvoc
from modelcompression_tpu.models import parse_cfg as j_parse
from modelcompression_tpu_torch import evaluation as teval
from modelcompression_tpu_torch.core.precision import BITMATCH
from modelcompression_tpu_torch.models import init_params as t_init
from modelcompression_tpu_torch.models import params_to_jax
from modelcompression_tpu_torch.models import parse_cfg as t_parse
from modelcompression_tpu_torch.models import save_weights as t_save
from modelcompression_tpu_torch.tools import (
    bitmatch_check, gen_anchors, lowrank_scan, partial_weights,
    sensitivity_scan, sweep_fixture, sweep_l1_iterative,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import gen_anchors as j_anchors  # noqa: E402
import lowrank_scan as j_lowrank  # noqa: E402
import partial_weights as j_partial  # noqa: E402
import sensitivity_scan as j_sensitivity  # noqa: E402

MAP_IOU = 0.1
MAP_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The tiny region net at 64x64 (the port's random init, seed 0)
    written as ``.weights`` by the port's codec, which both packages'
    tools read, and a 4-image fixture."""
    tmp = tmp_path_factory.mktemp("tools")
    text = jfx.tiny_region_cfg(num_classes=3, width=64, height=64)
    cfg = str(tmp / "net.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    spec = j_parse(text)
    weights = str(tmp / "w.weights")
    t_save(weights, t_parse(text), t_init(t_parse(text), seed=0),
           seen=12345)
    data = jfx.make_fake_voc(str(tmp / "d"), n_images=4, image_size=64,
                             seed=13)
    return {"tmp": tmp, "cfg": cfg, "weights": weights, "data": data,
            "spec": spec}


def _bitmatch(monkeypatch):
    """Both packages' EvalConfig made BITMATCH, BN unfolded, mAP at IoU
    0.1, for the tools that build their own."""
    monkeypatch.setattr(jeval, "EvalConfig", functools.partial(
        jeval.EvalConfig, precision=J_BITMATCH, fold_bn=False,
        map_iou=MAP_IOU))
    monkeypatch.setattr(teval, "EvalConfig", functools.partial(
        teval.EvalConfig, precision=BITMATCH, fold_bn=False,
        map_iou=MAP_IOU))


def _out(capsys, fn, argv):
    assert fn(argv) == 0
    return capsys.readouterr().out


# --- anchors, partial weights, low-rank scan: host numpy, equal ----------

def test_kmeans_and_shape_iou_equal_jax_tool():
    rng = np.random.default_rng(3)
    wh = np.abs(rng.normal(3.0, 1.5, (500, 2))) + 0.05
    for k, seed in ((5, 0), (9, 7), (3, 1)):
        got = gen_anchors.kmeans_iou(wh, k, seed=seed)
        want = j_anchors.kmeans_iou(wh, k, seed=seed)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gen_anchors.shape_iou(wh, got),
                                      j_anchors.shape_iou(wh, want))


@pytest.mark.parametrize("extra", [[], ["--pixels", "--num", "4"]])
def test_gen_anchors_line_equals_jax_tool(model, capsys, extra):
    argv = ["--data", model["data"], "--num", "3"] + extra
    want = _out(capsys, j_anchors.main, argv)
    got = _out(capsys, gen_anchors.main, argv + ["--device", "cpu"])
    assert got == want and "anchors = " in got


def test_partial_weights_byte_equal_jax_tool(model, capsys):
    outs = {}
    for name, fn, extra in (("jax", j_partial.main, []),
                            ("torch", partial_weights.main,
                             ["--device", "cpu"])):
        outs[name] = str(model["tmp"] / f"{name}.conv.3")
        assert fn(["--cfg", model["cfg"], "--weights", model["weights"],
                   "--n-convs", "3", "--out", outs[name]] + extra) == 0
    with open(outs["jax"], "rb") as a, open(outs["torch"], "rb") as b:
        assert a.read() == b.read()
    assert partial_weights.main(["--cfg", model["cfg"], "--weights",
                                 model["weights"], "--n-convs", "99",
                                 "--device", "cpu"]) == 2


def test_lowrank_scan_table_equals_jax_tool(model, capsys):
    argv = ["--cfg", model["cfg"], "--weights", model["weights"],
            "--energies", "0.5,0.9,0.99"]
    want = _out(capsys, j_lowrank.main, argv)
    got = _out(capsys, lowrank_scan.main, argv + ["--device", "cpu"])
    assert got == want and "E=0.9:" in got


# --- sensitivity scan ------------------------------------------------------

def test_sensitivity_scan_cells_equal_jax_tool(model, capsys, monkeypatch):
    """Two convs x two fractions: every printed line equal (the baseline
    and each cell at two decimals), with some cell above 0."""
    _bitmatch(monkeypatch)
    convs = model["spec"].conv_indices()
    argv = ["--cfg", model["cfg"], "--weights", model["weights"],
            "--data", model["data"], "--batch", "2", "--fractions",
            "0.25,0.75", "--layers", f"{convs[0]},{convs[2]}"]
    want = _out(capsys, j_sensitivity.main, argv)
    got = _out(capsys, sensitivity_scan.main, argv + ["--device", "cpu"])
    assert got.splitlines() == want.splitlines()
    rows = [l for l in got.splitlines() if l.startswith("conv[")]
    assert len(rows) == 2
    cells = [float(v) for r in rows for v in r.split(")", 1)[1].split()]
    assert len(cells) == 4 and max(cells) > 0.0
    assert sensitivity_scan.main(argv[:-1] + [str(convs[-1]), "--device",
                                              "cpu"]) == 2


# --- sweeps ----------------------------------------------------------------

def _j_eval_config():
    return jeval.EvalConfig(precision=J_BITMATCH, fold_bn=False,
                            map_iou=MAP_IOU, **sweep_fixture.EVAL)


def _j_fixture(tmp):
    data = jfx.make_fake_voc(str(tmp), n_images=16,
                             image_size=sweep_fixture.NET, seed=0)
    return jvoc.load_list_dataset(jvoc.read_data_cfg(data)["valid"])


J_MASK_FNS = {"magnitude": j_masks_perlayer, "global": j_masks_global,
              "lamp": j_lamp_masks}


@pytest.mark.parametrize("criterion", sweep_fixture.MASK_FNS)
def test_sweep_fixture_masks_and_pruned_map_equal_jax(criterion, tmp_path,
                                                     capsys, monkeypatch):
    """2 base steps, 1 fine-tune step: each sparsity's masks equal the
    JAX function's on the trained params, the achieved sparsity is the
    rule's, the first pruned mAP is the JAX package's; every row is
    finite."""
    _bitmatch(monkeypatch)
    r = sweep_fixture.run(criterion, torch.device("cpu"), base_steps=2,
                          tune_steps=1)
    lines = capsys.readouterr().out.splitlines()
    jspec = j_parse(jfx.tiny_region_cfg(num_classes=3, width=96, height=96))
    jparams = params_to_jax(r["params"])
    assert lines[0] == f"criterion: {criterion}"
    assert len(lines) == 2 + len(sweep_fixture.SPARSITIES)
    n_total = sum(np.asarray(p["w"]).size for p in jparams.values())
    masks_fn = jax.jit(functools.partial(J_MASK_FNS[criterion], spec=jspec),
                       static_argnames="sparsity")
    for row, line in zip(r["rows"], lines[2:]):
        jm = masks_fn(jparams, sparsity=row["sparsity"])
        assert jm.keys() == row["masks"].keys()
        for k, m in row["masks"].items():
            np.testing.assert_array_equal(m.permute(2, 3, 1, 0).numpy(),
                                          np.asarray(jm[k]), err_msg=k)
        zeros = sum(int((~m).sum()) for m in row["masks"].values())
        if criterion == "magnitude":
            assert zeros == sum(int(row["sparsity"] * m.numel())
                                for m in row["masks"].values())
        else:
            assert zeros == int(row["sparsity"] * n_total)
        assert 0.0 <= row["pruned"] <= 1.0 and 0.0 <= row["tuned"] <= 1.0
        assert line.startswith(f"sparsity {row['sparsity']:.0%} (achieved")
    first = r["rows"][0]
    want = jeval.evaluate(
        j_apply_masks(jparams, masks_fn(jparams,
                                        sparsity=first["sparsity"])),
        jspec, _j_fixture(tmp_path), jfx.FIXTURE_CLASSES,
        _j_eval_config()).map50
    assert first["pruned"] > 0.0 and abs(first["pruned"] - want) <= MAP_TOL


def test_sweep_l1_iterative_keep_sets_and_pruned_map_equal_jax(
        tmp_path, capsys, monkeypatch):
    """v2, l1, 2 base steps and 1 step a round: each round's keep-sets
    equal the JAX function's on the round's params, the widths shrink as
    the schedule says, and round 0's pruned mAP is the JAX package's."""
    _bitmatch(monkeypatch)
    r = sweep_l1_iterative.run("v2", "l1", base_steps=2, round_steps=1,
                               device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "family: v2  criterion: l1"
    assert len(r["rounds"]) == len(sweep_l1_iterative.FRACTIONS)
    first_widths = []
    for ridx, (rd, line) in enumerate(zip(r["rounds"], lines[2:])):
        jspec = j_parse(sweep_l1_iterative.FAMILY_CFGS["v2"](1)) \
            if ridx == 0 else j_spec
        jparams = params_to_jax(rd["params_before"])
        want = j_uniform_keep(jspec, jparams, rd["inc"], criterion="l1")
        assert want.keys() == rd["keep"].keys()
        for i in want:
            np.testing.assert_array_equal(np.asarray(rd["keep"][i]),
                                          np.asarray(want[i]), err_msg=i)
        j_spec, j_pruned = j_repack(jspec, jparams, want)
        if ridx == 0:
            m = jeval.evaluate(j_pruned, j_spec, _j_fixture(tmp_path),
                               jfx.FIXTURE_CLASSES, _j_eval_config()).map50
            assert rd["pruned"] > 0.0 and abs(rd["pruned"] - m) <= MAP_TOL
        first_widths.append(rd["spec"].layers[0].filters)
        assert j_spec.layers[0].filters == first_widths[-1]
        assert 0.0 <= rd["recovered"] <= 1.0
        assert line.startswith(f"round {ridx}: cum {rd['fraction']:.0%}")
    assert first_widths == [12, 8, 4]


# --- bitmatch check, profile_train ----------------------------------------

def test_bitmatch_check_runs_on_cpu(capsys):
    out = _out(capsys, bitmatch_check.main, ["--device", "cpu"])
    assert "raw feature map: bit-equal=True" in out
    assert "count mismatch=0" in out
    r = bitmatch_check.run(torch.device("cpu"))
    assert r["max_abs"] == 0.0 and r["map_delta"] == 0.0
    assert r["cpu_detections"] == r["device_detections"] > 0


def test_profile_train_stage_table_on_cpu(capsys, monkeypatch, tmp_path):
    """The stage table and the trace's top operations on a small region
    net in place of YOLOv2-VOC (the CPU cannot time the real one)."""
    import modelcompression_tpu_torch.models as tmodels
    from modelcompression_tpu_torch.cli import profile_train
    from modelcompression_tpu_torch.data.fixtures import tiny_region_cfg
    monkeypatch.setattr(tmodels, "yolov2_voc", lambda: tmodels.parse_cfg(
        tiny_region_cfg(num_classes=20, width=64, height=64)))
    out = _out(capsys, profile_train.main,
               ["--device", "cpu", "--batch", "2", "--inner", "1",
                "--trace", str(tmp_path / "tr")])
    for name in ("aug", "fwd", "loss", "bwd", "full"):
        assert any(l.startswith(f"{name:5s}:") and "ms/step" in l
                   for l in out.splitlines()), name
    assert "backward alone" in out and "top cpu (self) ops" in out
    assert os.path.exists(tmp_path / "tr" / "trace.json")
    assert profile_train.main(["--device", "cpu", "--batch", "2",
                               "--stages", "nope"]) == 2


def test_fixture_tables_runs_each_tool_with_its_own_steps(monkeypatch,
                                                         capsys):
    """Each run calls its tool's main with the JAX tool's flags (their
    step counts by default) and reports its wall time."""
    from modelcompression_tpu_torch.tools import fixture_tables
    calls = []
    monkeypatch.setattr(sweep_fixture, "main",
                        lambda argv: calls.append(("fixture", argv)) or 0)
    monkeypatch.setattr(sweep_l1_iterative, "main",
                        lambda argv: calls.append(("l1", argv)) or 0)
    monkeypatch.setattr(fixture_tables, "_sensitivity",
                        lambda device: calls.append(("scan", device)) or 0)
    out = _out(capsys, fixture_tables.main, ["--device", "cpu"])
    dev = ["--device", "cpu"]
    assert calls == [("fixture", ["--criterion", "magnitude"] + dev),
                     ("l1", ["--family", "v2"] + dev),
                     ("l1", ["--family", "v4", "--chmul", "2"] + dev),
                     ("l1", ["--criterion", "taylor"] + dev),
                     ("scan", "cpu")]
    lines = out.splitlines()
    assert lines[0] == "cpu" and [l.split(":")[0] for l in lines[1:]] == [
        f"# {n}" for n in fixture_tables.RUNS]


# --- utilities -------------------------------------------------------------

def test_time_fn_on_cpu():
    from modelcompression_tpu_torch.utils.timing import time_fn
    calls = []
    sec = time_fn(lambda: calls.append(1), iters=4, windows=3, warmup=2,
                  device="cpu")
    assert len(calls) == 2 + 4 * 3 and 0.0 <= sec < 0.1
    x = torch.ones(256, 256)
    assert time_fn(lambda: x @ x, iters=2, windows=2, device="cpu") > 0
    with pytest.raises(ValueError):
        time_fn(lambda: None, iters=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            time_fn(lambda: None)


def test_perf_ledger_stamps_and_reads(tmp_path, monkeypatch):
    from modelcompression_tpu_torch.utils import perf_ledger
    path = str(tmp_path / "sub" / "ledger.jsonl")
    monkeypatch.setattr(perf_ledger, "device_tag",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    e1 = perf_ledger.append({"mode": "quick", "img_per_sec": 1.0}, path=path)
    perf_ledger.append({"mode": "full", "note": "n"}, path=path)
    assert len(e1["ts"]) == 20 and e1["ts"].endswith("Z")
    assert e1["commit"] == "unknown"  # tmp_path is not a git repository
    assert e1["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    with open(path, "a") as f:
        f.write("{truncated-by-a-crash\n")
    perf_ledger.append({"a": 2}, path=path)
    got = perf_ledger.read(path)
    assert [g.get("mode", g.get("a")) for g in got] == ["quick", "full", 2]
    for ln in open(path).read().strip().split("\n")[:2]:
        json.loads(ln)
    assert perf_ledger.read(str(tmp_path / "missing.jsonl")) == []


def test_perf_ledger_never_writes_the_root_ledger(tmp_path):
    from modelcompression_tpu_torch.utils import perf_ledger
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root_ledger = os.path.join(root, "PERF_LEDGER.jsonl")
    assert os.path.realpath(perf_ledger.DEFAULT_PATH) != \
        os.path.realpath(root_ledger)
    assert perf_ledger.DEFAULT_PATH.endswith(
        os.path.join("chiprun_out", "perf_ledger.jsonl"))
    before = os.path.getmtime(root_ledger) \
        if os.path.exists(root_ledger) else None
    for path in (root_ledger, os.path.join(root, "tests", "..",
                                           "PERF_LEDGER.jsonl")):
        with pytest.raises(ValueError, match="record of accepted"):
            perf_ledger.append({"a": 1}, path=path)
    link = tmp_path / "link.jsonl"
    link.symlink_to(root_ledger)
    with pytest.raises(ValueError):
        perf_ledger.append({"a": 1}, path=str(link))
    after = os.path.getmtime(root_ledger) \
        if os.path.exists(root_ledger) else None
    assert before == after


def test_perf_ledger_git_commit_real_repo(tmp_path):
    from modelcompression_tpu_torch.utils import perf_ledger
    repo = str(tmp_path / "r")
    os.makedirs(repo)
    env = {**os.environ, "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
           "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t"}

    def git(*a):
        subprocess.run(["git", *a], cwd=repo, check=True, env=env,
                       capture_output=True)

    git("init", "-q")
    with open(os.path.join(repo, "f.txt"), "w") as f:
        f.write("x\n")
    git("add", "f.txt")
    git("commit", "-qm", "init")
    sha = perf_ledger.git_commit(repo)
    assert sha != "unknown" and "+dirty" not in sha and len(sha) >= 7
    with open(os.path.join(repo, "f.txt"), "w") as f:
        f.write("y\n")
    assert perf_ledger.git_commit(repo) == sha + "+dirty"
    e = perf_ledger.append({"a": 1}, path=os.path.join(repo, "l.jsonl"))
    assert e["commit"] == sha + "+dirty"
    assert e["device"] == perf_ledger.device_tag()


@pytest.mark.parametrize("bad", [float("nan"), float("inf"),
                                 float("-inf")])
def test_nan_check_raises_on_non_finite(bad):
    from modelcompression_tpu_torch.utils.profiling import nan_check
    ok = {"conv0": {"w": torch.ones(2, 2), "n": torch.tensor([1, 2])},
          "x": [torch.zeros(3), (torch.ones(1, dtype=torch.bfloat16),)]}
    nan_check(ok, "ok")
    broken = {"conv0": {"w": torch.ones(2, 2)},
              "x": [torch.zeros(3), (torch.tensor([1.0, bad]),)]}
    with pytest.raises(FloatingPointError, match="non-finite values in p"):
        nan_check(broken, "p")
    with pytest.raises(FloatingPointError):
        nan_check(torch.tensor([bad], dtype=torch.bfloat16))
