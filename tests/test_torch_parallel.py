"""The port's data parallelism (core/mesh.py, parallel/sharding.py,
parallel/ranks.py, evaluate(mesh=), the train step over a process group)
on the CPU against the JAX package's mesh and single-device runs.

* ``make_mesh`` shapes and the JAX error text; ``param_specs`` equal to
  JAX's (dp and tp) once HWIO dim 3 is read as OIHW dim 0.
* The serving step over a 2- and 4-shard CPU mesh (``data_parallel``)
  and ``evaluate(mesh=)`` against the single-device step at the JAX
  package's test_parallel_eval.py tolerances (valid equal, scores rtol
  1e-6 atol 1e-7, boxes rtol 1e-6 atol 1e-4), and the JAX package's own
  mesh run at tests/test_torch_pipeline.py's (scores 1e-5, boxes 1e-3
  source pixels).
* A 2-rank gloo train step (BITMATCH) at subdivisions 1 and 2, with and
  without GMP, and with remat, against the JAX package's single-device
  step at tests/test_torch_train_step.py's tolerances; the params and
  the masks equal on both ranks, bit for bit.
* ``finetune --dp`` and ``train --dp 2`` through the CLIs. They train
  FAST (bf16 convs; neither package's CLI has a precision flag). One
  gloo rank writes what the single-device CLI writes, bit for bit. With
  two, the BN statistics summed over the ranks round their bf16 casts
  differently from one device's, and those flips move the update: the
  written params are held to the single-device CLI's within 0.3 of each
  tensor's largest update (measured ≤ 0.13; an update from one rank's
  half of the batch alone would be off by about its own size). The
  BITMATCH equality is the train step's, above. ``finetune --dp 1 --tp
  2`` (two ranks splitting the filters) is held to the same bound.

Spawned ranks import this module: JAX is imported inside the tests only.
Worker time: ~55 s (one spawn of the train-step ranks, five CLI spawns)."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from modelcompression_tpu_torch.core.mesh import MeshConfig, make_mesh
from modelcompression_tpu_torch.parallel import (
    data_parallel, param_specs, replicate, shard_batch,
)

SIZE, BATCH = 64, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- mesh and specs -------------------------------------------------------

def test_make_mesh_shapes_and_errors(monkeypatch):
    from modelcompression_tpu.core.mesh import MeshConfig as JConfig
    from modelcompression_tpu.core.mesh import make_mesh as j_make
    from tests.conftest import cpu_devices
    mesh = make_mesh(MeshConfig(data=4, model=2), device="cpu")
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.data_devices == (torch.device("cpu"),) * 4
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError) as want:
        j_make(JConfig(data=16), devices=cpu_devices())
    with pytest.raises(ValueError) as got:
        make_mesh(MeshConfig(data=16), devices=["cpu"] * 8)
    assert str(got.value) == str(want.value)
    assert "needs 16 devices, have 8" in str(got.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(MeshConfig(data=1))


@pytest.mark.parametrize("tp, tp_size", [(False, 1), (True, 2), (True, 4)])
def test_param_specs_equal_jax(tp, tp_size):
    from jax.sharding import PartitionSpec as JP

    from modelcompression_tpu.models import parse_cfg as j_parse
    from modelcompression_tpu.parallel import param_specs as j_specs
    from modelcompression_tpu_torch.models import cfg_path, load_cfg
    for name in ("yolov2-voc.cfg", "yolov4-tiny-voc.cfg"):
        spec = load_cfg(cfg_path(name))
        with open(cfg_path(name)) as f:
            jspec = j_parse(f.read())
        names = {}
        for i in spec.conv_indices():
            l = spec.layers[i]
            names[f"conv{i}"] = dict.fromkeys(
                ("w", "gamma", "beta", "mean", "var") if l.batch_normalize
                else ("w", "bias"))
        got = param_specs(spec, names, tp=tp, tp_size=tp_size)
        want = j_specs(jspec, names, tp=tp, tp_size=tp_size)
        assert got.keys() == want.keys()
        n_sharded = 0
        for k, p in want.items():
            for n, s in p.items():
                if n == "w" and len(s):  # HWIO dim 3 is OIHW dim 0
                    s = JP(*(tuple(s)[d] for d in (3, 2, 0, 1)))
                assert tuple(got[k][n]) == tuple(s), (name, k, n)
                n_sharded += len(s) > 0
        assert (n_sharded > 0) == tp


def test_shard_batch_and_replicate():
    mesh = make_mesh(MeshConfig(data=2), device="cpu")
    x = torch.arange(12).reshape(4, 3)
    a, b = shard_batch((x, np.arange(4)), mesh)
    assert torch.equal(a[0], x[:2]) and torch.equal(b[0], x[2:])
    assert b[1].tolist() == [2, 3]
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(torch.zeros(3), mesh)
    p = {"conv0": {"w": torch.ones(2)}}
    r = replicate(p, mesh)
    assert len(r) == 2 and r[0]["conv0"]["w"] is p["conv0"]["w"]


# ---- data-parallel inference ---------------------------------------------

def _eval_setup(kind):
    """(JAX spec, port spec, numpy HWIO folded params) of the JAX
    package's test_parallel_eval.py fixtures: the tiny region net, and the
    split-balanced 50%-pruned, repacked YOLOv4-tiny."""
    import jax

    from modelcompression_tpu.compress import (
        repack, uniform_filter_fraction_keep_sets,
    )
    from modelcompression_tpu.data.fixtures import (
        tiny_region_cfg, tiny_yolo4_cfg,
    )
    from modelcompression_tpu.models import dump_cfg as j_dump
    from modelcompression_tpu.models import init_params, parse_cfg
    from modelcompression_tpu.models.darknet import fold_batchnorm
    from modelcompression_tpu_torch.models import parse_cfg as t_parse
    if kind == "region":
        spec = parse_cfg(tiny_region_cfg(num_classes=3, width=64, height=64))
        params = init_params(spec, jax.random.key(0))
    else:
        spec = parse_cfg(tiny_yolo4_cfg(num_classes=3, width=64, height=64))
        params = init_params(spec, jax.random.key(7))
        keep = uniform_filter_fraction_keep_sets(spec, params, 0.5)
        spec, params = repack(spec, params, keep)
    folded = jax.tree.map(np.asarray, fold_batchnorm(params, spec))
    return spec, t_parse(j_dump(spec)), folded


def _eval_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (8, 64, 64, 3), np.uint8),
            np.full((8,), 96.0, np.float32), np.full((8,), 80.0, np.float32))


def _assert_dp_equal(got, want, box_atol):
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=box_atol)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["region", "v4_balanced_pruned"])
def test_dp_eval_step_matches_single_device_and_jax_mesh(kind, n):
    """The step over an n-shard CPU mesh equals the single-device step
    (JAX's DP tolerances) and the JAX step over an n-device mesh (the
    port-vs-JAX step tolerances)."""
    import jax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    from modelcompression_tpu.core.precision import BITMATCH as J_BM
    from modelcompression_tpu.evaluation import EvalConfig as JConfig
    from modelcompression_tpu.evaluation import make_eval_step as j_step
    from modelcompression_tpu_torch.core.precision import BITMATCH
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, make_eval_step,
    )
    from modelcompression_tpu_torch.models import params_from_jax
    from tests.conftest import cpu_devices
    jspec, tspec, folded = _eval_setup(kind)
    images, ws, hs = _eval_inputs(0 if kind == "region" else 8)
    kw = dict(batch_size=8, conf_thresh=1e-4, max_detections=8)
    step = make_eval_step(tspec, EvalConfig(precision=BITMATCH,
                                            device="cpu", **kw))
    params = params_from_jax(folded)
    single = [t.numpy() for t in step(params, images, ws, hs)]
    mesh = make_mesh(MeshConfig(data=n), device="cpu")
    dp = data_parallel(step, mesh)
    got = [t.numpy() for t in dp(replicate(params, mesh), images, ws, hs)]
    _assert_dp_equal(got, single, 1e-4)
    assert got[2].sum() > 0

    jmesh = Mesh(np.array(cpu_devices()[:n]), ("data",))
    rows = NamedSharding(jmesh, JP("data"))
    want = j_step(jspec, JConfig(precision=J_BM, **kw))(
        jax.device_put(folded, NamedSharding(jmesh, JP())),
        jax.device_put(images, NamedSharding(jmesh, JP("data", None, None,
                                                       None))),
        jax.device_put(ws, rows), jax.device_put(hs, rows))
    want = [np.asarray(a) for a in want]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=0)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [2, 4])
def test_evaluate_mesh_equals_single_device(tmp_path, n):
    """evaluate(mesh=) over n CPU shards, 12 images at batch 4 (a padded
    last batch): the same detections, overflow counters and mAP as one
    device; a batch the mesh does not divide raises the JAX text."""
    from modelcompression_tpu_torch.core.precision import BITMATCH
    from modelcompression_tpu_torch.data import fixtures as tfx
    from modelcompression_tpu_torch.data import voc as tvoc
    from modelcompression_tpu_torch.evaluation import EvalConfig, evaluate
    from modelcompression_tpu_torch.models import init_params, parse_cfg
    data = tfx.make_fake_voc(str(tmp_path), n_images=10, image_size=64,
                             seed=2)
    samples = tvoc.load_list_dataset(tvoc.read_data_cfg(data)["valid"])
    spec = parse_cfg(tfx.tiny_region_cfg(num_classes=3, width=64,
                                         height=64))
    params = init_params(spec, seed=3)
    names = tvoc.read_names(tvoc.read_data_cfg(data)["names"])
    cfg = EvalConfig(batch_size=4, conf_thresh=1e-3, max_detections=8,
                     precision=BITMATCH, fold_bn=False, map_iou=0.1,
                     device="cpu")
    want = evaluate(params, spec, samples, names, cfg)
    got = evaluate(params, spec, samples, names, cfg,
                   mesh=make_mesh(MeshConfig(data=n), device="cpu"))
    n_dets = 0
    for c, w in want.detections.items():
        g = got.detections[c]
        assert [d.image_id for d in g] == [d.image_id for d in w]
        if w:
            np.testing.assert_allclose([d.score for d in g],
                                       [d.score for d in w], rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose([d.box for d in g],
                                       [d.box for d in w], rtol=1e-6,
                                       atol=1e-4)
        n_dets += len(w)
    assert n_dets > 0 and got.n_images == want.n_images == 10
    assert got.map50 == want.map50
    assert got.nms_overflow_frac == want.nms_overflow_frac
    with pytest.raises(ValueError, match="eval batch 4 not divisible by "
                                         "data-parallel size 3"):
        evaluate(params, spec, samples, names, cfg,
                 mesh=make_mesh(MeshConfig(data=3), device="cpu"))


# ---- data-parallel training: 2 gloo ranks --------------------------------

GMP_KW = dict(final_sparsity=0.75, initial_sparsity=0.0, begin=0, end=2,
              frequency=1)
CASES = {  # name: (TrainConfig overrides, GMP spec overrides, steps)
    "s1": ({}, None, 2),
    "s2": ({"subdivisions": 2}, None, 2),
    "s2_remat": ({"subdivisions": 2, "remat": True}, None, 2),
    "s1_gmp": ({}, dict(GMP_KW, per_layer=True), 3),
    "s2_gmp_global": ({"subdivisions": 2}, dict(GMP_KW, per_layer=False),
                      3),
}


def _oihw_to_hwio(t):
    a = t.detach().numpy().copy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def _dp_rank(argv):
    """One rank of the train-step runs: every case of CASES on the same
    batch, its results pickled per rank (the format of
    tests/test_torch_gmp.py's ``_run_gmp``)."""
    import dataclasses

    from modelcompression_tpu_torch.compress import gmp as tg
    from modelcompression_tpu_torch.core.precision import BITMATCH
    from modelcompression_tpu_torch.models import (
        params_from_jax, params_to_jax, parse_cfg,
    )
    from modelcompression_tpu_torch.parallel import ranks
    from modelcompression_tpu_torch.train import train_step as tts
    inp, out = argv
    with open(inp, "rb") as f:
        d = pickle.load(f)
    spec = parse_cfg(d["text"])
    mesh = make_mesh(MeshConfig(data=ranks.world_size()), device="cpu")
    results = {}
    for name, (kw, gmp_kw, n_steps) in CASES.items():
        cfg = tts.TrainConfig.from_spec(spec, precision=BITMATCH,
                                        augment_flip=False,
                                        augment_jitter=0.0, **kw)
        params = params_from_jax(d["params"], spec)
        masks = None
        if gmp_kw is not None:
            cfg = dataclasses.replace(cfg, gmp=tg.GMPSpec(**gmp_kw))
            masks = tg.gmp_init_masks(params, spec, cfg.gmp)
        state = tts.TrainState.create(params, tts.make_optimizer(cfg),
                                      torch.Generator().manual_seed(1),
                                      weight_masks=masks)
        step = tts.make_train_step(spec, cfg, mesh=mesh)
        res = []
        for _ in range(n_steps):
            state, m = step(state, d["images"], d["targets"])
            p, opt = state["params"], state["optimizer"]
            res.append({
                "metrics": {k: float(v) for k, v in m.items()},
                "params": {k: {n: a.copy() for n, a in q.items()}
                           for k, q in params_to_jax(p).items()},
                "grads": {k: {n: _oihw_to_hwio(v.grad)
                              for n, v in q.items() if v.grad is not None}
                          for k, q in p.items()},
                "bufs": {k: {n: _oihw_to_hwio(
                    opt.state[v]["momentum_buffer"])
                    for n, v in q.items() if v in opt.state}
                    for k, q in p.items()},
                "masks": {k: m.permute(2, 3, 1, 0).numpy().copy()
                          for k, m in state["weight_masks"].items()},
                "seen": state["seen"]})
        results[name] = res
    with open(f"{out}.{ranks.rank()}", "wb") as f:
        pickle.dump(results, f)
    return 0


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Both ranks' results of every case (one spawn of 2 gloo ranks)."""
    import jax

    from modelcompression_tpu.data.fixtures import tiny_region_cfg
    from modelcompression_tpu.models import init_params as j_init
    from modelcompression_tpu.models import parse_cfg as j_parse
    from modelcompression_tpu_torch.parallel import ranks
    from tests.test_torch_train_step import _batch
    tmp = tmp_path_factory.mktemp("dp")
    text = tiny_region_cfg(num_classes=3, width=SIZE, height=SIZE)
    np_params = jax.tree.map(np.array,
                             j_init(j_parse(text), jax.random.key(5)))
    images, targets = _batch()
    inp = str(tmp / "in.pkl")
    with open(inp, "wb") as f:
        pickle.dump({"text": text, "params": np_params, "images": images,
                     "targets": targets}, f)
    out = str(tmp / "out")
    assert ranks.spawn("tests.test_torch_parallel:_dp_rank", [inp, out],
                       make_mesh(MeshConfig(data=2), device="cpu"),
                       threads=1) == 0
    runs = []
    for r in (0, 1):
        with open(f"{out}.{r}", "rb") as f:
            runs.append(pickle.load(f))
    return text, np_params, runs


def _jax_steps(text, np_params, kw, gmp_kw, n_steps):
    """The JAX package's single-device step, n steps on the same batch:
    metrics, params, momentum (and masks)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from modelcompression_tpu.compress import gmp as jg
    from modelcompression_tpu.core.precision import BITMATCH as J_BM
    from modelcompression_tpu.models import parse_cfg as j_parse
    from modelcompression_tpu.train import train_step as jts
    from tests.test_torch_train_step import _batch, _trace
    jspec = j_parse(text)
    cfg = jts.TrainConfig.from_spec(jspec, precision=J_BM,
                                    augment_flip=False, augment_jitter=0.0,
                                    **kw)
    params = jax.tree.map(jnp.asarray, np_params)
    masks = None
    if gmp_kw is not None:
        cfg = dataclasses.replace(cfg, gmp=jg.GMPSpec(**gmp_kw))
        masks = jg.gmp_init_masks(params, jspec, cfg.gmp)
    tx = jts.make_optimizer(cfg)
    state = jts.TrainState.create(params, tx, jax.random.key(1),
                                  weight_masks=masks)
    step = jts.make_train_step(jspec, cfg, tx)
    images, targets = _batch()
    out = []
    for _ in range(n_steps):
        state, m = step(state, jnp.asarray(images), jnp.asarray(targets))
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "params": jax.tree.map(np.array, state["params"]),
                    "trace": jax.tree.map(np.array,
                                          _trace(state["opt_state"])),
                    "masks": {k: np.asarray(v) for k, v in
                              state["weight_masks"].items()}})
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_rank_train_step_matches_jax_single_device(dp_runs, case):
    """Rank 0's steps against the JAX step on the whole batch: the first
    two steps at tests/test_torch_train_step.py's tolerances (metrics 1e-4
    relative, gradients and momentum 1e-4 of their largest, params 1e-4 of
    the update), the masks equal at every step (GMP), pruned weights
    exactly 0, and seen counting the global batch."""
    from tests.test_torch_train_step import _compare
    text, np_params, runs = dp_runs
    kw, gmp_kw, n_steps = CASES[case]
    want = _jax_steps(text, np_params, kw, gmp_kw, n_steps)
    got = runs[0][case]
    decay = 5e-4
    prev = np_params
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 2:
            _compare(g, w, decay, prev, check_grads=i == 0)
        for k, v in w["metrics"].items():
            assert g["metrics"][k] == pytest.approx(v, rel=1e-4,
                                                    abs=1e-6), (i, k)
        for k, m in w["masks"].items():
            assert np.array_equal(g["masks"][k], m), (i, k)
            assert (g["params"][k]["w"][~m] == 0).all(), (i, k)
        assert g["seen"] == (i + 1) * BATCH
        prev = w["params"]
    if gmp_kw is not None:
        assert got[-1]["metrics"]["sparsity"] > 0.7


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_hold_equal_params_and_masks(dp_runs, case):
    _, _, (r0, r1) = dp_runs
    for a, b in zip(r0[case], r1[case]):
        assert a["metrics"] == b["metrics"]
        for k, p in a["params"].items():
            for n, v in p.items():
                assert np.array_equal(v, b["params"][k][n]), (k, n)
        assert a["masks"].keys() == b["masks"].keys()
        for k, m in a["masks"].items():
            assert np.array_equal(m, b["masks"][k]), k


def test_train_step_mesh_needs_its_process_group():
    from modelcompression_tpu_torch.models import parse_cfg
    from modelcompression_tpu_torch.data.fixtures import tiny_region_cfg
    from modelcompression_tpu_torch.train import train_step as tts
    spec = parse_cfg(tiny_region_cfg(num_classes=3, width=SIZE, height=SIZE))
    cfg = tts.TrainConfig.from_spec(spec)
    with pytest.raises(ValueError, match="one process per device"):
        tts.make_train_step(spec, cfg, mesh=make_mesh(MeshConfig(data=2),
                                                      device="cpu"))
    # one device outside a process group: the plain step
    tts.make_train_step(spec, cfg, mesh=make_mesh(MeshConfig(data=1),
                                                  device="cpu"))


# ---- the training CLIs ----------------------------------------------------

@pytest.fixture(scope="module")
def cli_fixture(tmp_path_factory):
    from modelcompression_tpu_torch.data import fixtures as tfx
    from modelcompression_tpu_torch.models import (
        init_params, parse_cfg, save_weights,
    )
    tmp = tmp_path_factory.mktemp("dp_cli")
    text = tfx.tiny_region_cfg(num_classes=3, width=SIZE, height=SIZE)
    cfg = str(tmp / "net.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    spec = parse_cfg(text)
    weights = str(tmp / "w.weights")
    save_weights(weights, spec, init_params(spec, seed=0), seen=100)
    data = tfx.make_fake_voc(str(tmp / "d"), n_images=8, image_size=SIZE,
                             seed=0)
    return {"cfg": cfg, "weights": weights, "data": data, "spec": spec,
            "tmp": tmp}


def _assert_update_close(got, want, init, frac=0.3):
    """Every tensor of ``got`` within ``frac`` of ``want``'s largest
    update from ``init``."""
    for k, p in want.items():
        for n, v in p.items():
            update = float((v - init[k][n]).abs().max())
            err = float((got[k][n] - v).abs().max())
            assert err <= frac * update, (k, n, err, update)


def test_finetune_cli_dp_matches_single_device(cli_fixture, capsys,
                                               monkeypatch):
    """finetune --dp 1 and --dp 2 (gloo, rank 0 writes --out) against the
    single-device CLI, 2 steps at batch 4 / subdivisions 2: one rank bit
    for bit, two within the FAST bound of the module docstring; the
    header's seen counts the global batches. A micro-batch the ranks do
    not divide fails in the ranks (exit 2); --dp 1 --tp 2 writes what the
    single-device CLI writes within the FAST bound. Each rank writes its
    kernel launch counts (none on the CPU) and its collectives where
    LAUNCHES_DIR_ENV says."""
    from modelcompression_tpu_torch.cli import finetune
    from modelcompression_tpu_torch.models import load_weights
    from modelcompression_tpu_torch.ops import KERNELS
    from modelcompression_tpu_torch.parallel.ranks import LAUNCHES_DIR_ENV
    f = cli_fixture
    counts_dir = f["tmp"] / "launches"
    counts_dir.mkdir()
    monkeypatch.setenv(LAUNCHES_DIR_ENV, str(counts_dir))
    base = ["--cfg", f["cfg"], "--weights", f["weights"], "--data",
            f["data"], "--steps", "2", "--batch", "4", "--subdivisions",
            "2", "--device", "cpu"]
    got = {}
    for dp in ("0", "1", "2"):
        out = str(f["tmp"] / f"ft{dp}.weights")
        assert finetune.main(base + ["--dp", dp, "--out", out]) == 0
        got[dp] = load_weights(out, f["spec"])
    capsys.readouterr()
    assert got["0"][1] == got["1"][1] == got["2"][1] == 100 + 2 * 4
    (p0, _), (p1, _), (p2, _) = got["0"], got["1"], got["2"]
    for k, p in p0.items():
        for n, v in p.items():
            assert torch.equal(p1[k][n], v), (k, n)
    init, _ = load_weights(f["weights"], f["spec"])
    _assert_update_close(p2, p0, init)
    assert sorted(os.listdir(counts_dir)) == ["rank0.json", "rank1.json"]
    with open(counts_dir / "rank1.json") as fh:
        counts = json.load(fh)
    # each kernel's counts, and the rank's collectives by kind
    assert sorted(counts) == sorted([k.source for k in KERNELS]
                                    + ["collectives"])
    assert all(counts[k.source] == {"launches": 0, "at": {}}
               for k in KERNELS)
    assert counts["collectives"]["all_reduce"]["calls"] > 0
    assert finetune.main(base + ["--dp", "2", "--subdivisions", "4",
                                 "--out", out]) == 2
    assert "exited with code 2" in capsys.readouterr().err
    # --tp (rejected naming item 11 until it was ported) trains on a (1, 2)
    # mesh: the filters split over two ranks, the same FAST bound
    out = str(f["tmp"] / "ft_tp2.weights")
    assert finetune.main(base + ["--dp", "1", "--tp", "2", "--out",
                                 out]) == 0
    p_tp, seen_tp = load_weights(out, f["spec"])
    assert seen_tp == 100 + 2 * 4
    _assert_update_close(p_tp, p0, init)


def test_train_cli_dp2_checkpoint_matches_single_device(cli_fixture):
    """train --dp 2 from random init (2 steps, checkpoint by rank 0)
    against the single-device run: step and seen equal, params within the
    FAST bound."""
    from modelcompression_tpu_torch.cli import train
    from modelcompression_tpu_torch.models import init_params
    from modelcompression_tpu_torch.utils.checkpoint import (
        latest_checkpoint, load_checkpoint,
    )
    f = cli_fixture
    states = {}
    for dp in ("0", "2"):
        ck = str(f["tmp"] / f"ck{dp}")
        assert train.main(["--cfg", f["cfg"], "--data", f["data"],
                           "--steps", "2", "--batch", "4", "--device",
                           "cpu", "--no-multi-scale", "--jitter", "0",
                           "--checkpoint-dir", ck, "--dp", dp]) == 0
        _, states[dp], _ = load_checkpoint(latest_checkpoint(ck))
    a, b = states["2"], states["0"]
    assert (a["step"], a["seen"]) == (b["step"], b["seen"]) == (2, 8)
    _assert_update_close(a["params"], b["params"],
                         init_params(f["spec"], seed=0))
    assert sorted(os.listdir(f["tmp"] / "ck2")) == \
        sorted(os.listdir(f["tmp"] / "ck0"))
