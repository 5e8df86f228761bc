"""The port's tensor parallelism (``--tp``) on the CPU: one spawn of 4 gloo
ranks on a (data=2, model=2) mesh runs every step-level case, each rank
pickling what it saw; the tests compare the pickles.

* (a, b) The TP train step (BITMATCH) on a region net with a route and a
  reorg (YOLOv2's passthrough) and on a two-head yolo net (shortcut,
  upsample, route), against the JAX package's single-device step from
  the same numpy params, at the JAX package's own TP tolerance
  (tests/test_train_step.py: loss rtol 1e-5, params rtol 2e-4 atol
  1e-5). Each net has convs whose filter count 2 does not divide (the
  detection convs, and the region net's 5-filter passthrough conv with
  BN), which run replicated.
* The options of the fine-tune CLI under TP against the port's own
  single-device step at the same tolerance: subdivisions 2 with remat,
  the BN-gamma L1 penalty with a frozen first conv, EMA, QAT and
  distillation.
* (c) The TP step against the plain step in float64: gradients within
  1e-9 of each tensor's largest magnitude, params within 1e-12.
* (d) GMP: the masks recomputed on the gathered weights and kept per
  shard, gathered back, equal the single-device ``gmp_mask_update``'s
  exactly on the same weights (mirroring tests/test_parallel_compress.py's
  bit-equality test); a 3-step GMP run against the JAX package's, with
  that file's float-drift sliver allowance.
* (e) Replicated params equal on all four ranks, bit for bit; a data
  group's shards equal; ``gather_params`` of the placed state equal to
  the full params.
* (f) A checkpoint of the gathered state after one step, resumed under
  TP (reshard, bit-equal to the uninterrupted run after its next step)
  and without TP (the plain step, at the TP tolerance).

Spawned ranks import this module: JAX is imported inside the tests only.
Worker time: ~25 s (one spawn of 4 ranks, the JAX references)."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

SIZE, BATCH = 64, 4
DP, TP = 2, 2
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 2e-4, 1e-5  # tests/test_train_step.py
F64_GRAD, F64_PARAM = 1e-9, 1e-12

# a region net with YOLOv2's passthrough: route back to conv 4, a 5-filter
# conv (replicated under tp=2), reorg, route with the deep features
REGION_CFG = """[net]
batch=4
subdivisions=1
width=64
height=64
channels=3
learning_rate=0.001
momentum=0.9
decay=0.0005
max_batches=500
policy=constant

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[route]
layers=4

[convolutional]
batch_normalize=1
filters=5
size=1
stride=1
pad=1
activation=leaky

[reorg]
stride=2

[route]
layers=-1,-4

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=35
activation=linear

[region]
anchors = 1.08,1.19,  3.42,4.41,  6.63,11.38,  9.42,5.11,  16.62,10.52
bias_match=1
classes=2
coords=4
num=5
softmax=1
jitter=.2
rescore=1
object_scale=5
noobject_scale=1
class_scale=1
coord_scale=1
absolute=1
thresh=.6
random=0
"""

GMP_KW = dict(final_sparsity=0.75, initial_sparsity=0.0, begin=0, end=2,
              frequency=1)
# name: (net, TrainConfig overrides, extras, steps); "ref" is the JAX
# single-device step for the first two and GMP, the port's otherwise
CASES = {
    "region": ("region", {}, {}, 2),
    "yolo": ("yolo", {}, {}, 2),
    "region_s2_remat": ("region", {"subdivisions": 2, "remat": True}, {},
                        2),
    "region_bn_l1_freeze": ("region", {"bn_l1": 1e-2, "freeze_prefix": 1},
                            {}, 2),
    "yolo_ema": ("yolo", {"ema_decay": 0.9}, {"ema": True}, 2),
    "region_qat": ("region", {}, {"qat": True}, 2),
    "yolo_distill": ("yolo", {}, {"distill": True}, 2),
    "region_gmp": ("region", {}, {"gmp": GMP_KW}, 3),
    "region_f64": ("region", {}, {"f64": True}, 2),
}
JAX_CASES = ("region", "yolo", "region_gmp")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _texts():
    from modelcompression_tpu_torch.data.fixtures import tiny_yolo3_cfg
    return {"region": REGION_CFG,
            "yolo": tiny_yolo3_cfg(num_classes=2, width=SIZE, height=SIZE)}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    targets = np.zeros((BATCH, 8, 5), np.float32)
    for i in range(BATCH):
        targets[i, 0] = [rng.integers(0, 2), 0.5, 0.5, 0.4, 0.4]
        targets[i, 1] = [rng.integers(0, 2), 0.2, 0.25, 0.2, 0.3]
    return images, targets


def _f64():
    from modelcompression_tpu_torch.core.precision import Precision
    return Precision(name="float64", compute_dtype=torch.float64,
                     param_dtype=torch.float64)


def _setup_case(d, name):
    """(spec, TrainConfig, full params, masks, distill plan, ema) of a
    case, built alike in the ranks and in the test process."""
    from modelcompression_tpu_torch.compress import gmp as tg
    from modelcompression_tpu_torch.compress import qat as tq
    from modelcompression_tpu_torch.core.precision import BITMATCH
    from modelcompression_tpu_torch.models import params_from_jax, parse_cfg
    from modelcompression_tpu_torch.train import distill as td
    from modelcompression_tpu_torch.train import train_step as tts
    net, kw, extra, _ = CASES[name]
    spec = parse_cfg(d["texts"][net])
    params = params_from_jax(d["params"][net], spec)
    precision = BITMATCH
    if extra.get("f64"):
        precision = _f64()
        params = {k: {n: v.double() for n, v in p.items()}
                  for k, p in params.items()}
    cfg = tts.TrainConfig.from_spec(spec, precision=precision,
                                    augment_flip=False, augment_jitter=0.0,
                                    **kw)
    masks, plan = None, None
    if "gmp" in extra:
        cfg = dataclasses.replace(cfg, gmp=tg.GMPSpec(**extra["gmp"]))
        masks = tg.gmp_init_masks(params, spec, cfg.gmp)
    if extra.get("qat"):
        cfg = dataclasses.replace(cfg, qat=tq.qat_spec_from_batches(
            params, spec, [d["calib"]]))
    if extra.get("distill"):
        plan = td.make_distill_plan(
            params_from_jax(d["teacher"][net], spec), spec, spec,
            weight=0.5, temp=2.0)
    return spec, cfg, params, masks, plan, bool(extra.get("ema"))


def _state(cfg, params, masks, ema):
    from modelcompression_tpu_torch.train import train_step as tts
    return tts.TrainState.create(params, tts.make_optimizer(cfg),
                                 torch.Generator().manual_seed(1),
                                 weight_masks=masks, ema=ema)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _record(state, m, full, grads):
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": {k: {n: _np(v) for n, v in p.items()}
                       for k, p in full.items()},
            "grads": grads,
            "masks": {k: _np(v) for k, v in state["weight_masks"].items()},
            "ema": ({k: {n: _np(v) for n, v in p.items()}
                     for k, p in state["ema_params"].items()}
                    if "ema_params" in state else None),
            "seen": state["seen"]}


def _tp_rank(argv):
    """One rank: every case of CASES on the same batch, then the GMP
    recompute on fixed weights and the checkpoint resume, its results
    pickled per rank."""
    import torch.distributed as dist

    from modelcompression_tpu_torch.compress import gmp as tg
    from modelcompression_tpu_torch.core.mesh import MeshConfig, make_mesh
    from modelcompression_tpu_torch.parallel import place_train_state, ranks
    from modelcompression_tpu_torch.parallel.sharding import (
        TensorParallel, gather_params, gather_train_state, shard_params,
        sharded_keys,
    )
    from modelcompression_tpu_torch.train import train_step as tts
    from modelcompression_tpu_torch.utils.checkpoint import (
        latest_checkpoint, load_checkpoint, save_checkpoint,
    )
    inp, out, ck = argv
    with open(inp, "rb") as f:
        d = pickle.load(f)
    grid = ranks.grid()
    mesh = make_mesh(MeshConfig(data=DP, model=TP), device="cpu")
    res = {"rank": grid.rank, "d": grid.d, "m": grid.m}

    def gathered_grads(state, spec):
        keys = sharded_keys(spec, TP)
        return {k: {n: _np(ranks.all_gather_rows(v.grad, grid.model_group)
                           if k in keys else v.grad)
                    for n, v in p.items() if v.grad is not None}
                for k, p in state["params"].items()}

    for name, (_, _, _, n_steps) in CASES.items():
        spec, cfg, params, masks, plan, ema = _setup_case(d, name)
        state = place_train_state(_state(cfg, params, masks, ema), mesh,
                                  spec, tp=True, rank=grid.rank)
        if name == "region":  # (e) the placed shards gather back whole
            back = gather_params(state["params"], mesh, spec)
            res["gather_back_equal"] = all(
                torch.equal(back[k][n], v) for k, p in params.items()
                for n, v in p.items())
            res["local"] = {k: {n: _np(v) for n, v in p.items()}
                            for k, p in state["params"].items()}
        step = tts.make_train_step(spec, cfg, distill=plan, mesh=mesh)
        steps = []
        for i in range(n_steps):
            state, m = step(state, d["images"], d["targets"])
            full = gather_train_state(state, mesh, spec)
            rec = _record(full, m, full["params"],
                          gathered_grads(state, spec))
            steps.append(rec)
            if name == "region" and i == 0:  # (f) a checkpoint
                if grid.rank == 0:
                    save_checkpoint(ck, full["step"], spec, full)
                dist.barrier()
        res[name] = steps
        if name == "region":
            res["local_after"] = {k: {n: _np(v) for n, v in p.items()}
                                  for k, p in state["params"].items()}

    # (f) resume under TP from the checkpoint: reshard, one more step
    spec, cfg, params, masks, plan, ema = _setup_case(d, "region")
    fresh = _state(cfg, params, masks, ema)
    _, fresh, _ = load_checkpoint(latest_checkpoint(ck), target=fresh)
    fresh = place_train_state(fresh, mesh, spec, tp=True, rank=grid.rank)
    step = tts.make_train_step(spec, cfg, mesh=mesh)
    fresh, _ = step(fresh, d["images"], d["targets"])
    res["resumed"] = {k: {n: _np(v) for n, v in p.items()} for k, p in
                      gather_params(fresh["params"], mesh, spec).items()}

    # (d) the GMP recompute on fixed weights: this rank's slices of the
    # masks from the gathered weights, gathered back
    spec, cfg, params, masks, _, _ = _setup_case(d, "region_gmp")
    local = shard_params(params, mesh, spec, tp=True, rank=grid.rank)
    keys = sharded_keys(spec, TP)
    tp = TensorParallel(grid.m, TP, keys, grid.model_group, None)
    local_masks = {k: (tp.local(v) if k in keys else v)
                   for k, v in masks.items()}
    got = tg.gmp_mask_update(cfg.gmp, spec, local, local_masks, 1,
                             shards=lambda: tts._gmp_shards(local, tp))
    res["gmp_masks"] = {k: _np(ranks.all_gather_rows(v, grid.model_group)
                               if k in keys else v)
                        for k, v in got.items()}
    with open(f"{out}.{grid.rank}", "wb") as f:
        pickle.dump(res, f)
    return 0


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every rank's results (one spawn of 4 gloo ranks), the inputs and
    the checkpoint directory."""
    import jax

    from modelcompression_tpu.models import init_params as j_init
    from modelcompression_tpu.models import parse_cfg as j_parse
    from modelcompression_tpu_torch.core.mesh import MeshConfig, make_mesh
    from modelcompression_tpu_torch.parallel import ranks
    tmp = tmp_path_factory.mktemp("tp")
    texts = _texts()
    params, teacher = {}, {}
    for i, (net, text) in enumerate(texts.items()):
        js = j_parse(text)
        params[net] = jax.tree.map(np.array, j_init(js, jax.random.key(5 + i)))
        teacher[net] = jax.tree.map(np.array,
                                    j_init(js, jax.random.key(9 + i)))
    images, targets = _batch()
    calib = np.random.default_rng(3).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    d = {"texts": texts, "params": params, "teacher": teacher,
         "images": images, "targets": targets, "calib": calib}
    inp, out, ck = str(tmp / "in.pkl"), str(tmp / "out"), str(tmp / "ck")
    with open(inp, "wb") as f:
        pickle.dump(d, f)
    mesh = make_mesh(MeshConfig(data=DP, model=TP), device="cpu")
    assert ranks.spawn("tests.test_torch_tp:_tp_rank", [inp, out, ck], mesh,
                       threads=1) == 0
    runs = []
    for r in range(DP * TP):
        with open(f"{out}.{r}", "rb") as f:
            runs.append(pickle.load(f))
    return d, runs, ck


def _hwio(a):
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def _jax_steps(d, name):
    """The JAX package's single-device step on the case's inputs:
    per step the loss, the params (HWIO) and the masks."""
    import jax
    import jax.numpy as jnp

    from modelcompression_tpu.compress import gmp as jg
    from modelcompression_tpu.core.precision import BITMATCH as J_BM
    from modelcompression_tpu.models import parse_cfg as j_parse
    from modelcompression_tpu.train import train_step as jts
    net, kw, extra, n_steps = CASES[name]
    jspec = j_parse(d["texts"][net])
    cfg = jts.TrainConfig.from_spec(jspec, precision=J_BM,
                                    augment_flip=False, augment_jitter=0.0,
                                    **kw)
    params = jax.tree.map(jnp.asarray, d["params"][net])
    masks = None
    if "gmp" in extra:
        cfg = dataclasses.replace(cfg, gmp=jg.GMPSpec(**extra["gmp"]))
        masks = jg.gmp_init_masks(params, jspec, cfg.gmp)
    tx = jts.make_optimizer(cfg)
    state = jts.TrainState.create(params, tx, jax.random.key(1),
                                  weight_masks=masks)
    step = jts.make_train_step(jspec, cfg, tx)
    out = []
    for _ in range(n_steps):
        state, m = step(state, jnp.asarray(d["images"]),
                        jnp.asarray(d["targets"]))
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "params": jax.tree.map(np.array, state["params"]),
                    "masks": {k: np.asarray(v) for k, v in
                              state["weight_masks"].items()}})
    return out


def _port_steps(d, name):
    """The port's single-device step on the case's inputs."""
    from modelcompression_tpu_torch.train import train_step as tts
    spec, cfg, params, masks, plan, ema = _setup_case(d, name)
    state = _state(cfg, params, masks, ema)
    step = tts.make_train_step(spec, cfg, distill=plan)
    out = []
    for _ in range(CASES[name][3]):
        state, m = step(state, d["images"], d["targets"])
        grads = {k: {n: _np(v.grad) for n, v in p.items()
                     if v.grad is not None}
                 for k, p in state["params"].items()}
        out.append(_record(state, m, state["params"], grads))
    return out


def _assert_params(got, want, what, hwio=False):
    for k, p in want.items():
        for n, a in p.items():
            g = _hwio(got[k][n]) if hwio else got[k][n]
            np.testing.assert_allclose(g, a, rtol=P_RTOL, atol=P_ATOL,
                                       err_msg=f"{what} {k}/{n}")


@pytest.mark.parametrize("case", JAX_CASES)
def test_tp_step_matches_jax_single_device(tp_runs, case):
    """(a, b, d) Rank 0's gathered TP steps against the JAX step: loss
    and params at the JAX TP tolerance; with GMP the sparsity within
    1e-4 and the masks within tests/test_parallel_compress.py's sliver
    (every pruned weight exactly 0)."""
    d, runs, _ = tp_runs
    want = _jax_steps(d, case)
    got = runs[0][case]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["metrics"]["loss"] == pytest.approx(
            w["metrics"]["loss"], rel=LOSS_RTOL), i
        _assert_params(g["params"], w["params"], f"step {i}", hwio=True)
        assert g["seen"] == (i + 1) * BATCH
        for k, m in w["masks"].items():
            mine = _hwio(g["masks"][k])
            assert (mine != m).sum() <= max(4, int(2e-3 * m.size)), (i, k)
            assert (_hwio(g["params"][k]["w"])[~mine] == 0).all(), (i, k)
    if case == "region_gmp":
        assert got[-1]["metrics"]["sparsity"] == pytest.approx(
            want[-1]["metrics"]["sparsity"], abs=1e-4)
        assert got[-1]["metrics"]["sparsity"] > 0.7


@pytest.mark.parametrize("case", sorted(set(CASES) - set(JAX_CASES)
                                        - {"region_f64"}))
def test_tp_step_options_match_plain_step(tp_runs, case):
    """Remat with subdivisions, bn_l1 with freeze, EMA, QAT and
    distillation under TP against the port's single-device step: every
    metric at the loss tolerance, params (and the EMA) at the params
    tolerance; a frozen conv's params bit-equal to the start."""
    d, runs, _ = tp_runs
    want = _port_steps(d, case)
    got = runs[0][case]
    for i, (g, w) in enumerate(zip(got, want)):
        for k, v in w["metrics"].items():
            assert g["metrics"][k] == pytest.approx(v, rel=LOSS_RTOL,
                                                    abs=1e-7), (i, k)
        _assert_params(g["params"], w["params"], f"step {i}")
        if w["ema"] is not None:
            _assert_params(g["ema"], w["ema"], f"ema step {i}")
    if case == "region_bn_l1_freeze":
        from modelcompression_tpu_torch.models import params_from_jax
        start = params_from_jax(d["params"]["region"])
        for n, v in start["conv0"].items():
            assert np.array_equal(got[-1]["params"]["conv0"][n], v.numpy())


def test_tp_step_float64_matches_plain_step(tp_runs):
    """(c) In float64 the TP step's gathered gradients are within 1e-9 of
    each tensor's largest magnitude of the plain step's, its params
    within 1e-12, at both steps."""
    d, runs, _ = tp_runs
    want = _port_steps(d, "region_f64")
    for g, w in zip(runs[0]["region_f64"], want):
        assert g["metrics"]["loss"] == pytest.approx(w["metrics"]["loss"],
                                                     rel=1e-12)
        for k, p in w["grads"].items():
            for n, a in p.items():
                err = np.abs(g["grads"][k][n] - a).max()
                assert err <= F64_GRAD * np.abs(a).max(), (k, n, err)
        for k, p in w["params"].items():
            for n, a in p.items():
                assert np.abs(g["params"][k][n] - a).max() <= F64_PARAM, \
                    (k, n)


def test_tp_gmp_masks_equal_single_device_exactly(tp_runs):
    """(d) On the same weights, the masks each rank keeps of the
    recompute on the gathered weights, gathered back, equal the
    single-device update's bit for bit, on every rank."""
    from modelcompression_tpu_torch.compress import gmp as tg
    d, runs, _ = tp_runs
    spec, cfg, params, masks, _, _ = _setup_case(d, "region_gmp")
    want = tg.gmp_mask_update(cfg.gmp, spec, params, masks, 1)
    for r in runs:
        for k, m in want.items():
            assert np.array_equal(r["gmp_masks"][k], m.numpy()), (r["rank"],
                                                                  k)
    assert sum(int((~m).sum()) for m in want.values()) > 0


def test_tp_replicated_params_equal_and_shards_gather_back(tp_runs):
    """(e) After two steps a replicated conv's params are bit-equal on
    all four ranks and a sharded conv's slices equal within each data
    group; every rank gathers the same full params; the placed shards
    gather back to the full params."""
    from modelcompression_tpu_torch.models import parse_cfg
    from modelcompression_tpu_torch.parallel.sharding import sharded_keys
    d, runs, _ = tp_runs
    keys = sharded_keys(parse_cfg(d["texts"]["region"]), TP)
    assert keys and "conv11" in keys and "conv12" not in keys
    assert "conv8" not in keys  # the 5-filter passthrough conv
    r0 = runs[0]
    for r in runs:
        assert r["gather_back_equal"]
        peer = next(q for q in runs
                    if q["m"] == r["m"] and q["rank"] != r["rank"])
        for k, p in r["local_after"].items():
            for n, v in p.items():
                if k in keys:
                    assert v.shape[0] * TP == r0["region"][-1][
                        "params"][k][n].shape[0]
                    assert np.array_equal(v, peer["local_after"][k][n])
                else:
                    assert np.array_equal(v, r0["local_after"][k][n]), (k, n)
        for k, p in r0["region"][-1]["params"].items():
            for n, v in p.items():
                assert np.array_equal(r["region"][-1]["params"][k][n], v)


def test_tp_checkpoint_resumes_with_and_without_tp(tp_runs):
    """(f) The checkpoint written after step 1 of the TP run: resumed
    under TP its next step is bit-equal to the uninterrupted run's step 2;
    resumed by the plain step, at the TP tolerance."""
    from modelcompression_tpu_torch.train import train_step as tts
    from modelcompression_tpu_torch.utils.checkpoint import (
        latest_checkpoint, load_checkpoint,
    )
    d, runs, ck = tp_runs
    uninterrupted = runs[0]["region"][1]["params"]
    for r in runs:
        for k, p in uninterrupted.items():
            for n, v in p.items():
                assert np.array_equal(r["resumed"][k][n], v), (k, n)
    spec, cfg, params, masks, _, ema = _setup_case(d, "region")
    state = _state(cfg, params, masks, ema)
    _, state, meta = load_checkpoint(latest_checkpoint(ck), target=state)
    assert meta["step"] == state["step"] == 1 and state["seen"] == BATCH
    state, _ = tts.make_train_step(spec, cfg)(state, d["images"],
                                              d["targets"])
    _assert_params({k: {n: _np(v) for n, v in p.items()}
                    for k, p in state["params"].items()}, uninterrupted,
                   "plain resume")
    assert os.path.isdir(ck)


def test_tp_iterate_repacks_to_widths_tp_does_not_divide(tmp_path, capsys):
    """finetune --tp 2 --iterate 0.3 --iterate-mode l1_filter (FAST, two
    gloo ranks): every rank takes the keep-sets of the full loaded
    weights, so the slimmed cfg equals the single-device run's; its
    widths 23 and 45, which 2 does not divide, fine-tune replicated
    beside the sharded ones, and the written weights hold to the
    single-device run's within tests/test_torch_parallel.py's FAST
    bound."""
    from modelcompression_tpu_torch.cli import finetune
    from modelcompression_tpu_torch.compress import (
        repack, uniform_filter_fraction_keep_sets,
    )
    from modelcompression_tpu_torch.data import fixtures as tfx
    from modelcompression_tpu_torch.models import (
        init_params, load_cfg, load_weights, parse_cfg, save_weights,
    )
    from tests.test_torch_parallel import _assert_update_close
    text = tfx.tiny_region_cfg(num_classes=3, width=SIZE, height=SIZE)
    cfg = str(tmp_path / "net.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    spec = parse_cfg(text)
    weights = str(tmp_path / "w.weights")
    save_weights(weights, spec, init_params(spec, seed=0), seen=100)
    data = tfx.make_fake_voc(str(tmp_path / "d"), n_images=8,
                             image_size=SIZE, seed=0)
    got = {}
    for tag, extra in (("plain", []), ("tp", ["--tp", "2"])):
        out = str(tmp_path / f"{tag}.weights")
        assert finetune.main(
            ["--cfg", cfg, "--weights", weights, "--data", data, "--steps",
             "2", "--batch", "4", "--device", "cpu", "--iterate", "0.3",
             "--iterate-mode", "l1_filter", "--out", out, *extra]) == 0
        with open(out[:-len(".weights")] + ".cfg") as f:
            got[tag] = (f.read(), out)
    capsys.readouterr()
    assert got["tp"][0] == got["plain"][0]
    slim = load_cfg(got["tp"][1][:-len(".weights")] + ".cfg")
    widths = [l.filters for l in slim.layers if hasattr(l, "filters")]
    assert widths == [12, 23, 45, 45, 90, 40]
    params, _ = load_weights(weights, spec)
    _, init = repack(spec, params, uniform_filter_fraction_keep_sets(
        spec, params, 0.3))
    (p_tp, seen_tp), (p_plain, seen_plain) = (
        load_weights(got[t][1], slim) for t in ("tp", "plain"))
    assert seen_tp == seen_plain == 100 + 2 * 4
    _assert_update_close(p_tp, p_plain, init)
