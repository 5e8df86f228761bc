"""The port's magnitude top-k/mask (modelcompression_tpu_torch/ops/
topk_mask.py, ops/cuda_topk.py, compress/criteria.py) against the JAX
package, on the CPU.

* The three plain kernel versions against the JAX launchers
  ``pallas_count_le``, ``pallas_tie_counts`` and ``pallas_apply_threshold``
  run in interpret mode (as tests/test_ops_topk.py runs them), at N = 2
  TPU chunks with three segments and bf16-valued weights (many ties).
* ``segmented_kth_bits`` and ``prune_flat`` against their JAX
  counterparts.
* Per-layer and global masks of both port routes (the kernels' plain
  versions and the argsort reference) against
  ``modelcompression_tpu.compress.criteria`` on ``tiny_region_cfg``
  params, including a layer quantized to 3 levels (ties at the cut, which
  only the HWIO flat order breaks as the JAX package does) and re-pruning
  pruned weights (the ``tau == 0`` rule).

Every output is an integer count, a mask or a copy of a weight, so every
comparison is exact. The CUDA kernels are held against the plain versions
on the card in tests/test_torch_cuda_kernels.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.compress import apply_masks as jax_apply_masks
from modelcompression_tpu.compress import criteria as jcrit
from modelcompression_tpu.data.fixtures import tiny_region_cfg
from modelcompression_tpu.models import init_params as jax_init_params
from modelcompression_tpu.models import parse_cfg as jax_parse_cfg
from modelcompression_tpu.models.darknet import conv_key
from modelcompression_tpu.ops import pallas_topk as jpt
from modelcompression_tpu.ops import topk_mask as jtm
from modelcompression_tpu_torch.compress import criteria as tcrit
from modelcompression_tpu_torch.models import params_from_jax, parse_cfg
from modelcompression_tpu_torch.ops import cuda_topk as ct
from modelcompression_tpu_torch.ops import topk_mask as ttm

JCHUNK = jpt.CHUNK
N = 2 * JCHUNK
SIZES = (100_000, 120_000, N - 220_000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The arrays here are small; one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_case(seed=0):
    """bf16-valued fp32 weights (the low 16 bits cleared) with 5% exact
    zeros, three contiguous segments; |w| bits as uint32 for JAX."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(N).astype(np.float32)
    w = (w.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    w[rng.random(N) < 0.05] = 0.0
    seg = np.repeat(np.arange(3, dtype=np.int32), SIZES)
    bits = w.view(np.uint32) & np.uint32(0x7FFFFFFF)
    return w, bits, seg


def _jax2d(a):
    return jnp.asarray(a).reshape(-1, 128)


def _t(a):
    """numpy -> torch; uint32 bit patterns (all < 2**31) as int32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _kth(bits, seg, ks):
    return np.array([np.sort(bits[seg == s])[k] for s, k in enumerate(ks)],
                    np.uint32)


def test_count_le_plain_matches_pallas():
    _, bits, seg = _flat_case()
    mid = _kth(bits, seg, (0, 50_000, SIZES[2] - 1))
    want = np.asarray(jpt.pallas_count_le(_jax2d(bits), _jax2d(seg),
                                          jnp.asarray(mid), 3))
    got = ct.count_le_plain(_t(bits), _t(seg), _t(mid).long(), 3)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def _tie_inputs(bits, seg):
    tau = _kth(bits, seg, (70_000, 60_000, 10_000))
    at = bits == tau[seg]
    per_chunk = np.stack([np.bincount(seg[c * JCHUNK:(c + 1) * JCHUNK],
                                      at[c * JCHUNK:(c + 1) * JCHUNK],
                                      minlength=3)
                          for c in range(N // JCHUNK)]).astype(np.int64)
    return tau, per_chunk


def test_tie_counts_plain_matches_pallas():
    _, bits, seg = _flat_case()
    tau, per_chunk = _tie_inputs(bits, seg)
    assert (per_chunk.sum(0) > 50).all()  # the case has ties
    want = np.asarray(jpt.pallas_tie_counts(_jax2d(bits), _jax2d(seg),
                                            jnp.asarray(tau), 3))
    got = ct.tie_counts_plain(_t(bits), _t(seg), _t(tau), 3, chunk=JCHUNK)
    assert got.dtype == torch.int32 and got.shape == (N // JCHUNK, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, per_chunk)


def test_apply_threshold_plain_matches_pallas():
    w, bits, seg = _flat_case()
    tau, per_chunk = _tie_inputs(bits, seg)
    budget = per_chunk.sum(0) // 2
    seg_tot, chunk_tot = per_chunk.sum(0), per_chunk.sum(1)
    seg_start = np.cumsum(seg_tot) - seg_tot
    chunk_off = np.cumsum(chunk_tot) - chunk_tot
    want = np.asarray(jpt.pallas_apply_threshold(
        _jax2d(w), _jax2d(bits), _jax2d(seg), jnp.asarray(tau),
        jnp.asarray(budget, jnp.int32), jnp.asarray(seg_start, jnp.int32),
        jnp.asarray(chunk_off, jnp.int32))).reshape(-1)
    got = ct.apply_threshold_plain(_t(w), _t(bits), _t(seg), _t(tau),
                                   _t(budget), _t(seg_start), _t(chunk_off),
                                   chunk=JCHUNK)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    # some ties are zeroed and some kept
    at = bits == tau[seg]
    assert (want[at] == 0).any() and (want[at] != 0).any()


def test_segmented_kth_bits_matches_jax():
    _, bits, seg = _flat_case()
    for ks in ((0, 0, 0), (1, 99_999, 7), (SIZES[0] - 1, SIZES[1] - 1,
                                          SIZES[2] - 1)):
        k = np.asarray(ks, np.int32)
        want = np.asarray(jtm.segmented_kth_bits(
            jnp.asarray(bits), jnp.asarray(seg), jnp.asarray(k), 3))
        got = ttm.segmented_kth_bits(_t(bits), _t(seg), _t(k), 3)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(want, _kth(bits, seg, ks))


@pytest.mark.parametrize("return_mask", [False, True])
def test_prune_flat_matches_pallas_prune_flat(return_mask):
    """Three real segments and a zero padding segment with nothing to
    prune, as the layout helpers build them."""
    w, _, _ = _flat_case(seed=1)
    real = (90_000, 110_000, N - 10_000 - 200_000)
    w[N - 10_000:] = 0.0
    seg = np.repeat(np.arange(4, dtype=np.int32), real + (10_000,))
    n_zero = np.array([int(0.75 * s) for s in real] + [0], np.int32)
    want = np.asarray(jpt.pallas_prune_flat(
        jnp.asarray(w), jnp.asarray(seg), jnp.asarray(n_zero), 4,
        return_mask=return_mask))
    got = ct.prune_flat(_t(w), _t(seg), _t(n_zero), 4,
                        return_mask=return_mask).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    zeros = [(got[a:a + s] == 0).sum() for a, s in
             zip(np.cumsum((0,) + real[:-1]), real)]
    assert zeros == [int(0.75 * s) for s in real]


def test_cuda_wrappers_refuse_cpu_tensors():
    _, bits, seg = _flat_case()
    n0 = ct.count_le_cuda.LAUNCHES
    r0 = ct.radix_select_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ct.count_le_cuda(_t(bits), _t(seg), torch.zeros(3), 3)
    with pytest.raises(ValueError, match="CUDA"):
        ct.tie_counts_cuda(_t(bits), _t(seg), torch.zeros(3), 3)
    with pytest.raises(ValueError, match="CUDA"):
        ct.radix_select_cuda(_t(bits), _t(seg), torch.zeros(3), 3)
    assert ct.count_le_cuda.LAUNCHES == n0
    assert ct.radix_select_cuda.LAUNCHES == r0


# ---- masks on a network ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_model(seed):
    jspec = jax_parse_cfg(tiny_region_cfg(num_classes=2, width=64,
                                          height=64))
    return jspec, jax.tree.map(np.asarray,
                               jax_init_params(jspec, jax.random.key(seed)))


def _spec_params(seed=0):
    """(JAX spec, JAX numpy params, port spec); the params dict is a fresh
    copy that a test may change entries of."""
    jspec, jparams = _jax_model(seed)
    spec = parse_cfg(tiny_region_cfg(num_classes=2, width=64, height=64))
    return jspec, {k: dict(p) for k, p in jparams.items()}, spec


def _hwio_to_oihw(m):
    return np.asarray(m).transpose(3, 2, 0, 1)


_PORT_ROUTES = {
    "cuda_topk": (ct.magnitude_masks_perlayer, ct.magnitude_masks_global),
    "reference": (tcrit.magnitude_masks_perlayer,
                  tcrit.magnitude_masks_global),
}
_JAX_REF = {"perlayer": jcrit.magnitude_masks_perlayer,
            "global": jcrit.magnitude_masks_global}


@functools.lru_cache(maxsize=None)
def _jax_masks(mode, sparsity):
    jspec, jparams = _jax_model(0)
    return _JAX_REF[mode](jparams, jspec, sparsity)


def _assert_masks_equal(got, want_hwio):
    assert set(got) == set(want_hwio)
    for k, m in want_hwio.items():
        assert got[k].dtype == torch.bool
        np.testing.assert_array_equal(got[k].numpy(), _hwio_to_oihw(m),
                                      err_msg=k)


@pytest.mark.parametrize("route", sorted(_PORT_ROUTES))
@pytest.mark.parametrize("mode", ["perlayer", "global"])
@pytest.mark.parametrize("sparsity", [0.0, 0.25, 0.75, 0.9])
def test_masks_match_jax_criteria(route, mode, sparsity):
    jspec, jparams, spec = _spec_params()
    want = _jax_masks(mode, sparsity)
    fn = _PORT_ROUTES[route][mode == "global"]
    got = fn(params_from_jax(jparams), spec, sparsity)
    _assert_masks_equal(got, want)
    n = sum(m.numel() for m in got.values())
    if mode == "global":
        assert n - sum(int(m.sum()) for m in got.values()) \
            == int(sparsity * n)


def _three_level(jspec, jparams):
    """One layer quantized to |w| in {0, 0.5, 1, ...}: massive ties."""
    k0 = conv_key(jspec.conv_indices()[1])
    w = jparams[k0]["w"]
    jparams[k0] = dict(jparams[k0], w=(np.sign(w) * np.round(np.abs(w) * 2)
                                       / 2).astype(np.float32))
    return k0


@pytest.mark.parametrize("mode", ["perlayer", "global"])
def test_masks_break_ties_in_hwio_order(mode):
    jspec, jparams, spec = _spec_params(seed=1)
    k0 = _three_level(jspec, jparams)
    params = params_from_jax(jparams)
    for sparsity in (0.3, 0.5):
        want = _JAX_REF[mode](jparams, jspec, sparsity)
        for route, fns in _PORT_ROUTES.items():
            got = fns[mode == "global"](params, spec, sparsity)
            _assert_masks_equal(got, want)
    # the case is sensitive to the flat order: ranking the OIHW flattening
    # of the tied layer breaks its ties elsewhere
    w = params[k0]["w"]
    oihw_rank = tcrit._rank_mask_flat(w.abs().reshape(-1),
                                      int(0.5 * w.numel())).reshape(w.shape)
    want = _hwio_to_oihw(jcrit.magnitude_mask_layer(jparams[k0]["w"], 0.5))
    assert not np.array_equal(oihw_rank.numpy(), want)


def test_three_level_masks_match_pallas_masks():
    jspec, jparams, spec = _spec_params(seed=1)
    _three_level(jspec, jparams)
    want = jpt.pallas_magnitude_masks_perlayer(jparams, jspec, 0.5)
    got = ct.magnitude_masks_perlayer(params_from_jax(jparams), spec, 0.5)
    _assert_masks_equal(got, want)


@pytest.mark.parametrize("first, second", [(0.5, 0.75), (0.75, 0.5)])
@pytest.mark.parametrize("mode", ["perlayer", "global"])
def test_reprune_matches_jax(first, second, mode):
    """Masks of already-pruned weights. Pruned at 0.75 and re-pruned at
    0.5, the k-th smallest |w| is 0.0 (tau == 0): the zeros are the ties,
    and exactly the first floor(0.5 n) of them are pruned."""
    jspec, jparams, spec = _spec_params(seed=2)
    jparams = jax.tree.map(np.asarray, jax_apply_masks(
        jparams, _JAX_REF[mode](jparams, jspec, first)))
    params = params_from_jax(jparams)
    want = _JAX_REF[mode](jparams, jspec, second)
    for fns in _PORT_ROUTES.values():
        _assert_masks_equal(fns[mode == "global"](params, spec, second),
                            want)
    if second < first:
        keys, cat, _, seg, n_zero, n_seg = ct._prune_layout(
            params, spec, second, mode == "perlayer", ())
        kth = ttm.segmented_kth_bits(ttm.abs_bits(cat), seg,
                                     (n_zero - 1).clamp_min(0), n_seg)
        assert (kth[:-1] == 0).all()  # tau == 0 in every real segment


def test_reprune_masks_match_pallas_masks():
    jspec, jparams, spec = _spec_params(seed=2)
    jparams = jax.tree.map(np.asarray, jax_apply_masks(
        jparams, jcrit.magnitude_masks_global(jparams, jspec, 0.75)))
    want = jpt.pallas_magnitude_masks_global(jparams, jspec, 0.5)
    got = ct.magnitude_masks_global(params_from_jax(jparams), spec, 0.5)
    _assert_masks_equal(got, want)


def test_magnitude_prune_and_helpers_match_jax():
    jspec, jparams, spec = _spec_params(seed=3)
    params = params_from_jax(jparams)
    pruned = ct.magnitude_prune(params, spec, 0.6, per_layer=False)
    masks = jcrit.magnitude_masks_global(jparams, jspec, 0.6)
    want = jax_apply_masks(jparams, masks)
    for k in want:
        np.testing.assert_array_equal(pruned[k]["w"].numpy(),
                                      _hwio_to_oihw(want[k]["w"]))
        assert all(pruned[k][n] is params[k][n] for n in params[k]
                   if n != "w")
    tmasks = {k: torch.from_numpy(_hwio_to_oihw(m)) for k, m in masks.items()}
    n = sum(m.numel() for m in tmasks.values())
    assert tcrit.mask_sparsity(tmasks) == int(0.6 * n) / n
    # the JAX package divides in float32
    assert tcrit.mask_sparsity(tmasks) == pytest.approx(
        float(jcrit.mask_sparsity(masks)), rel=1e-6)
    assert float(tcrit.global_threshold(params, spec, 0.6)) \
        == float(jcrit.global_threshold(jparams, jspec, 0.6))
