"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a CUDA device
(the kernels have no CPU or interpret mode). This file imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from modelcompression_tpu_torch.ops import KERNELS
from modelcompression_tpu_torch.ops import conv_epilogue as tce
from modelcompression_tpu_torch.ops import cuda_topk as ct
from modelcompression_tpu_torch.ops import input_stage as tis
from modelcompression_tpu_torch.ops import topk_mask as ttm

FP32_ATOL = 1e-5
# the magnitude prune's kernels, in the order it launches them
TOPK_KERNELS = (ct.RADIX_SELECT, ct.TIE_COUNTS, ct.APPLY)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


def _case(c_out, h, w, b, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32))
    wt = torch.from_numpy(rng.normal(0, 0.2, (c_out, 3, 3, 3))
                          .astype(np.float32))
    bt = torch.from_numpy(rng.normal(0, 0.5, (c_out,)).astype(np.float32))
    return x.to(device), wt.to(device), bt.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_out, h, w", [(32, 64, 96), (8, 64, 96),
                                         (13, 34, 70), (1, 2, 2)])
def test_input_stage_kernel_matches_plain(cuda_device, c_out, h, w, dtype):
    """Includes a ragged tile (H/2, W/2 not multiples of the block tile)
    and channel counts that are not a register width. Tolerance: fp32
    atol 1e-5 (summation order only); bf16 one bf16 ulp of the largest
    output (2**-7 relative), since a summation-order difference can move
    the single final rounding by one ulp."""
    x, wt, bt = _case(c_out, h, w, 3, c_out, cuda_device)
    kernels = (tis.MMA, tis.F32)
    n0 = [k.launches for k in kernels]
    at0 = [k.at[c_out] for k in kernels]
    got = tis.fused_conv1_pool(x, wt, bt, dtype)
    torch.cuda.synchronize()
    # bf16 runs on the tensor cores, fp32 on the fp32 CUDA-core kernel
    want_launches = [1, 0] if dtype == torch.bfloat16 else [0, 1]
    assert [k.launches - n for k, n in zip(kernels, n0)] == want_launches
    assert [k.at[c_out] - n
            for k, n in zip(kernels, at0)] == want_launches
    want = tis.fused_conv1_pool_plain(x, wt, bt, dtype)
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape == (3, h // 2, w // 2, c_out)
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= (FP32_ATOL if dtype == torch.float32
                   else 2.0 ** -7 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("c_out, h, w", [(32, 64, 96), (8, 64, 96),
                                         (13, 34, 70), (1, 2, 2)])
def test_input_stage_bf16_kernels_match_plain(cuda_device, c_out, h, w):
    """The bf16 kernel called directly (the mma kernel, the serving
    route) against the plain version, within one bf16 ulp of the largest
    output."""
    x, wt, bt = _case(c_out, h, w, 3, 100 + c_out, cuda_device)
    x = x.to(torch.bfloat16)
    got = tis.fused_conv1_pool_mma(x, wt, bt)
    torch.cuda.synchronize()
    want = tis.fused_conv1_pool_plain(x, wt, bt, torch.bfloat16)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (3, h // 2, w // 2, c_out)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * max(1.0, want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("c_out, h, w, misaligned", [
    (32, 64, 96, False), (8, 64, 96, False), (13, 34, 70, False),
    (1, 2, 2, False), (24, 36, 68, False), (32, 64, 96, True)])
def test_input_stage_fp32_kernels_match_plain(cuda_device, c_out, h, w,
                                              misaligned):
    """The fp32 kernel called directly (``f32``, the BITMATCH route)
    against the plain version, atol 1e-5 (summation order only). W % 4 ==
    0 with an aligned x takes the 16-byte halo copies, the rest the 4-byte
    ones; 34x70 and 36x68 leave ragged tiles, C = 13 and 24 pad the
    channel groups."""
    x, wt, bt = _case(c_out, h, w, 3, 200 + c_out, cuda_device)
    if misaligned:
        x = _unaligned(x)
    got = tis.fused_conv1_pool_f32(x, wt, bt)
    torch.cuda.synchronize()
    want = tis.fused_conv1_pool_plain(x, wt, bt, torch.float32)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (3, h // 2, w // 2, c_out)
    assert (got - want).abs().max().item() <= FP32_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("c_out", [32, 13])
def test_input_stage_f32_one_hot_taps(cuda_device, c_out):
    """For each of the 27 taps, a weight of 1 at that tap of one channel
    (bias 0) gives that channel exactly the 2x2-max-pooled, leaky'd input
    channel shifted by the tap (one product of 1 and x, the rest zeros:
    every sum is exact), and every other channel 0. A slip in the halo
    layout, the window offsets or the lane mapping names the wrong tap."""
    b, h, w = 2, 34, 68  # ragged tiles in both directions, 16-byte copies
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, h, w, 3))
                         .astype(np.float32)).to(cuda_device)
    xpad = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    bias = torch.zeros(c_out, device=cuda_device)
    for ky in range(3):
        for kx in range(3):
            for ci in range(3):
                k = (ky * 3 + kx) * 3 + ci
                c = k % c_out
                wt = torch.zeros((c_out, 3, 3, 3), device=cuda_device)
                wt[c, ci, ky, kx] = 1.0
                got = tis.fused_conv1_pool_f32(x, wt, bias)
                shifted = xpad[:, ky:ky + h, kx:kx + w, ci]
                y = shifted.reshape(b, h // 2, 2, w // 2, 2).amax((2, 4))
                y = torch.where(y > 0, y, 0.1 * y)
                assert torch.equal(got[..., c], y), \
                    f"tap {k} (ky={ky}, kx={kx}, ci={ci}) -> channel {c}"
                others = torch.ones(c_out, dtype=torch.bool,
                                    device=cuda_device)
                others[c] = False
                assert not got[..., others].any(), \
                    f"tap {k} leaked into another channel"


@pytest.mark.cuda
@pytest.mark.parametrize("c_out", [32, 13])
def test_input_stage_mma_one_hot_taps(cuda_device, c_out):
    """For each of the 27 taps, a weight of 1 at that tap of one channel
    (bias 0) gives that channel the 2x2-max-pooled, leaky'd input channel
    shifted by the tap, and every other channel 0. A slip in the mma
    fragment layout or the halo offsets names the wrong tap."""
    b, h, w = 2, 34, 70  # ragged tiles in both directions
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, h, w, 3))
                         .astype(np.float32)).to(cuda_device)
    x = x.to(torch.bfloat16)
    xpad = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    bias = torch.zeros(c_out, device=cuda_device)
    for ky in range(3):
        for kx in range(3):
            for ci in range(3):
                k = (ky * 3 + kx) * 3 + ci
                c = k % c_out
                wt = torch.zeros((c_out, 3, 3, 3), device=cuda_device)
                wt[c, ci, ky, kx] = 1.0
                got = tis.fused_conv1_pool_mma(x, wt, bias).float()
                shifted = xpad[:, ky:ky + h, kx:kx + w, ci]
                y = shifted.reshape(b, h // 2, 2, w // 2, 2).amax((2, 4))
                y = torch.where(y > 0, y, 0.1 * y).to(torch.bfloat16)
                err = (got[..., c] - y.float()).abs().max().item()
                assert err <= 2.0 ** -7, f"tap {k} (ky={ky}, kx={kx}, " \
                    f"ci={ci}) -> channel {c}: max abs err {err}"
                others = torch.ones(c_out, dtype=torch.bool,
                                    device=cuda_device)
                others[c] = False
                assert not got[..., others].any(), \
                    f"tap {k} leaked into another channel"


@pytest.mark.cuda
def test_input_stage_kernel_rejects_bad_shapes(cuda_device):
    x, wt, bt = _case(8, 6, 6, 1, 0, cuda_device)
    with pytest.raises(ValueError, match="even"):
        tis.fused_conv1_pool_mma(x[:, :5].to(torch.bfloat16), wt, bt)
    w33 = torch.zeros((33, 3, 3, 3), device=cuda_device)
    with pytest.raises(ValueError, match="C <= 32"):
        tis.fused_conv1_pool_mma(x.to(torch.bfloat16), w33,
                                 torch.zeros(33, device=cuda_device))
    with pytest.raises(ValueError, match="even"):
        tis.fused_conv1_pool_f32(x[:, :, :5], wt, bt)
    with pytest.raises(ValueError, match="fp32"):
        tis.fused_conv1_pool_f32(x.to(torch.bfloat16), wt, bt)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tis.fused_conv1_pool(x, wt, bt, torch.float16)


@pytest.mark.cuda
def test_eval_step_cuda_matches_cpu_bitmatch(cuda_device):
    """The whole serving step (the fp32 input-stage kernel included) on the
    card against the same step on the CPU, fp32 BITMATCH with TF32 off:
    raw-map-level differences are summation order only, so detection
    counters agree and scores agree to 1e-4."""
    from modelcompression_tpu_torch.core.precision import BITMATCH
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, make_eval_step,
    )
    from modelcompression_tpu_torch.models import (
        fold_batchnorm, init_params, params_to, tiny_yolov2_voc,
    )
    spec = tiny_yolov2_voc()
    spec.net.width = spec.net.height = 96
    params = fold_batchnorm(init_params(spec, seed=0), spec)
    imgs = np.random.default_rng(0).integers(0, 255, (2, 72, 80, 3),
                                             np.uint8)
    ws, hs = np.full(2, 80.0, np.float32), np.full(2, 72.0, np.float32)
    outs = {}
    kernels = (tis.F32, tis.MMA)
    n0 = [k.launches for k in kernels]
    for dev in ("cpu", "cuda"):
        cfg = EvalConfig(conf_thresh=0.01, max_detections=8,
                         nms_prefilter=32, precision=BITMATCH, device=dev)
        step = make_eval_step(spec, cfg, src_hw=(72, 80))
        outs[dev] = [t.cpu().numpy() for t in
                     step(params_to(params, dev), imgs, ws, hs)]
    # the card's step went through the fp32 kernel, once
    assert [k.launches - n for k, n in zip(kernels, n0)] == [1, 0]
    (sc, vc, ac), (sg, vg, ag) = ((o[1], o[3], o[4]) for o in
                                  (outs["cpu"], outs["cuda"]))
    np.testing.assert_array_equal(vg, vc)
    np.testing.assert_array_equal(ag, ac)
    np.testing.assert_allclose(sg, sc, atol=1e-4)


# ---- the magnitude top-k/mask kernels (exact: counts and copies of w) ------

# (segment sizes, bf16-valued weights, share of exact zeros, sparsity)
TOPK_CASES = {
    # one segment, the last chunk and the last 1024-element round ragged
    "ragged_S1": ([3 * ct.CHUNK + 1003], False, 0.0, 0.75),
    "S24": (None, False, 0.0, 0.75),
    "ties_S24": (None, True, 0.0, 0.75),
    # 60% zeros pruned at 0.5: the threshold is 0.0 in every segment
    "tau0_S24": (None, True, 0.6, 0.5),
}


def _unaligned(t):
    """``t`` copied into a buffer at a 4-byte offset: the kernels must
    take their scalar-load path (the fp32 input stage: 4-byte halo
    copies)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


def _topk_case(name, device, unaligned):
    sizes, ties, zeros, sparsity = TOPK_CASES[name]
    rng = np.random.default_rng(len(name))
    if sizes is None:  # 24 segments of mixed sizes, as YOLOv2's 23 + pad
        sizes = [int(s) for s in rng.integers(1, 9000, 23)] + [5003]
    n = sum(sizes)
    w = rng.standard_normal(n).astype(np.float32)
    if ties:
        w = (w.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    w[rng.random(n) < zeros] = 0.0
    seg = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    w = torch.from_numpy(w).to(device)
    seg = torch.from_numpy(seg).to(device)
    bits = ttm.abs_bits(w)
    if unaligned:
        w, bits, seg = (_unaligned(t) for t in (w, bits, seg))
    n_zero = torch.tensor([int(sparsity * s) for s in sizes], device=device)
    return w, bits, seg, n_zero, len(sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_topk_kernels_match_plain(cuda_device, case, unaligned):
    """Each kernel against its plain version on the same inputs, the
    inputs a prune of this case feeds it."""
    w, bits, seg, n_zero, S = _topk_case(case, cuda_device, unaligned)
    kth = ttm.segmented_kth_bits(bits, seg, (n_zero - 1).clamp_min(0), S)
    tau = torch.where(n_zero > 0, kth, 0)
    if case == "tau0_S24":
        assert (tau == 0).all()
    per_chunk = ct.tie_counts_cuda(bits, seg, tau, S)
    assert torch.equal(per_chunk, ct.tie_counts_plain(bits, seg, tau, S))
    assert per_chunk.shape == (-(-bits.numel() // ct.CHUNK), S)
    pc = per_chunk.long()
    chunk_off = torch.cumsum(pc.sum(1), 0) - pc.sum(1)
    seg_start = torch.cumsum(pc.sum(0), 0) - pc.sum(0)
    n_below = ct.count_le_plain(bits, seg, (tau - 1).clamp_min(0), S)
    budget = n_zero - torch.where(tau > 0, n_below, 0)
    args = (bits, seg, tau, budget, seg_start, chunk_off)
    for src in (w, torch.ones_like(w)):  # the pruned weights, the mask
        got = ct.apply_threshold_cuda(src, *args)
        want = ct.apply_threshold_plain(src, *args)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    pruned = torch.zeros(S, dtype=torch.int64, device=cuda_device) \
        .index_add_(0, seg.long(), (want == 0).long())
    assert torch.equal(pruned, n_zero)


def _small_segments_case(device, unaligned):
    """2,048 segments of 1-40 elements (some all equal, some past k):
    every block spans more segments than it has shared histograms, so
    most counts take the global-atomic path."""
    rng = np.random.default_rng(2048)
    sizes = rng.integers(1, 41, ct.MAX_SEGMENTS)
    n = int(sizes.sum())
    w = rng.standard_normal(n).astype(np.float32)
    w = (w.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    w[rng.random(n) < 0.2] = 0.0
    starts = np.cumsum(sizes) - sizes
    for s in range(0, ct.MAX_SEGMENTS, 97):  # all-equal segments
        w[starts[s]:starts[s] + sizes[s]] = 0.75
    seg = np.repeat(np.arange(ct.MAX_SEGMENTS, dtype=np.int32), sizes)
    k = rng.integers(0, sizes + 2)  # k >= size in some segments
    bits = ttm.abs_bits(torch.from_numpy(w).to(device))
    seg = torch.from_numpy(seg).to(device)
    if unaligned:
        bits, seg = _unaligned(bits), _unaligned(seg)
    return bits, seg, torch.from_numpy(k).to(device), ct.MAX_SEGMENTS


def _assert_radix_matches_plain(bits, seg, k, S):
    n0, at0 = ct.RADIX_SELECT.launches, ct.RADIX_SELECT.at[S]
    kth, n_below = ct.radix_select_cuda(bits, seg, k, S)
    torch.cuda.synchronize()
    assert ct.RADIX_SELECT.launches - n0 == 5
    assert ct.RADIX_SELECT.at[S] - at0 == 5
    want_kth, want_below = ct.radix_select_plain(bits, seg, k, S)
    assert kth.dtype == n_below.dtype == torch.int64
    assert torch.equal(kth, want_kth)
    assert torch.equal(n_below, want_below)


@pytest.mark.cuda
@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("case", sorted(TOPK_CASES) + ["small_2048"])
def test_radix_select_matches_plain(cuda_device, case, unaligned):
    """The radix-select kernel's kth and n_below equal its plain
    version's exactly: at the prune's k, at k = 0 and at k = size - 1 of
    each segment, and (2,048 small segments) on the global-atomic path
    with k past some segments."""
    if case == "small_2048":
        _assert_radix_matches_plain(*_small_segments_case(cuda_device,
                                                          unaligned))
        return
    _, bits, seg, n_zero, S = _topk_case(case, cuda_device, unaligned)
    sizes = torch.bincount(seg.long(), minlength=S)
    for k in ((n_zero - 1).clamp_min(0), torch.zeros_like(n_zero),
              sizes - 1):
        _assert_radix_matches_plain(bits, seg, k, S)


@pytest.mark.cuda
def test_radix_select_one_full_size_segment(cuda_device):
    """One segment of 50,634,592 weights (YOLOv2-VOC's conv count), the
    global prune's k-th |w|: equal to the plain version and to
    torch.kthvalue."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.randn(50_634_592, generator=gen, device=cuda_device) * 0.05
    bits = ttm.abs_bits(w)
    seg = torch.zeros_like(bits)
    k = torch.tensor([int(0.75 * w.numel()) - 1], device=cuda_device)
    _assert_radix_matches_plain(bits, seg, k, 1)
    kth, _ = ct.radix_select_cuda(bits, seg, k, 1)
    kv = torch.kthvalue(w.abs(), int(k[0]) + 1).values.reshape(1)
    assert int(kth[0]) == int(ttm.abs_bits(kv)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_tie_counts_and_apply_at_grid_chunk_match_plain(cuda_device, case):
    """The tie-count and apply kernels at the chunk ``prune_flat`` sizes
    to the input equal their plain versions at that chunk."""
    w, bits, seg, n_zero, S = _topk_case(case, cuda_device, False)
    chunk = ct.grid_chunk(bits.numel(), bits.device)
    assert chunk % 1024 == 0 and 1024 <= chunk <= ct.CHUNK
    kth, n_below = ct.radix_select_plain(bits, seg, (n_zero - 1)
                                         .clamp_min(0), S)
    tau = torch.where(n_zero > 0, kth, 0)
    per_chunk = ct.tie_counts_cuda(bits, seg, tau, S, chunk)
    assert torch.equal(per_chunk,
                       ct.tie_counts_plain(bits, seg, tau, S, chunk))
    pc = per_chunk.long()
    chunk_off = torch.cumsum(pc.sum(1), 0) - pc.sum(1)
    seg_start = torch.cumsum(pc.sum(0), 0) - pc.sum(0)
    budget = n_zero - torch.where(n_zero > 0, n_below, 0)
    args = (bits, seg, tau, budget, seg_start, chunk_off, chunk)
    got = ct.apply_threshold_cuda(w, *args)
    want = ct.apply_threshold_plain(w, *args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("return_mask", [False, True])
@pytest.mark.parametrize("case", ["ties_S24", "tau0_S24"])
def test_prune_flat_cuda_matches_cpu(cuda_device, case, return_mask):
    """The whole prune on the card (kernels) equals the prune on the CPU
    (plain versions), with 5 radix-select launches, and 1 tie-count and 1
    apply launch."""
    w, _, seg, n_zero, S = _topk_case(case, cuda_device, False)
    before = [k.launches for k in TOPK_KERNELS]
    before_at = [k.at[S] for k in TOPK_KERNELS]
    got = ct.prune_flat(w, seg, n_zero, S, return_mask=return_mask)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(TOPK_KERNELS, before)] \
        == [5, 1, 1]
    assert [k.at[S] - b for k, b in zip(TOPK_KERNELS, before_at)] \
        == [5, 1, 1]
    want = ct.prune_flat(w.cpu(), seg.cpu(), n_zero.cpu(), S,
                         return_mask=return_mask)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["perlayer", "global"])
def test_magnitude_masks_cuda_match_reference(cuda_device, mode):
    from modelcompression_tpu_torch.compress import criteria
    from modelcompression_tpu_torch.models import (
        init_params, params_to, tiny_yolov2_voc,
    )
    spec = tiny_yolov2_voc()
    params = params_to(init_params(spec, seed=0), cuda_device)
    fn = getattr(ct, f"magnitude_masks_{mode}")
    ref = getattr(criteria, f"magnitude_masks_{mode}")
    got, want = fn(params, spec, 0.75), ref(params, spec, 0.75)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _launch_counts(S):
    return [k.at[S] for k in TOPK_KERNELS]


@pytest.mark.cuda
@pytest.mark.parametrize("per_layer", [True, False])
def test_gmp_recompute_through_kernels_matches_plain(cuda_device,
                                                     per_layer):
    """A GMP mask update on the card (a due step; the old masks from an
    earlier recompute, so the intersection acts) equals the same update
    on the CPU (the kernels' plain versions), with 5/1/1 radix select /
    tie count / apply launches at S = convs + 1 (per layer) or 2
    (global)."""
    from modelcompression_tpu_torch.compress import gmp
    from modelcompression_tpu_torch.models import (
        init_params, params_to, tiny_yolov2_voc,
    )
    spec = tiny_yolov2_voc()
    cpu = init_params(spec, seed=3)
    g = gmp.GMPSpec(final_sparsity=0.75, begin=0, end=4, frequency=1,
                    per_layer=per_layer)
    old = gmp.gmp_masks(cpu, spec, gmp.gmp_sparsity(1, g),
                        per_layer=per_layer)
    card = params_to(cpu, cuda_device)
    S = len(spec.conv_indices()) + 1 if per_layer else 2
    before = _launch_counts(S)
    got = gmp.gmp_mask_update(g, spec, card, {k: m.to(cuda_device)
                                              for k, m in old.items()}, 3)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launch_counts(S), before)] == [5, 1, 1]
    want = gmp.gmp_mask_update(g, spec, cpu, old, 3)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("sparsity", [0.5, 0.95])
def test_lamp_cut_through_kernels_matches_plain(cuda_device, sparsity):
    """LAMP's global cut on the card (prune_flat at S = 2) equals its
    stable-argsort definition on the same card scores, and lamp_masks
    launches 5/1/1 at S = 2 with exactly int(sparsity * n) zeros."""
    from modelcompression_tpu_torch.compress import lamp
    from modelcompression_tpu_torch.models import (
        init_params, params_to, tiny_yolov2_voc,
    )
    spec = tiny_yolov2_voc()
    params = params_to(init_params(spec, seed=4), cuda_device)
    cat, sizes = lamp._scores_layout(params, sorted(params))
    n = sum(sizes)
    seg = ct._seg_ids_for(sizes, cat.numel(), False, 1, cuda_device)
    got = ct.prune_flat(cat, seg, torch.tensor([int(sparsity * n), 0],
                                               device=cuda_device), 2,
                        return_mask=True)[:n] != 0
    assert torch.equal(got, lamp.lamp_cut_plain(cat[:n], int(sparsity * n)))
    before = _launch_counts(2)
    masks = lamp.lamp_masks(params, spec, sparsity)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launch_counts(2), before)] == [5, 1, 1]
    assert sum(int((~m).sum()) for m in masks.values()) == int(sparsity * n)


@pytest.mark.cuda
def test_topk_kernels_at_yolov4_voc_layout_match_plain(cuda_device):
    """YOLOv4-VOC's per-layer prune layout (110 convs, 63,973,472 weights,
    S = 111 with the padding segment): the radix select past its 32 shared
    histograms a block, the tie count and the apply at the chunk
    ``prune_flat`` sizes to the input, each equal to its plain version on
    the card; the whole mask equal to the reference rule, with 5 / 0 / 1 /
    1 launches at this S."""
    from modelcompression_tpu_torch.compress import criteria
    from modelcompression_tpu_torch.models import (
        init_params, params_to, yolov4_voc,
    )
    spec = yolov4_voc()
    params = params_to(init_params(spec, seed=0), cuda_device)
    keys, cat, sizes, seg, n_zero, S = ct._prune_layout(params, spec, 0.75,
                                                        True, ())
    assert len(keys) == 110 and sum(sizes) == 63_973_472 and S == 111
    bits = ttm.abs_bits(cat)
    k = (n_zero - 1).clamp_min(0)
    _assert_radix_matches_plain(bits, seg, k, S)
    kth, n_below = ct.radix_select_plain(bits, seg, k, S)
    tau = torch.where(n_zero > 0, kth, 0)
    chunk = ct.grid_chunk(bits.numel(), bits.device)
    per_chunk = ct.tie_counts_cuda(bits, seg, tau, S, chunk)
    assert torch.equal(per_chunk,
                       ct.tie_counts_plain(bits, seg, tau, S, chunk))
    pc = per_chunk.long()
    args = (bits, seg, tau, n_zero - torch.where(n_zero > 0, n_below, 0),
            torch.cumsum(pc.sum(0), 0) - pc.sum(0),
            torch.cumsum(pc.sum(1), 0) - pc.sum(1), chunk)
    ones = torch.ones_like(cat)
    got = ct.apply_threshold_cuda(ones, *args)
    assert torch.equal(got.view(torch.int32),
                       ct.apply_threshold_plain(ones, *args)
                       .view(torch.int32))
    before = _launch_counts(S)
    masks = ct.magnitude_masks_perlayer(params, spec, 0.75)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launch_counts(S), before)] == [5, 1, 1]
    want = criteria.magnitude_masks_perlayer(params, spec, 0.75)
    for key, m in want.items():
        assert torch.equal(masks[key], m), key
        assert int((~m).sum()) == int(0.75 * m.numel()), key


@pytest.mark.cuda
def test_fpgm_scores_keep_fp32_under_global_tf32(cuda_device):
    """FPGM's Gram product runs with TF32 off inside the call even when
    the process allows TF32 for matmuls, and restores the setting: the
    scores of a YOLOv4-VOC-sized layer (1024 filters of 512 x 3 x 3) with
    near-identical pairs stay within 1e-5 of the largest float64 score."""
    from modelcompression_tpu_torch.compress import fpgm_filter_scores
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.randn((1024, 512, 3, 3), generator=gen,
                    device=cuda_device) * 0.02
    w[1::2] = w[0::2] + 1e-4 * torch.randn(
        (512, 512, 3, 3), generator=gen, device=cuda_device)
    x = w.double().reshape(1024, -1)
    want = torch.cdist(x, x).sum(1)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fpgm_filter_scores(w)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_topk_kernels_reject_bad_inputs(cuda_device):
    w, bits, seg, n_zero, S = _topk_case("S24", cuda_device, False)
    with pytest.raises(ValueError, match="int32"):
        ct.radix_select_cuda(bits.long(), seg, n_zero, S)
    with pytest.raises(ValueError, match="n_segments"):
        ct.tie_counts_cuda(bits, seg, torch.zeros(ct.MAX_SEGMENTS + 1),
                           ct.MAX_SEGMENTS + 1)
    with pytest.raises(ValueError, match="float32"):
        ct.apply_threshold_cuda(w.double(), bits, seg, n_zero, n_zero,
                                n_zero, torch.zeros(1))


# ---- evaluate on the card --------------------------------------------------

def _eval_fixture(tmp_path, n_images, size):
    from modelcompression_tpu_torch.data import (
        FIXTURE_CLASSES, load_list_dataset, make_fake_voc, read_data_cfg,
        tiny_region_cfg,
    )
    from modelcompression_tpu_torch.models import init_params, parse_cfg
    data = make_fake_voc(str(tmp_path), n_images=n_images, image_size=size,
                         seed=0)
    samples = load_list_dataset(read_data_cfg(data)["valid"])
    spec = parse_cfg(tiny_region_cfg(num_classes=3, width=size,
                                     height=size))
    return samples, FIXTURE_CLASSES, spec, init_params(spec, seed=0)


def _detections(chunk, classes, outs):
    """evaluate's per-class Detection lists for one batch's outputs."""
    from modelcompression_tpu_torch.evaluation import Detection
    boxes, scores, valid = (t.cpu().numpy() for t in outs[:3])
    dets = {c: [] for c in classes}
    for bi, s in enumerate(chunk):
        for ci, c in enumerate(classes):
            for k in np.nonzero(valid[bi, ci])[0]:
                dets[c].append(Detection(s.image_id, float(scores[bi, ci, k]),
                                         tuple(float(x)
                                               for x in boxes[bi, ci, k])))
    return dets


@pytest.mark.cuda
def test_evaluate_on_card_launches_mma_per_batch_and_equals_step(
        cuda_device, tmp_path):
    """5 images at batch 2 (a padded last batch): the tensor-core input
    stage launches once per batch and the CUDA-core ones never; the first
    batch's detections equal the eval step's on the same canvases."""
    from modelcompression_tpu_torch.evaluation import (
        EvalConfig, evaluate, make_eval_step,
    )
    from modelcompression_tpu_torch.evaluation.pipeline import _prep_batch
    from modelcompression_tpu_torch.models import fold_batchnorm, params_to
    samples, classes, spec, params = _eval_fixture(tmp_path, 5, 64)
    cfg = EvalConfig(batch_size=2, max_detections=10, device="cuda")
    kernels = (tis.MMA, tis.F32)
    n0 = [k.launches for k in kernels]
    c0 = tis.MMA.at[spec.layers[0].filters]
    res = evaluate(params, spec, samples, classes, cfg)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, n0)] == [3, 0]
    assert tis.MMA.at[spec.layers[0].filters] - c0 == 3
    assert res.n_images == 5 and res.device.startswith("cuda")
    step = make_eval_step(spec, cfg)
    first = samples[:2]
    outs = step(params_to(fold_batchnorm(params, spec), "cuda"),
                *_prep_batch(first, 64, 64, True))
    ids = {s.image_id for s in first}
    got = {c: [d for d in ds if d.image_id in ids]
           for c, ds in res.detections.items()}
    assert got == _detections(first, classes, outs)
    assert sum(map(len, got.values())) > 0


@pytest.mark.cuda
def test_prefetch_to_cuda_lands_before_it_is_read(cuda_device):
    from modelcompression_tpu_torch.data import prefetch_to_device
    items = [(np.full((64, 256, 256, 3), i, np.uint8), np.arange(4.0) + i)
             for i in range(6)]
    for i, (a, b) in enumerate(prefetch_to_device(items, depth=2,
                                                  device=cuda_device)):
        assert a.is_cuda and b.is_cuda
        assert int(a.float().mean().item()) == i
        np.testing.assert_array_equal(b.cpu().numpy(), np.arange(4.0) + i)


# ---- the fine-tune path on the card -----------------------------------------

def _finetune_fixture(tmp_path):
    """The tiny region cfg at 64x64 with random weights written as
    .weights, and an 8-image fixture at that size."""
    from modelcompression_tpu_torch.models import save_weights
    samples, _, spec, params = _eval_fixture(tmp_path, 8, 64)
    from modelcompression_tpu_torch.data import tiny_region_cfg
    cfg = str(tmp_path / "net.cfg")
    with open(cfg, "w") as f:
        f.write(tiny_region_cfg(num_classes=3, width=64, height=64))
    weights = str(tmp_path / "w.weights")
    save_weights(weights, spec, params, seen=0)
    return cfg, weights, str(tmp_path / "fixture.data"), spec


def _finetune(cfg, weights, data, out, *extra):
    from modelcompression_tpu_torch.cli import finetune
    return finetune.main(["--cfg", cfg, "--weights", weights, "--data",
                          data, "--steps", "2", "--batch", "4", "--out",
                          out, "--device", "cuda", *extra])


@pytest.mark.cuda
def test_finetune_iterate_magnitude_launches_topk_per_round(cuda_device,
                                                            tmp_path):
    """Two magnitude rounds recompute the masks through the kernels: the
    radix select 5 times a round, tie count and apply once; every
    round's
    eval runs the tensor-core input stage once per batch (8 images at
    batch 4); the written weights have floor(0.75 n) zeros per conv."""
    from modelcompression_tpu_torch.models import load_weights
    cfg, weights, data, spec = _finetune_fixture(tmp_path)
    kernels = TOPK_KERNELS + (tis.MMA,)
    n0 = [k.launches for k in kernels]
    out = str(tmp_path / "mag.weights")
    assert _finetune(cfg, weights, data, out, "--iterate", "0.5,0.75",
                     "--iterate-mode", "magnitude") == 0
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, n0)] == [10, 2, 2, 4]
    got, seen = load_weights(out, spec)
    assert seen == 2 * 2 * 4
    for k, p in got.items():
        assert int((p["w"] == 0).sum()) == int(0.75 * p["w"].numel()), k


@pytest.mark.cuda
def test_finetune_iterate_l1_filter_evals_at_each_width(cuda_device,
                                                        tmp_path):
    """Two l1_filter rounds repack conv1 from 16 filters to 8, then 4: the
    rounds' evals launch the tensor-core input stage at C=8, then C=4 (two
    batches each)."""
    cfg, weights, data, _ = _finetune_fixture(tmp_path)
    at0 = dict(tis.MMA.at)
    out = str(tmp_path / "slim.weights")
    assert _finetune(cfg, weights, data, out, "--iterate", "0.5,0.75",
                     "--iterate-mode", "l1_filter") == 0
    torch.cuda.synchronize()
    assert {c: tis.MMA.at[c] - at0.get(c, 0) for c in (16, 8, 4)} \
        == {16: 0, 8: 2, 4: 2}
    assert (tmp_path / "slim.cfg").exists()


def _nms_case(b, n, c, seed, levels=None):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (b, n, 2))
    wh = rng.uniform(0.02, 0.2, (b, n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n, c)) ** 4
    if levels is not None:  # many ties at the N'-th value
        scores = np.round(scores * levels) / levels
    return torch.from_numpy(boxes), torch.from_numpy(scores.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("b, n, c, prefilter, levels", [
    (64, 10647, 20, 128, None),   # YOLOv4-VOC-416's shape, overflow
    (4, 2535, 3, 64, 16),         # ties at the N'-th value
    (3, 500, 5, 1024, None),      # N' > N: keep all
])
def test_bisect_prefilter_kernels_match_plain(cuda_device, b, n, c,
                                              prefilter, levels):
    """The bisect prefilter on CUDA tensors launches radix select /
    tie-count / apply 5 / 1 / 1 times and keeps exactly the
    plain route's set (the CPU run of the same function) in the same
    slots."""
    from modelcompression_tpu_torch.evaluation import nms as tnms
    boxes, scores = _nms_case(b, n, c, seed=n, levels=levels)
    want = tnms.batched_bisect_prefilter(boxes, scores, 0.01, prefilter)
    n0 = [k.launches for k in TOPK_KERNELS]
    got = tnms.batched_bisect_prefilter(boxes.to(cuda_device),
                                        scores.to(cuda_device), 0.01,
                                        prefilter)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(TOPK_KERNELS, n0)] == [5, 1, 1]
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    sel = tnms.batched_per_class_nms_prefiltered(
        boxes.to(cuda_device), scores.to(cuda_device), 0.45, 0.01, 32,
        prefilter=prefilter, impl="bisect")
    ref = tnms.batched_per_class_nms_prefiltered(
        boxes, scores, 0.45, 0.01, 32, prefilter=prefilter, impl="bisect")
    for g, w in zip(sel, ref):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["padded", "padded_diou", "soft_gauss",
                                     "soft_linear", "diou_topk"])
def test_nms_variants_card_equals_cpu(cuda_device, variant):
    """Each NMS variant on identical inputs: the card's selections equal
    the CPU's (IEEE elementwise ops, stable sorts, first-max argmax);
    soft-NMS scores within 1e-6 relative (exp)."""
    from modelcompression_tpu_torch.evaluation import nms as tnms
    boxes, scores = _nms_case(2, 600, 4, seed=7)
    fns = {
        "padded": lambda b, s: tnms.batched_per_class_nms_padded(
            b, s, 0.45, 0.01, 16),
        "padded_diou": lambda b, s: tnms.batched_per_class_nms_padded(
            b, s, 0.45, 0.01, 16, diou=True, diou_beta=0.6),
        "soft_gauss": lambda b, s: tnms.batched_per_class_soft_nms(
            b, s, 0.45, 0.01, 16),
        "soft_linear": lambda b, s: tnms.batched_per_class_soft_nms(
            b, s, 0.45, 0.01, 16, linear=True),
        "diou_topk": lambda b, s: tnms.batched_per_class_nms(
            b, s, 0.45, 0.01, 16, diou=True, diou_beta=0.6),
    }
    want = fns[variant](boxes, scores)
    got = [t.cpu() for t in fns[variant](boxes.to(cuda_device),
                                         scores.to(cuda_device))]
    assert torch.equal(got[2], want[2]) and torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b, hw, c, k, n, stride", [
    (4, 34, 3, 3, 32, 1),    # conv1: 27 taps padded to 32
    (2, 13, 1024, 1, 125, 1),  # YOLOv2's head: width padded to 128
    (2, 20, 64, 3, 128, 2),  # a stride-2 3x3
    (1, 3, 8, 3, 8, 1),      # 9 rows: padded to 17
])
def test_int8_conv_card_route_equals_plain(cuda_device, b, hw, c, k, n,
                                           stride):
    """The int8 conv's card route (cuBLASLt's int8 GEMM over the im2col)
    against its plain version (an exact float64 conv) on the card: the
    int32 sums equal, one launch counted at the output width."""
    from modelcompression_tpu_torch.ops import int8_conv as ti8
    g = torch.Generator().manual_seed(b * 1000 + n)
    x = torch.randint(-127, 128, (b, hw, hw, c), dtype=torch.int8,
                      generator=g).to(cuda_device)
    w = torch.randint(-127, 128, (k, k, c, n), dtype=torch.int8,
                      generator=g).to(cuda_device)
    n0, at0 = ti8.int8_conv_cuda.LAUNCHES, ti8.int8_conv_cuda.LAUNCHES_AT[n]
    got = ti8.int8_conv(x, w, stride, k // 2)
    torch.cuda.synchronize()
    assert ti8.int8_conv_cuda.LAUNCHES == n0 + 1
    assert ti8.int8_conv_cuda.LAUNCHES_AT[n] == at0 + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, ti8.int8_conv_plain(x, w, stride, k // 2))


# ---- the conv epilogue: bias + activation in place after a folded conv -----

EPILOGUE_KINDS = ("linear", "leaky", "mish")


def _epilogue_case(b, c, h, w, seed, device, misaligned=False):
    """A bf16 conv output (B, C, H, W) in channels-last storage and an fp32
    bias. ``misaligned``: y's storage starts 2 bytes past a 16-byte
    boundary, so the kernel takes its scalar path whatever C is."""
    g = torch.Generator().manual_seed(seed)
    nhwc = (torch.randn((b, h, w, c), generator=g) * 4).to(torch.bfloat16)
    bias = torch.randn((c,), generator=g)
    buf = torch.empty(nhwc.numel() + int(misaligned), dtype=torch.bfloat16,
                      device=device)
    y = buf[int(misaligned):].view(b, h, w, c)
    y.copy_(nhwc)
    return y.permute(0, 3, 1, 2), bias.to(device)


def _bf16_ulps(got, want):
    """|got - want| in units of want's bf16 ulp (2^-7 of its magnitude,
    at least the smallest subnormal)."""
    want = want.double()
    ulp = torch.clamp(want.abs() * 2.0 ** -7, min=2.0 ** -133)
    return ((got.double() - want).abs() / ulp).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned, entry", [
    (False, "bias_act_cuda"), (True, "bias_act_cuda"), (False, "launch")],
    ids=["aligned", "misaligned", "launch"])
@pytest.mark.parametrize("kind", EPILOGUE_KINDS)
@pytest.mark.parametrize("b, c, h, w", [
    (3, 8, 7, 37),      # M = 777: ragged against any block of vectors
    (3, 32, 7, 37),
    (2, 75, 13, 13),    # YOLOv4's heads: the scalar path
    (2, 1024, 5, 13),
    (2, 128, 104, 104),  # a YOLOv4 shape (CSP stage 2 at 416)
])
def test_conv_epilogue_kernel_matches_plain(cuda_device, b, c, h, w, kind,
                                            misaligned, entry):
    """The kernel against its plain version: linear and leaky bit for bit
    (the same fp32 add and multiply, one rounding), mish within one bf16
    ulp (exp2f against torch.exp can move the one rounding); in place,
    one launch counted at C. Through the checked wrapper aligned (the
    vector path where C % 8 == 0) and misaligned (the scalar path), and
    through the forward's unchecked ``launch``."""
    y, bias = _epilogue_case(b, c, h, w, c + h, cuda_device, misaligned)
    want = tce.bias_act_plain(y, bias, kind)
    n0, at0 = tce.KERNEL.launches, tce.KERNEL.at[c]
    ptr = y.data_ptr()
    got = getattr(tce, entry)(y, bias, kind)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr and got.shape == want.shape
    assert tce.KERNEL.launches == n0 + 1
    assert tce.KERNEL.at[c] == at0 + 1
    if kind == "mish":
        assert _bf16_ulps(got, want) <= 1.0
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", EPILOGUE_KINDS)
@pytest.mark.parametrize("c", [32, 75])
def test_conv_epilogue_kernel_matches_eager_chain(cuda_device, kind, c):
    """The kernel against the eager bf16 chain it replaces in the folded
    forward (bias cast, add, activation passes), within 2 bf16 ulps of the
    largest magnitude: the chain rounds after every pass."""
    from modelcompression_tpu_torch.models import darknet
    y, bias = _epilogue_case(4, c, 26, 26, 7 * c, cuda_device)
    eager = darknet._activate(y + darknet._per_channel(bias, y.dtype), kind)
    got = tce.bias_act_cuda(y, bias, kind)
    torch.cuda.synchronize()
    top = eager.float().abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert (got.float() - eager.float()).abs().max().item() <= 2 * ulp


@pytest.mark.cuda
def test_conv_epilogue_mish_edges(cuda_device):
    """Mish at the cut-off, far above it and far below it (exp(v)
    subnormal in fp32) against the plain version, within one bf16 ulp."""
    v = torch.tensor([-100.0, -88.0, -20.0, -1.0, 0.0, 1.0, 19.5, 20.0,
                      21.0, 50.0, 88.0] * 8, dtype=torch.bfloat16)
    y = v.reshape(1, 1, 1, -1).to(cuda_device)  # C=1: channels-last too
    bias = torch.zeros(1, device=cuda_device)
    want = tce.bias_act_plain(y, bias, "mish")
    got = tce.bias_act_cuda(y.clone(), bias, "mish")
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _bf16_ulps(got, want) <= 1.0


@pytest.mark.cuda
def test_folded_forward_launches_epilogue_per_conv(cuda_device):
    """One FAST ``forward_folded`` of the YOLOv4-tiny fixture (mish, leaky
    and linear convs) on the card launches the epilogue once a conv, at
    each conv's width, and agrees with the eager chain on the same card
    to within bf16's drift over the stack; BITMATCH, and FAST under
    autograd, launch nothing."""
    from modelcompression_tpu_torch.core.precision import BITMATCH, FAST
    from modelcompression_tpu_torch.data.fixtures import tiny_yolo4_cfg
    from modelcompression_tpu_torch.models import darknet
    from modelcompression_tpu_torch.models.cfg import ConvLayer, parse_cfg
    spec = parse_cfg(tiny_yolo4_cfg(num_classes=3))
    convs = [l for l in spec.layers if isinstance(l, ConvLayer)]
    assert {l.activation for l in convs} == set(EPILOGUE_KINDS)
    folded = darknet.params_to(darknet.fold_batchnorm(
        darknet.init_params(spec, seed=0), spec), cuda_device)
    x = torch.rand((4, spec.net.height, spec.net.width, 3),
                   generator=torch.Generator().manual_seed(0)).to(cuda_device)

    def launches(fn):
        n0, at0 = tce.KERNEL.launches, dict(tce.KERNEL.at)
        out = fn()
        torch.cuda.synchronize()
        at = {c: n - at0.get(c, 0) for c, n in tce.KERNEL.at.items()
              if n != at0.get(c, 0)}
        return out, tce.KERNEL.launches - n0, at

    with torch.inference_mode():
        got, n, at = launches(lambda: darknet.forward_folded(
            folded, x, spec, FAST))
    assert n == len(convs)
    want_at = {}
    for l in convs:
        want_at[l.filters] = want_at.get(l.filters, 0) + 1
    assert at == want_at
    real_takes = tce.takes
    try:
        tce.takes = lambda y, kind: False
        with torch.inference_mode():
            eager, n_eager, _ = launches(lambda: darknet.forward_folded(
                folded, x, spec, FAST))
    finally:
        tce.takes = real_takes
    assert n_eager == 0
    for g, e in zip(got, eager):
        scale = e.abs().max().item()
        assert (g - e).abs().max().item() <= 0.03 * scale
    with torch.inference_mode():
        _, n_bitmatch, _ = launches(lambda: darknet.forward_folded(
            folded, x, spec, BITMATCH))
    assert n_bitmatch == 0
    grad_params = {k: {n_: t.detach().clone().requires_grad_(True)
                       for n_, t in p.items()} for k, p in folded.items()}
    out, n_grad, _ = launches(lambda: darknet.forward_folded(
        grad_params, x, spec, FAST))
    assert n_grad == 0
    sum(o.float().sum() for o in out).backward()


@pytest.mark.cuda
def test_conv_epilogue_rejects_bad_inputs(cuda_device):
    """fp32 y, a y in NCHW or in neither storage, a bias on another
    device than y and a CPU y raise before any launch, y untouched."""
    y, bias = _epilogue_case(2, 16, 4, 4, 0, cuda_device)
    before = y.clone()
    n0 = tce.KERNEL.launches
    cases = [
        (y.float(), bias, "bf16"),
        (y.contiguous(), bias, "channels-last"),
        (y.transpose(2, 3).contiguous().transpose(2, 3), bias,
         "channels-last"),
        (y, bias.cpu(), "fp32"),
        (y.cpu(), bias.cpu(), "CUDA tensor"),
    ]
    for yy, bb, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tce.bias_act_cuda(yy, bb, "mish")
    torch.cuda.synchronize()
    assert tce.KERNEL.launches == n0
    assert torch.equal(y, before)


def _yolov4_tiny_forward(device):
    """One FAST forward of the YOLOv4-tiny fixture on the card, and its
    conv count: the conv epilogue's launches."""
    from modelcompression_tpu_torch.core.precision import FAST
    from modelcompression_tpu_torch.data.fixtures import tiny_yolo4_cfg
    from modelcompression_tpu_torch.models import darknet
    from modelcompression_tpu_torch.models.cfg import ConvLayer, parse_cfg
    spec = parse_cfg(tiny_yolo4_cfg(num_classes=3))
    folded = darknet.params_to(darknet.fold_batchnorm(
        darknet.init_params(spec, seed=0), spec), device)
    x = torch.rand((2, spec.net.height, spec.net.width, 3),
                   generator=torch.Generator().manual_seed(0)).to(device)
    n_convs = sum(isinstance(l, ConvLayer) for l in spec.layers)
    return lambda: darknet.forward_folded(folded, x, spec, FAST), n_convs


def _launching(source, device):
    """A call that launches ``source``'s kernel, its launches, and a part
    of the name of the device kernel each launch runs."""
    if source == "conv_epilogue":
        fn, n = _yolov4_tiny_forward(device)
        return fn, n, "conv_epilogue_"
    if source.startswith("input_stage"):
        x, wt, bt = _case(16, 64, 64, 2, 0, device)
        if source == "input_stage_mma":
            x = x.to(torch.bfloat16)
            return (lambda: tis.fused_conv1_pool_mma(x, wt, bt), 1,
                    "conv1_pool_mma_kernel")
        return (lambda: tis.fused_conv1_pool_f32(x, wt, bt), 1,
                "conv1_pool_f32_kernel")
    w, _, seg, n_zero, S = _topk_case("S24", device, False)
    n, name = {"topk_radix_select": (5, "radix_"),
               "topk_tie_counts": (1, "tie_counts_kernel"),
               "topk_apply": (1, "apply_kernel")}[source]
    return lambda: ct.prune_flat(w, seg, n_zero, S), n, name


@pytest.mark.cuda
@pytest.mark.parametrize("source", [k.source for k in KERNELS])
def test_conv_epilogue_launch_is_a_host_op_under_the_profiler(cuda_device,
                                                             source):
    """Under ``torch.profiler`` each launch of every csrc/ kernel (the
    conv epilogue's in one FAST forward of the YOLOv4-tiny fixture, the
    input stages' in one call, the top-k kernels' in one magnitude prune)
    is a host op named after its source with exactly one device kernel
    linked to it, its own: the trace counts it as it counts PyTorch's own
    ops."""
    from torch.profiler import ProfilerActivity, profile
    fn, n, name = _launching(source, cuda_device)
    with torch.inference_mode():
        fn()  # built and warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.name == source]
    assert len(ops) == n
    assert all(len(e.kernels) == 1 and name in e.kernels[0].name
               for e in ops), [[k.name for k in e.kernels] for e in ops]
