"""The port's radix select (``ops/cuda_topk.radix_select_plain``, the plain
version of ``csrc/topk_radix_select.cu``) against the JAX package's
segmented bisection, on the CPU.

For every case, ``kth`` equals ``modelcompression_tpu/ops/topk_mask.py``
``segmented_kth_bits`` exactly, and ``n_below`` equals the port's
``count_le_rule(bits, seg, kth - 1)`` (the count strictly below) exactly.
Inputs are made with numpy from a seed. Also: the chunk ``prune_flat``
sizes the tie-count and apply grids with (``grid_chunk``), and the prune
at such chunks against the JAX package's rank mask. The kernel itself is
held against this plain version on the card in
tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompression_tpu.ops import topk_mask as jtm
from modelcompression_tpu_torch.ops import cuda_topk as ct
from modelcompression_tpu_torch.ops import topk_mask as ttm

N = 2 * 128 * 1024  # two of the TPU kernels' chunks
SIZES = (100_000, 120_000, N - 220_000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The arrays here are small; one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_weights(rng, n, zeros=0.05):
    """bf16-valued fp32 weights (the low 16 bits cleared: many ties) with
    a share of exact zeros."""
    w = rng.standard_normal(n).astype(np.float32)
    w = (w.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    w[rng.random(n) < zeros] = 0.0
    return w


def _case(name):
    """(weights, segment ids, k, S) of one case, from a seed."""
    rng = np.random.default_rng(len(name))
    sizes = np.array(SIZES)
    if name == "small_2048":  # 2,048 segments of 1-40 elements
        sizes = rng.integers(1, 41, ct.MAX_SEGMENTS)
    w = _bf16_weights(rng, int(sizes.sum()))
    seg = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    S = len(sizes)
    if name == "prune":  # the prune's k: floor(0.75 n) - 1
        k = (0.75 * sizes).astype(np.int64) - 1
    elif name == "k_first":
        k = np.zeros(S, np.int64)
    elif name == "k_last":
        k = sizes - 1
    elif name == "all_equal":  # one segment of a single value
        w[SIZES[0]:SIZES[0] + SIZES[1]] = -0.375
        k = np.array([7, 60_000, 9], np.int64)
    elif name == "empty_pad":
        # an empty padding segment (k = 0 >= its size 0) and a real one
        # whose k is past its end: no digit holds the k-th element
        S = 5
        k = np.array([5, SIZES[1] + 3, 0, 0, 0], np.int64)
    else:  # small_2048: k anywhere in each segment, or past it
        k = rng.integers(0, sizes + 2)
    return w, seg, k, S


CASES = ["prune", "k_first", "k_last", "all_equal", "empty_pad",
         "small_2048"]


@pytest.mark.parametrize("name", CASES)
def test_radix_select_plain_matches_jax_bisection(name):
    w, seg, k, S = _case(name)
    bits = w.view(np.uint32) & np.uint32(0x7FFFFFFF)
    want = np.asarray(jtm.segmented_kth_bits(
        jnp.asarray(bits), jnp.asarray(seg), jnp.asarray(k, jnp.int32), S))
    tbits, tseg = ttm.abs_bits(torch.from_numpy(w)), torch.from_numpy(seg)
    kth, n_below = ct.radix_select_plain(tbits, tseg, torch.from_numpy(k),
                                         S)
    assert kth.dtype == n_below.dtype == torch.int64
    np.testing.assert_array_equal(kth.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        n_below.numpy(), ttm.count_le_rule(tbits, tseg, kth - 1, S).numpy())
    if name == "empty_pad":  # past the end: the top pattern, everything below
        assert (kth[[1, 3, 4]] == 0x7FFFFFFF).all()
        assert int(n_below[1]) == SIZES[1] and int(n_below[4]) == 0
    if name == "all_equal":
        assert int(n_below[1]) == 0


def test_radix_select_dispatches_cpu_tensors_to_plain():
    w, seg, k, S = _case("prune")
    bits, tseg, tk = (ttm.abs_bits(torch.from_numpy(w)),
                      torch.from_numpy(seg), torch.from_numpy(k))
    n0 = ct.radix_select_cuda.LAUNCHES
    got = ct.radix_select(bits, tseg, tk, S)
    want = ct.radix_select_plain(bits, tseg, tk, S)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert ct.radix_select_cuda.LAUNCHES == n0


@pytest.mark.parametrize("n, chunk", [
    (681_408, 1024),         # the bisect prefilter: 64 x 10,647 (S=64)
    (50_642_944, 16 * 1024),  # YOLOv2-VOC's 23 convs, padded
    (5_000_000, 9 * 1024),
    (100, 1024),
])
def test_grid_chunk_fills_the_card(monkeypatch, n, chunk):
    """On a 132-SM card the chunk is the largest multiple of 1024, 16K at
    most, that still gives 4 blocks an SM; on the CPU it is CHUNK."""
    class Props:
        multi_processor_count = 132
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    assert ct.grid_chunk(n, torch.device("cuda")) == chunk
    assert ct.grid_chunk(n, torch.device("cpu")) == ct.CHUNK


@pytest.mark.parametrize("chunk", [1024, 5 * 1024])
def test_prune_flat_at_any_chunk_matches_jax_rank_mask(monkeypatch, chunk):
    """``prune_flat`` hands one chunk to the tie-count and apply steps; at
    the smaller chunks it picks on a card the keep mask is still the JAX
    package's rank mask."""
    rng = np.random.default_rng(chunk)
    sizes = (70_000, 1_000, 90_001, 3_071)
    w = _bf16_weights(rng, sum(sizes))
    seg = np.repeat(np.arange(4, dtype=np.int32), sizes)
    n_zero = np.array([int(0.75 * s) for s in sizes[:3]] + [0], np.int32)
    bits = w.view(np.uint32) & np.uint32(0x7FFFFFFF)
    want = np.asarray(jtm.segmented_rank_mask(
        jnp.asarray(bits), jnp.asarray(seg), jnp.asarray(n_zero), 4))
    monkeypatch.setattr(ct, "grid_chunk", lambda n, device: chunk)
    got = ct.prune_flat(torch.from_numpy(w), torch.from_numpy(seg),
                        torch.from_numpy(n_zero), 4, return_mask=True)
    np.testing.assert_array_equal(got.numpy() != 0, want)
