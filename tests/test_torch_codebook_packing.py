"""The port's weight sharing and entropy packing (modelcompression_tpu_torch/
compress/codebook.py, compress/packing.py, native/) against the JAX
package's, on the CPU.

Both are numpy on the host, fed the same HWIO arrays, so every result is
compared bit for bit: the k-means codebooks and codes, the Huffman code
lengths, canonical codes and payload bytes (native and numpy encoders,
native and pure-Python decoders), the fixed-width packing, and the
reconstructed params. A cmodel written by either package, packed
(huffman, fixed) or not, loads in the other to the same params; the same
for a packed int8 qmodel."""

import jax
import numpy as np
import pytest
import torch

from modelcompression_tpu.compress import codebook as jcb
from modelcompression_tpu.compress import packing as jpk
from modelcompression_tpu.compress import quantize as jq
from modelcompression_tpu.data.fixtures import tiny_region_cfg
from modelcompression_tpu.models import init_params as j_init
from modelcompression_tpu.models import parse_cfg as j_parse
from modelcompression_tpu.native import load_huffcodec as j_load_codec
from modelcompression_tpu_torch import native as tnative
from modelcompression_tpu_torch.compress import codebook as tcb
from modelcompression_tpu_torch.compress import packing as tpk
from modelcompression_tpu_torch.compress import quantize as tq
from modelcompression_tpu_torch.models import (
    params_from_jax, params_to_jax, parse_cfg,
)


def _net(seed=0, prune=0.0):
    text = tiny_region_cfg(num_classes=3, width=64, height=64)
    jspec, tspec = j_parse(text), parse_cfg(text)
    np_params = jax.tree.map(np.array, j_init(jspec, jax.random.key(seed)))
    if prune:
        rng = np.random.default_rng(seed)
        for p in np_params.values():
            p["w"][rng.random(p["w"].shape) < prune] = 0.0
    return jspec, tspec, np_params


def _symbols(rng, k, n, zero_frac):
    s = rng.integers(0, k, n).astype(np.uint16)
    s[rng.random(n) < zero_frac] = 0
    return s


def test_native_codec_builds_into_the_package_build_dir():
    lib = tnative.load_huffcodec()
    assert (lib is None) == (j_load_codec() is None)
    if lib is not None:
        assert tnative.library_path().startswith(tnative.BUILD_DIR)


@pytest.mark.parametrize("bits", [2, 4, 6, 9])
@pytest.mark.parametrize("kind", ["normal", "pruned", "few_distinct"])
def test_cluster_layer_bit_equal_jax(bits, kind):
    rng = np.random.default_rng(bits)
    w = rng.normal(0, 0.1, (3, 3, 8, 16)).astype(np.float32)
    if kind == "pruned":
        w[rng.random(w.shape) < 0.75] = 0.0
    elif kind == "few_distinct":
        w = rng.choice(np.float32([-0.5, 0.0, 0.25, 1.0]), w.shape)
    jc, jb = jcb.cluster_layer(w, bits)
    tc, tb = tcb.cluster_layer(w, bits)
    assert tc.dtype == jc.dtype and tb.dtype == jb.dtype
    assert np.array_equal(tc, jc) and np.array_equal(tb, jb)
    for bad in (1, 17):
        with pytest.raises(ValueError, match="bits must be in"):
            tcb.cluster_layer(w, bad)


def _assert_cmodel_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, e in want.items():
        assert sorted(got[k]) == sorted(e), k
        for f, v in e.items():
            assert got[k][f].dtype == np.asarray(v).dtype, (k, f)
            assert np.array_equal(got[k][f], np.asarray(v)), (k, f)


def _assert_params_equal(got_port, want_np):
    got = params_to_jax(got_port)
    assert sorted(got) == sorted(want_np)
    for k, p in want_np.items():
        for n, a in p.items():
            assert np.array_equal(got[k][n], np.asarray(a)), (k, n)


@pytest.mark.parametrize("prune", [0.0, 0.75])
def test_cluster_network_and_reconstruct_bit_equal_jax(prune):
    jspec, tspec, np_params = _net(1, prune)
    want = jcb.cluster_network(np_params, jspec, bits=5)
    got = tcb.cluster_network(params_from_jax(np_params, tspec), tspec,
                              bits=5)
    _assert_cmodel_equal(got, want)  # codes HWIO, as the JAX package's
    _assert_params_equal(tcb.reconstruct(got),
                         jax.tree.map(np.asarray, jcb.reconstruct(want)))
    if prune:  # pruned zeros stay exact
        for k, p in np_params.items():
            rec = params_to_jax(tcb.reconstruct(got))[k]["w"]
            assert np.array_equal(rec == 0, p["w"] == 0), k


@pytest.mark.parametrize("k, n, zero_frac", [
    (4, 0, 0.0), (4, 1, 0.0), (16, 1000, 0.0), (64, 5000, 0.75),
    (256, 5000, 0.3), (1024, 3000, 0.0)])
def test_huffman_codec_bytes_equal_jax(k, n, zero_frac):
    rng = np.random.default_rng(k + n)
    sym = _symbols(rng, k, n, zero_frac)
    freqs = np.bincount(sym, minlength=k)
    lengths = tpk.huffman_lengths(freqs)
    assert np.array_equal(lengths, jpk.huffman_lengths(freqs))
    assert np.array_equal(tpk.canonical_codes(lengths),
                          jpk.canonical_codes(lengths))
    want, _ = jpk.huffman_encode(sym, k)
    for force_numpy in (False, True):
        got, got_len = tpk.huffman_encode(sym, k, force_numpy=force_numpy)
        assert np.array_equal(got_len, lengths)
        assert got.tobytes() == want.tobytes()
    for force_python in (False, True):
        dec = tpk.huffman_decode(want, lengths, n, force_python=force_python)
        assert dec.dtype == np.uint16 and np.array_equal(dec, sym)
    payload, bits = tpk.pack_fixed(sym, k)
    jpayload, jbits = jpk.pack_fixed(sym, k)
    assert bits == jbits and payload.tobytes() == jpayload.tobytes()
    assert np.array_equal(tpk.unpack_fixed(payload, bits, n), sym)


def test_pack_codes_fields_equal_jax_and_decoders_reject_bad_streams():
    rng = np.random.default_rng(0)
    cases = [(_symbols(rng, 64, 4096, 0.8).reshape(4, 4, 16, 16), 64),
             (rng.integers(0, 256, 300).astype(np.uint16), 256),  # uniform
             (np.zeros((3, 3), np.uint16), 2)]
    for codes, k in cases:
        for method in ("huffman", "fixed"):
            want = jpk.pack_codes(codes, k, method)
            got = tpk.pack_codes(codes, k, method)
            assert sorted(got) == sorted(want)
            for f in want:
                assert got[f].dtype == want[f].dtype
                assert np.array_equal(got[f], want[f]), (method, f)
            assert tpk.packed_bits(got) == jpk.packed_bits(want)
            assert np.array_equal(tpk.unpack_codes(got), codes)
    with pytest.raises(ValueError, match="unknown pack method"):
        tpk.pack_codes(cases[0][0], 64, "zip")
    lengths = np.array([1, 2, 2], np.uint8)
    for force_python in (False, True):
        with pytest.raises(ValueError):
            tpk.huffman_decode(np.zeros(0, np.uint8), lengths, 4,
                               force_python=force_python)


@pytest.mark.parametrize("pack", [None, "huffman", "fixed"])
def test_cmodel_round_trips_between_packages(tmp_path, pack):
    jspec, tspec, np_params = _net(2, prune=0.75)
    jcm = jcb.cluster_network(np_params, jspec, bits=6)
    tcm = tcb.cluster_network(params_from_jax(np_params, tspec), tspec,
                              bits=6)
    want = jax.tree.map(np.asarray, jcb.reconstruct(jcm))
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jcb.save_cmodel(jpath, jcm, jspec, pack=pack)
    tcb.save_cmodel(tpath, tcm, tspec, pack=pack)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            assert np.array_equal(zj[f], zt[f]), f  # payload bytes too
    # each package loads the other's artifact to the same params
    t_from_j, t_spec = tcb.load_cmodel(jpath, spec=tspec)
    _assert_params_equal(t_from_j, want)
    j_from_t, _ = jcb.load_cmodel(tpath, spec=jspec)
    for k, p in want.items():
        for n, a in p.items():
            assert np.array_equal(np.asarray(j_from_t[k][n]), a), (k, n)
    other = parse_cfg(tiny_region_cfg(num_classes=4, width=64, height=64))
    with pytest.raises(ValueError, match="different architecture"):
        tcb.load_cmodel(jpath, spec=other)


@pytest.mark.parametrize("pack", ["huffman", "fixed"])
def test_packed_qmodel_round_trips_between_packages(tmp_path, pack):
    from tests.test_torch_quantize import _calibrated
    js, ts, jqp, tqp = _calibrated("region")
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jq.save_qmodel(jpath, jqp, js, pack=pack)
    tq.save_qmodel(tpath, tqp, ts, pack=pack)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert any("/wq_payload" in f for f in zt.files)
        for f in zj.files:
            assert np.array_equal(zj[f], zt[f]), f
    got, _ = tq.load_qmodel(jpath, spec=ts)
    back, _ = jq.load_qmodel(tpath, spec=js)
    for k, e in jqp.items():
        for f, v in e.items():
            assert np.array_equal(got[k][f].numpy(), np.asarray(v)), (k, f)
            assert np.array_equal(np.asarray(back[k][f]), np.asarray(v))
    assert got["conv0"]["w_q"].dtype == torch.int8
