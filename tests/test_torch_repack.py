"""The port's repackers, load of one tensor and serving prep against the
reference's, bit for bit (eagle_tpu_torch/quant/qtensor.py, quant/serving.py
and models/loader.py against eagle_tpu's).

Inputs are the same GGUF block bytes: ggml-quantized weights, and raw
random blocks (every code and sub-scale pattern, scales finite with
subnormals and negative zeros among them). Each port repacker runs as torch
ops on the CPU and must equal `repack_numpy` with the numpy path and with the
native default, and `repack_coded_numpy` for the coded formats. The loader's
per-tensor path (row permutation along N, "kn" transpose, coded or
materialized) and `prepare_qtensor` (nibble packing, "f32"/"bf16") must
give the reference's arrays. No tolerance: a repack is exact."""

import dataclasses

import numpy as np
import pytest
import torch

from eagle_tpu.gguf.constants import GGMLType as J
from eagle_tpu.gguf.reader import GGUFReader as JReader
from eagle_tpu.gguf.writer import GGUFWriter as JWriter
from eagle_tpu.models import loader as jloader
from eagle_tpu.quant.blocks import quantize
from eagle_tpu.quant.qtensor import repack_coded_numpy, repack_numpy
from eagle_tpu.quant.serving import prepare_qtensor as jprepare
from eagle_tpu_torch.gguf import GGUFReader
from eagle_tpu_torch.models import loader
from eagle_tpu_torch.quant.qtensor import repack, repack_coded
from eagle_tpu_torch.quant.serving import prepare_qtensor
from torch_port_util import assert_bits_equal

TYPES = [J.Q4_0, J.Q8_0, J.Q4_K, J.Q6_K]
SHAPE = (64, 512)
#: byte offsets of each block's f16 scales (d, and dmin for Q4_K)
_F16_AT = {J.Q4_0: (18, [0]), J.Q8_0: (34, [0]), J.Q4_K: (144, [0, 2]), J.Q6_K: (210, [208])}


def _blocks(qtype, source: str) -> np.ndarray:
    rng = np.random.default_rng(int(qtype))
    if source == "quantized":
        w = (rng.standard_normal(SHAPE) * 0.05).astype(np.float32)
        return quantize(w, qtype)
    size, offs = _F16_AT[qtype]
    raw = rng.integers(0, 256, SHAPE[0] * SHAPE[1] // (32 if size in (18, 34) else 256) * size,
                       dtype=np.uint8).reshape(-1, size)
    for o in offs:
        raw[:, o + 1] &= 0xBF  # exponent below all-ones: finite f16
    raw[::7, offs[0]:offs[0] + 2] = [0, 0x80]  # -0.0
    raw[1::7, offs[0] + 1] &= 0x83  # subnormal or tiny
    return raw.reshape(-1)


def _port(fn, data, qtype):
    return fn(torch.from_numpy(data.copy()), int(qtype), SHAPE)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("source", ["quantized", "random"])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_repack_bit_equal(qtype, source, native):
    data = _blocks(qtype, source)
    want = repack_numpy(data, qtype, SHAPE, use_native=native)
    got = _port(repack, data, qtype)
    assert got[3] == want[3]
    for i, what in enumerate(("q", "scale", "bias")):
        if want[i] is None:
            assert got[i] is None
        else:
            assert_bits_equal(got[i], want[i], what)


@pytest.mark.parametrize("source", ["quantized", "random"])
@pytest.mark.parametrize("qtype", [J.Q4_K, J.Q6_K], ids=lambda t: t.name)
def test_repack_coded_bit_equal(qtype, source):
    data = _blocks(qtype, source)
    want = repack_coded_numpy(data, qtype, SHAPE)
    got = _port(repack_coded, data, qtype)
    assert got[3] == want[3]
    for i, what in ((0, "q"), (1, "codes"), (2, "min codes"), (4, "sup"), (5, "sup_min")):
        if want[i] is None:
            assert got[i] is None
        else:
            assert_bits_equal(got[i], want[i], what)


@pytest.fixture(scope="module")
def one_tensor_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("repack")
    files = {}
    for qtype in TYPES:
        path = d / f"{qtype.name}.gguf"
        w = JWriter(path)
        w.add_tensor("blk.0.attn_q.weight",
                     (np.random.default_rng(3).standard_normal(SHAPE) * 0.05).astype(np.float32),
                     ggml_type=qtype)
        w.write()
        files[qtype] = path
    return files


def _qt_fields(qt):
    return {k: getattr(qt, k) for k in ("q", "scale", "bias", "sup", "sup_min")}


def _same_qtensor(got, want):
    assert (got.group, got.layout, got.packed, got.ggml_type) == (
        want.group, want.layout, want.packed, int(want.ggml_type))
    for k, v in _qt_fields(want).items():
        g = getattr(got, k)
        if v is None:
            assert g is None, k
        else:
            assert_bits_equal(g, v, k)


@pytest.mark.parametrize("coded", ["1", "0"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("perm", [False, True], ids=["no_perm", "row_perm"])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_load_tensor_bit_equal(one_tensor_files, monkeypatch, qtype, perm, layout, coded):
    monkeypatch.setenv("EAGLE_TPU_CODED_LOAD", coded)
    monkeypatch.setattr(jloader, "_CODED_LOAD", coded == "1")
    path = one_tensor_files[qtype]
    row_perm = loader.unpermute_rows(SHAPE[0], 4) if perm else None
    np.testing.assert_array_equal(row_perm if perm else 0,
                                  jloader.unpermute_rows(SHAPE[0], 4) if perm else 0)
    want = jloader._load_tensor(JReader(path), "blk.0.attn_q.weight", row_perm=row_perm,
                                layout=layout)
    got = loader.load_tensor(GGUFReader(path), "blk.0.attn_q.weight", row_perm=row_perm,
                             layout=layout, device="cpu")
    _same_qtensor(got, want)


@pytest.mark.parametrize("scale_mode", ["f32", "bf16"])
@pytest.mark.parametrize("coded", ["1", "0"])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_prepare_qtensor_bit_equal(one_tensor_files, monkeypatch, qtype, coded, scale_mode):
    monkeypatch.setenv("EAGLE_TPU_CODED_LOAD", coded)
    monkeypatch.setattr(jloader, "_CODED_LOAD", coded == "1")
    path = one_tensor_files[qtype]
    want = jloader._load_tensor(JReader(path), "blk.0.attn_q.weight", layout="kn")
    want = dataclasses.replace(want, q=np.stack([want.q, want.q]))  # a 2-layer stack
    got = loader.load_tensor(GGUFReader(path), "blk.0.attn_q.weight", layout="kn",
                             device="cpu")
    got = dataclasses.replace(got, q=torch.stack([got.q, got.q]))
    want, got = jprepare(want, scale_mode), prepare_qtensor(got, scale_mode)
    assert got.packed == (qtype in (J.Q4_0, J.Q4_K))
    _same_qtensor(got, want)
