"""The port's repack of the formats beyond Q4_0, Q8_0, Q4_K and Q6_K
(eagle_tpu_torch/quant/qtensor.py and quant/iq_blocks.py) against the
reference's, bit for bit: Q4_1, Q5_0, Q5_1, Q8_1, Q2_K, Q3_K, Q5_K (and its
coded form), IQ4_NL, IQ4_XS and the codebook formats IQ2_XXS, IQ2_XS, IQ2_S,
IQ3_XXS, IQ3_S, IQ1_S and IQ1_M.

Inputs are the same GGUF block bytes: the reference's encoders' blocks
(`quant/blocks.py:quantize`) for the affine formats, and random blocks with
finite f16 scales for every format (the codebook formats have no encoder).
Each port repacker runs as torch ops on the CPU and must equal
`repack_numpy(..., use_native=False)`, the native repack where the
reference has one (Q5_K), and `repack_coded_numpy` for coded Q5_K. The
loader's per-tensor path and serving prep must give the reference's arrays
(Q4_1 nibble-packs, as the reference's `PACKABLE_TYPES` says). No
tolerance: a repack is exact."""

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
from eagle_tpu_torch.gguf.constants import GGML_TYPE_TRAITS
from eagle_tpu_torch.models import loader
from eagle_tpu_torch.quant.qtensor import CODED_TYPES, REPACKABLE_TYPES, repack, repack_coded
from eagle_tpu_torch.quant.serving import PACKABLE_TYPES, prepare_qtensor
from torch_port_util import assert_bits_equal, has_encoder, random_blocks

AFFINE = [J.Q4_1, J.Q5_0, J.Q5_1, J.Q8_1, J.Q2_K, J.Q3_K, J.Q5_K, J.IQ4_NL, J.IQ4_XS]
CODEBOOK = [J.IQ2_XXS, J.IQ2_XS, J.IQ2_S, J.IQ3_XXS, J.IQ3_S, J.IQ1_S, J.IQ1_M]
NEW = AFFINE + CODEBOOK
SHAPE = (64, 512)
GROUPS = {J.Q2_K: 16, J.Q3_K: 16, J.IQ2_XS: 16, J.IQ2_S: 16, J.IQ1_M: 8}


def _blocks(qtype, source: str) -> np.ndarray:
    rng = np.random.default_rng(int(qtype))
    if source == "quantized":
        return quantize((rng.standard_normal(SHAPE) * 0.05).astype(np.float32), qtype)
    return random_blocks(rng, qtype, *SHAPE)


def _same(got, want):
    for i, what in enumerate(("q", "scale", "bias", "group", "sup", "sup_min")[:len(want)]):
        if what == "group":
            assert got[i] == want[i]
        elif want[i] is None:
            assert got[i] is None, what
        else:
            assert_bits_equal(got[i], want[i], what)


def test_tables_cover_the_new_formats():
    for t in NEW:
        assert int(t) in [int(x) for x in REPACKABLE_TYPES], t.name
        tr = GGML_TYPE_TRAITS[int(t)]
        from eagle_tpu.gguf.constants import GGML_TYPE_TRAITS as JT

        assert (tr.block_size, tr.type_size) == (JT[t].block_size, JT[t].type_size), t.name
    assert [int(t) for t in CODED_TYPES] == [int(J.Q4_K), int(J.Q5_K), int(J.Q6_K)]
    assert [int(t) for t in PACKABLE_TYPES] == [int(J.Q4_0), int(J.Q4_1), int(J.Q4_K)]


CASES = [(t, s) for t in NEW for s in ("quantized", "random") if s == "random" or has_encoder(t)]


@pytest.mark.parametrize("qtype,source", CASES, ids=lambda v: getattr(v, "name", v))
def test_repack_bit_equal(qtype, source):
    data = _blocks(qtype, source)
    want = repack_numpy(data, qtype, SHAPE, use_native=False)
    got = repack(torch.from_numpy(data.copy()), int(qtype), SHAPE)
    assert got[3] == GROUPS.get(qtype, 32)
    _same(got, want)


@pytest.mark.parametrize("source", ["quantized", "random"])
def test_q5_k_native_and_coded_bit_equal(source):
    data = _blocks(J.Q5_K, source)
    got = repack(torch.from_numpy(data.copy()), int(J.Q5_K), SHAPE)
    _same(got, repack_numpy(data, J.Q5_K, SHAPE, use_native=True))
    got = repack_coded(torch.from_numpy(data.copy()), int(J.Q5_K), SHAPE)
    _same(got, repack_coded_numpy(data, J.Q5_K, SHAPE))


@pytest.fixture(scope="module")
def new_format_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("formats") / "formats.gguf"
    w = JWriter(path)
    for qtype in NEW:
        w.add_tensor(qtype.name, _blocks(qtype, "random"), ggml_type=qtype, raw_shape=SHAPE)
    w.write()
    return path


@pytest.mark.parametrize("coded", ["1", "0"])
@pytest.mark.parametrize("qtype", NEW, ids=lambda t: t.name)
def test_load_and_serve_bit_equal(new_format_file, monkeypatch, qtype, coded):
    """load_tensor ("kn", with the q/k row permutation) and prepare_qtensor
    against the reference's `_load_tensor` and `prepare_qtensor`."""
    monkeypatch.setenv("EAGLE_TPU_CODED_LOAD", coded)
    monkeypatch.setattr(jloader, "_CODED_LOAD", coded == "1")
    perm = loader.unpermute_rows(SHAPE[0], 4)
    want = jloader._load_tensor(JReader(new_format_file), qtype.name, row_perm=perm, layout="kn")
    got = loader.load_tensor(GGUFReader(new_format_file), qtype.name, row_perm=perm,
                             layout="kn", device="cpu")
    assert got.coded == (coded == "1" and qtype == J.Q5_K)
    for prepared in (False, True):
        if prepared:
            want, got = jprepare(want), prepare_qtensor(got)
            assert got.packed == (qtype == J.Q4_1)
        assert (got.group, got.layout, got.packed, got.ggml_type) == (
            want.group, want.layout, want.packed, int(want.ggml_type))
        for k in ("q", "scale", "bias", "sup", "sup_min"):
            w = getattr(want, k)
            if w is None:
                assert getattr(got, k) is None, k
            else:
                assert_bits_equal(getattr(got, k), np.asarray(w), k)


def test_q4_1_kn_weight_comes_out_packed(new_format_file):
    """A loaded Q4_1 "kn" weight nibble-packs at serving prep, as in the
    reference (whose PACKABLE_TYPES holds Q4_1)."""
    got = prepare_qtensor(loader.load_tensor(GGUFReader(new_format_file), "Q4_1", layout="kn",
                                             device="cpu"))
    assert got.packed and tuple(got.q.shape) == (SHAPE[1] // 2, SHAPE[0])
    want = jprepare(jloader._load_tensor(JReader(new_format_file), "Q4_1", layout="kn"))
    assert want.packed
    assert_bits_equal(got.q, np.asarray(want.q), "q")
