"""The port's GGUF reader and writer (eagle_tpu_torch/gguf) against the
reference's (eagle_tpu/gguf).

One file, written by the reference's writer, holds metadata of every value
type and one tensor of each format the port reads (F32, F16, Q4_0, Q8_0,
Q4_K, Q6_K). The port's reader must give the same metadata, tensor infos
and byte-identical payloads, and the same f32 values for the dense
tensors. A file written by the port's writer (the same metadata, the packed
payloads as raw bytes, the dense arrays as arrays) must read back through
the reference's reader, and be byte-identical to the reference writer's
file. Exact comparisons throughout: a container carries bytes."""

import numpy as np
import pytest

from eagle_tpu.gguf.constants import GGMLType as JGGMLType
from eagle_tpu.gguf.reader import GGUFReader as JReader
from eagle_tpu.gguf.writer import GGUFWriter as JWriter
from eagle_tpu_torch.gguf import GGMLType, GGUFReader, GGUFWriter

METADATA = {
    "general.architecture": "llama",
    "general.name": "tiny ü",
    "llama.block_count": 2,
    "llama.attention.layer_norm_rms_epsilon": 1e-6,
    "llama.use_parallel_residual": False,
    "llama.big": 2**40,
    "tokenizer.ggml.tokens": ["<unk>", "<s>", "a"],
    "tokenizer.ggml.scores": np.asarray([0.0, -1.5, 2.0], np.float32),
    "tokenizer.ggml.token_type": np.asarray([2, 3, 1], np.int32),
    "some.signed": [3, -1, 7],
}

# name -> (ggml type, shape)
TENSORS = {
    "dense_f32": (JGGMLType.F32, (3, 64)),
    "dense_f16": (JGGMLType.F16, (64,)),
    "w_q4_0": (JGGMLType.Q4_0, (8, 64)),
    "w_q8_0": (JGGMLType.Q8_0, (4, 96)),
    "w_q4_k": (JGGMLType.Q4_K, (4, 512)),
    "w_q6_k": (JGGMLType.Q6_K, (2, 256)),
}


def _arrays(rng):
    out = {}
    for name, (qtype, shape) in TENSORS.items():
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        out[name] = a.astype(np.float16) if qtype == JGGMLType.F16 else a
    return out


@pytest.fixture(scope="module")
def ref_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("gguf") / "ref.gguf"
    w = JWriter(path)
    for k, v in METADATA.items():
        w.add(k, v)
    for name, a in _arrays(np.random.default_rng(0)).items():
        qtype = TENSORS[name][0]
        w.add_tensor(name, a, ggml_type=None if qtype in (JGGMLType.F32, JGGMLType.F16) else qtype)
    w.write()
    return path


def _same_metadata(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), k


def test_ggml_type_values_match_reference():
    for t in GGMLType:
        assert int(JGGMLType[t.name]) == int(t)


def test_reader_matches_reference(ref_file):
    ref, port = JReader(ref_file), GGUFReader(ref_file)
    assert port.version == ref.version and port.data_offset == ref.data_offset
    _same_metadata(port.metadata, ref.metadata)
    assert list(port.tensors) == list(ref.tensors)
    for name, info in ref.tensors.items():
        p = port.tensors[name]
        assert (int(p.ggml_type), p.shape, p.offset, p.nbytes) == (
            int(info.ggml_type), info.shape, info.offset, info.nbytes)
        np.testing.assert_array_equal(port.tensor_bytes(name), ref.tensor_bytes(name))
        # F32 and F16 as they are, the block formats decoded: bit for bit
        want = ref.tensor_f32(name)
        got = port.tensor_f32(name)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    port.close()
    ref.close()


def test_port_writer_reads_back_in_reference(ref_file, tmp_path):
    ref = JReader(ref_file)
    path = tmp_path / "port.gguf"
    w = GGUFWriter(path)
    for k, v in METADATA.items():
        w.add(k, v)
    for name, info in ref.tensors.items():
        if info.ggml_type == JGGMLType.F32:
            w.add_tensor(name, ref.tensor_f32(name))
        elif info.ggml_type == JGGMLType.F16:
            w.add_tensor(name, ref.tensor_f32(name).astype(np.float16))
        else:
            w.add_tensor(name, np.array(ref.tensor_bytes(name)), GGMLType(int(info.ggml_type)),
                         raw_shape=info.shape)
    w.write()
    back = JReader(path)
    _same_metadata(back.metadata, ref.metadata)
    for name, info in ref.tensors.items():
        assert back.tensors[name].shape == info.shape
        np.testing.assert_array_equal(back.tensor_bytes(name), ref.tensor_bytes(name))
    assert path.read_bytes() == ref_file.read_bytes()


def test_writer_refuses_what_it_cannot_encode(tmp_path):
    w = GGUFWriter(tmp_path / "x.gguf")
    with pytest.raises(NotImplementedError, match="no quantizer"):
        w.add_tensor("w", np.zeros((2, 32), np.float32), GGMLType.Q4_0)
    with pytest.raises(ValueError, match="payload"):
        w.add_tensor("w", np.zeros(17, np.uint8), GGMLType.Q4_0, raw_shape=(32,))


def test_reader_refuses_unported_types(tmp_path):
    path = tmp_path / "q8k.gguf"  # Q8_K: ggml's activation format, no weight repack
    w = JWriter(path)
    w.add_tensor("w", np.zeros((2, 256), np.float32), ggml_type=JGGMLType.Q8_K)
    w.write()
    with pytest.raises(ValueError, match="not ported"):
        GGUFReader(path)
