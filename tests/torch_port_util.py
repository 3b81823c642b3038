"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
carry JAX-side arrays and params across as numpy, and the tiny model config
those tests use.

Importing this module sets PyTorch to one intra-op thread: the suite runs
in parallel pytest workers, and one thread per core in each worker
oversubscribes the host and slows the timing tests of other files, while
the tiny shapes here gain nothing from more threads."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from eagle_tpu.quant.qtensor import QTensor as JaxQTensor

torch.set_num_threads(1)


def qtensor_to_numpy(qt: JaxQTensor) -> dict:
    """A JAX QTensor as the dict `eagle_tpu_torch.convert` takes."""
    d = {k: None if getattr(qt, k) is None else np.asarray(getattr(qt, k))
         for k in ("q", "scale", "bias", "sup", "sup_min")}
    d.update(group=qt.group, layout=qt.layout, packed=qt.packed, ggml_type=qt.ggml_type)
    return d


def tree_to_numpy(tree):
    """A JAX param tree with every leaf as numpy (QTensors as dicts)."""
    if isinstance(tree, JaxQTensor):
        return qtensor_to_numpy(tree)
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if tree is None:
        return None
    return np.asarray(tree)


def tiny_cfgs():
    """(JAX ModelConfig, port ModelConfig) of the tiny llama: 2 layers,
    n_embd 256, 4 heads, 2 kv heads, head_dim 64, n_ff 512, vocab 512."""
    from eagle_tpu.models.config import ModelConfig as JaxCfg
    from eagle_tpu_torch.models.config import ModelConfig as TorchCfg

    fields = dict(arch="llama", vocab_size=512, n_embd=256, n_layers=2, n_heads=4,
                  n_kv_heads=2, head_dim=64, n_ff=512, rms_eps=1e-6, rope_base=10000.0,
                  rope_dim=64, n_ctx_train=2048)
    return JaxCfg(**fields), TorchCfg(**fields)


def jax_cfg_to_torch(cfg):
    from eagle_tpu_torch.models.config import ModelConfig as TorchCfg

    names = {f.name for f in dataclasses.fields(TorchCfg)}
    return TorchCfg(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})


def random_blocks(rng, qtype, n: int, k: int, d_mag: float = 2e-3) -> np.ndarray:
    """Random block bytes of an [n, k] tensor of `qtype` (a reference
    GGMLType) whose f16 fields are finite, in [0.5, 1.5) x d_mag with a
    random sign; IQ1_M's scale nibbles likewise. Every code and sub-scale
    pattern occurs."""
    from eagle_tpu.gguf.constants import GGML_TYPE_TRAITS, GGMLType
    from eagle_tpu_torch.gguf.constants import F16_FIELDS

    tr = GGML_TYPE_TRAITS[qtype]
    nb = n * k // tr.block_size
    raw = rng.integers(0, 256, (nb, tr.type_size), dtype=np.uint8)

    def scales():
        d = rng.uniform(0.5, 1.5, nb) * d_mag * rng.choice([-1.0, 1.0], nb)
        return d.astype(np.float16).view(np.uint8).reshape(nb, 2)

    for at in F16_FIELDS[int(qtype)]:
        raw[:, at:at + 2] = scales()
    if qtype == GGMLType.IQ1_M:
        bits = scales().view("<u2")[:, 0].astype(np.int32)
        for word in range(4):  # nibble `word` of d: the top nibble of scale word `word`
            hi = 48 + 2 * word + 1
            raw[:, hi] = (raw[:, hi] & 0x0F) | (((bits >> (4 * word)) & 0xF) << 4)
    return raw.reshape(-1)


def has_encoder(qtype) -> bool:
    """Whether the reference's writer can quantize float weights to `qtype`
    (the codebook formats have no encoder)."""
    from eagle_tpu.quant.blocks import SUPPORTED_QUANT_TYPES

    return qtype in SUPPORTED_QUANT_TYPES


def write_tiny_gguf_pair(tmp_path, layer_type, out_type, emb_type, draft_type, seed=0):
    """A tiny llama target GGUF and EAGLE draft GGUF (the tiny_cfgs shapes),
    minted with the reference's GGUFWriter, which quantizes float weights:
    layer matmul weights in `layer_type`, output in `out_type`, token_embd in
    `emb_type`, the draft's matmul weights and embedding in `draft_type`;
    norms and fc.bias F32. A format without an encoder (the codebook ones)
    gets `random_blocks`. Returns (target path, draft path)."""
    from eagle_tpu.gguf.writer import GGUFWriter
    from eagle_tpu.tools.train_draft import _base_metadata

    jcfg, _ = tiny_cfgs()
    rng = np.random.default_rng(seed)
    d, f, v = jcfg.n_embd, jcfg.n_ff, jcfg.vocab_size
    nq, nkv = jcfg.n_heads * jcfg.head_dim, jcfg.n_kv_heads * jcfg.head_dim

    def qmat(w, name, n, k, qtype, scale=0.05):
        if has_encoder(qtype):
            w.add_tensor(name, (rng.standard_normal((n, k)) * scale).astype(np.float32),
                         ggml_type=qtype)
        else:
            w.add_tensor(name, random_blocks(rng, qtype, n, k), ggml_type=qtype,
                         raw_shape=(n, k))

    def norm():
        return rng.uniform(0.8, 1.2, d).astype(np.float32)

    def layer(w, i, qtype, attn_norm=True):
        if attn_norm:
            w.add_tensor(f"blk.{i}.attn_norm.weight", norm())
        for name, (n, k) in (("attn_q", (nq, d)), ("attn_k", (nkv, d)), ("attn_v", (nkv, d)),
                             ("attn_output", (d, nq)), ("ffn_gate", (f, d)), ("ffn_up", (f, d)),
                             ("ffn_down", (d, f))):
            qmat(w, f"blk.{i}.{name}.weight", n, k, qtype)
        w.add_tensor(f"blk.{i}.ffn_norm.weight", norm())

    target = tmp_path / "target.gguf"
    w = GGUFWriter(target)
    for k, val in _base_metadata(jcfg, "llama").items():
        w.add(k, val)
    qmat(w, "token_embd.weight", v, d, emb_type, 0.5)
    for i in range(jcfg.n_layers):
        layer(w, i, layer_type)
    w.add_tensor("output_norm.weight", norm())
    qmat(w, "output.weight", v, d, out_type)
    w.write()

    draft = tmp_path / "draft.gguf"
    w = GGUFWriter(draft)
    for k, val in _base_metadata(dataclasses.replace(jcfg, n_layers=1), "eagle").items():
        w.add(k, val)
    qmat(w, "token_embd.weight", v, d, draft_type, 0.5)
    qmat(w, "fc.weight", d, 2 * d, draft_type)
    w.add_tensor("fc.bias", (rng.standard_normal(d) * 0.01).astype(np.float32))
    layer(w, 0, draft_type, attn_norm=False)
    w.write()
    return target, draft


def assert_bits_equal(got, want, what=""):
    """A port tensor and a reference array hold the same bits (floats are
    compared as integers, so -0.0 and NaN payloads count)."""
    got = got.detach().cpu()
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape), want.shape)
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    else:
        got = got.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if got.dtype.kind == "f":
        got, want = got.view(f"i{got.itemsize}"), want.view(f"i{want.itemsize}")
    np.testing.assert_array_equal(got, want, err_msg=what)
