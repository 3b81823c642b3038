"""GGUF -> params on the device (port of eagle_tpu/models/loader.py:
`unpermute_rows`, `_load_tensor`, `_stack`, `fuse_layer_weights`, the
branches of `load_llama_params` for the architectures of `TARGET_ARCHS`,
and `load_eagle_params`).

Each tensor's raw block bytes are copied from the file's map into a pinned
staging buffer ("read"), uploaded ("upload") and repacked on the device
("repack", quant/qtensor.py), so the host never holds the file twice and
never sees a float weight. Matmul weights are stored "kn" (K-major, the qmm
layout), stacked over layers, with q/k and gate/up fused along N. The q/k
rows of llama-family GGUFs carry convert_hf_to_gguf's adjacent-pair rope
permutation; it is inverted along N at load, so the runtime's rope is
half-split. Qwen2, Qwen3, Gemma and Gemma-2 rows (NEOX rope) are half-split
in the file already and load as they are (`PERMUTED_ROPE_ARCHS`). A Gemma
file's norm weights load as they are: the converter folds Gemma's (1 + w)
into them (eagle_tpu/models/hf_convert.py).

Coded load (`EAGLE_TPU_CODED_LOAD`, default on; "0" or "false" turns it
off, read at each load): k-quant matmul weights keep int8 sub-scale codes
and f32 per-256 super-scales instead of materialized f32 products.

A Llama-3.1 file's `rope_freqs.weight` loads as `params["rope_factors"]`
(f32); a file without `output.weight` (tied embeddings: Llama-3.2-1B / 3B,
Gemma, Gemma-2) takes `token_embd` as its head, which stays "nk".

The optional layer tensors of these families load as the reference's do:
q/k/v biases (qwen2, starcoder2, stablelm, phi2) or a pre-fused
`attn_qkv.bias` (gptneox) into a layer-stacked f32 `bqkv` [L, (H + 2 H_kv)
Dh], per-head q/k norms (qwen3), the sandwich norms (gemma2), the norm
biases (`attn_norm_b`, `ffn_norm_b`), the attention output bias `bo` and
the FFN biases `b_up` / `b_down` (the LayerNorm families) as f32 stacks. A
pre-fused `attn_qkv.weight` (gptneox) loads as `wqkv`, its q/k rows
un-permuted where the arch is permuted; a file without `ffn_gate` keeps
`w_up` alone (the no-gate MLP), and one without `ffn_norm` (phi2,
command-r: one shared input norm) has no `ffn_norm`. `output_norm.bias` and
`output.bias` load as `output_norm_b` and `output_b`; a file without
`output_norm.weight` (olmo: non-parametric norms, no norm tensor at all)
has no `output_norm`. A Falcon-40B / 180B file's `attn_norm_2` (its FFN's
own norm) is refused: the reference never reads it. The position
families' tensors load as the reference's (loader.py:831-843): GPT-2's and
StarCoder's learned positions `position_embd.weight` as `pos_embd` (f32 [n_pos,
D]), BLOOM's embedding LayerNorm `token_embd_norm.weight` / `.bias` as
`tok_embd_norm(_b)`, and JAIS's gate bias `ffn_gate.bias`, fused with
`ffn_up.bias` into `b_gate_up` as `w_gate_up` fuses their weights
(loader.py:160-164); a quantized `position_embd` is read densely, as the
reference dequantizes it (loader.py:839-841).

A mixture-of-experts file (`blk.0.ffn_gate_inp.weight` present: Mixtral as
`llama` or `mixtral`, Qwen2-MoE) loads the reference's MoE tensors
(loader.py:731-747) in place of the dense FFN: the router `ffn_gate_inp`
[L, E, D], the experts `w_gate_exps` / `w_up_exps` [L, E, F, D] and
`w_down_exps` [L, E, D, F], and Qwen2-MoE's shared expert `w_gate_shexp` /
`w_up_shexp` [L, F_sh, D], `w_down_shexp` [L, D, F_sh] with its gate
`ffn_gate_inp_shexp` [L, 1, D]. They are read densely: their raw blocks
are uploaded and decoded on the device (`quant/qtensor.py:dequantize`,
bit for bit the reference's f32 values) into layer-stacked tensors of
`dense_dtype`, the caller's compute dtype (`Engine` passes its
`compute_dtype`: bf16 on the card; the tests f32), which is the value the
reference's einsums read after their `.astype(compute_dtype)`, so no
product casts a weight per call. Arctic's `ffn_norm_exps` is refused.

Anything else (MLA, flat q/k norms, per-layer head counts, recurrent
layers, ...) raises NotImplementedError, as does an EAGLE draft with biases
(the reference's `load_eagle_params` drops them)."""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader
from ..quant.qtensor import (CODED_TYPES, REPACKABLE_TYPES, QTensor, concat_qtensors, dequantize,
                             repack, repack_coded)
from .config import PERMUTED_ROPE_ARCHS, TARGET_ARCHS, ModelConfig

#: our name -> GGUF tensor suffix (src/llama-arch.cpp's names)
LAYER_KEY_MAP = {
    "attn_norm": "attn_norm.weight",
    "wq": "attn_q.weight",
    "wk": "attn_k.weight",
    "wv": "attn_v.weight",
    "wo": "attn_output.weight",
    "ffn_norm": "ffn_norm.weight",
    "w_gate": "ffn_gate.weight",
    "w_up": "ffn_up.weight",
    "w_down": "ffn_down.weight",
}
#: our name -> GGUF suffix of the layer tensors a file may carry: the
#: reference's optional tensors of the ported families (loader.py:697-703)
OPTIONAL_NORMS = {
    "attn_q_norm": "attn_q_norm.weight",
    "attn_k_norm": "attn_k_norm.weight",
    "post_attn_norm": "attn_post_norm.weight",
    "post_ffn_norm": "ffn_post_norm.weight",
}
#: our name -> GGUF suffix of the LayerNorm families' biases (loader.py:720-726)
OPTIONAL_BIASES = {
    "attn_norm_b": "attn_norm.bias",
    "ffn_norm_b": "ffn_norm.bias",
    "bo": "attn_output.bias",
    "b_up": "ffn_up.bias",
    "b_down": "ffn_down.bias",
    "b_gate": "ffn_gate.bias",  # jais: fused with b_up into b_gate_up
}
BIASES = ("attn_q.bias", "attn_k.bias", "attn_v.bias")  # fused into `bqkv`
FUSED_QKV = ("attn_qkv.weight", "attn_qkv.bias")  # gptneox's pre-fused projection
_TOP_TENSORS = {"token_embd.weight", "output_norm.weight", "output_norm.bias", "output.weight",
                "output.bias", "rope_freqs.weight", "position_embd.weight",
                "token_embd_norm.weight", "token_embd_norm.bias"}
_EAGLE_TOP_TENSORS = {"token_embd.weight", "fc.weight", "fc.bias"}
_DENSE_TYPES = (GGMLType.F32, GGMLType.F16)
#: our name -> GGUF suffix of the MoE layer tensors, read densely (the
#: reference's loader.py:736-747 less arctic's ffn_norm_exps); the first
#: four are every MoE layer's, the shared expert's are optional
MOE_KEY_MAP = {
    "ffn_gate_inp": "ffn_gate_inp.weight",
    "w_gate_exps": "ffn_gate_exps.weight",
    "w_up_exps": "ffn_up_exps.weight",
    "w_down_exps": "ffn_down_exps.weight",
    "ffn_gate_inp_shexp": "ffn_gate_inp_shexp.weight",
    "w_gate_shexp": "ffn_gate_shexp.weight",
    "w_up_shexp": "ffn_up_shexp.weight",
    "w_down_shexp": "ffn_down_shexp.weight",
}


def coded_load() -> bool:
    return os.environ.get("EAGLE_TPU_CODED_LOAD", "1") not in ("0", "false")


def unpermute_rows(n_rows: int, n_heads: int, rope_dim: int | None = None) -> np.ndarray:
    """Row index map inverting convert_hf_to_gguf's LlamaModel.permute (GGUF
    row 2j+m = HF row m*d/2 + j within each head): HF row i = GGUF row
    inv[i]. `rope_dim` < rows per head restricts the map to the first
    rope_dim rows of each head."""
    head_rows = n_rows // n_heads
    rd = head_rows if rope_dim is None or rope_dim <= 0 else min(rope_dim, head_rows)
    within = np.arange(head_rows)
    within[:rd] = np.arange(rd).reshape(rd // 2, 2).T.reshape(-1)
    return (np.arange(n_heads)[:, None] * head_rows + within[None, :]).reshape(-1)


class _Loader:
    """One file's reads onto one device, with the time of each phase added
    to `times` ("read", "upload", "repack", "dequantize" seconds) when it
    is given."""

    def __init__(self, reader: GGUFReader, device: torch.device, times: dict | None):
        self.reader, self.dev, self.times = reader, device, times
        self._stage: torch.Tensor | None = None

    @contextlib.contextmanager
    def phase(self, key: str):
        if self.times is None:
            yield
            return
        t0 = time.perf_counter()
        yield
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.times[key] = self.times.get(key, 0.0) + time.perf_counter() - t0

    def raw(self, name: str) -> torch.Tensor:
        """A tensor's block bytes as a uint8 tensor on the device."""
        arr = self.reader.tensor_bytes(name)
        if self.dev.type == "cpu":
            return torch.from_numpy(arr)  # a view of the map; the repack copies
        n = arr.nbytes
        if self._stage is None or self._stage.numel() < n:
            self._stage = None
            self._stage = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        stage = self._stage[:n]
        with self.phase("read"):
            np.copyto(stage.numpy(), arr)
        with self.phase("upload"):
            out = stage.to(self.dev, non_blocking=True)
            # the staging buffer is reused by the next tensor
            torch.cuda.current_stream(self.dev).synchronize()
        return out

    def dense(self, names: list[str], dtype) -> torch.Tensor:
        """Tensors of one shape (a weight of each layer), stacked along a
        new leading axis as `dtype`: each one's raw blocks uploaded and
        decoded on the device into its slot of the stack."""
        infos = [self.reader.tensors[n] for n in names]
        shape = infos[0].shape
        if any(i.shape != shape for i in infos):
            raise NotImplementedError(f"{names[0]}: layers of different shapes do not stack")
        out = torch.empty((len(names), *shape), dtype=dtype, device=self.dev)
        for i, (name, info) in enumerate(zip(names, infos)):
            raw = self.raw(name)
            with self.phase("dequantize"):
                dequantize(raw, info.ggml_type, shape, out=out[i])
        return out

    def tensor(self, name: str, row_perm: np.ndarray | None = None,
               layout: str = "nk") -> QTensor | torch.Tensor:
        """One tensor: a QTensor for the block formats, f32 for F32/F16.
        The row permutation (logical N axis) comes before the transpose to
        "kn"."""
        info = self.reader.tensors[name]
        perm = None if row_perm is None else torch.from_numpy(row_perm).to(self.dev)
        if info.ggml_type in _DENSE_TYPES:
            w = self.dense([name], torch.float32)[0]
            return w if perm is None else w.index_select(0, perm)
        if info.ggml_type not in REPACKABLE_TYPES or len(info.shape) != 2:
            raise NotImplementedError(
                f"{name}: {info.ggml_type.name} tensor of shape {info.shape} is not ported yet")
        raw = self.raw(name)
        with self.phase("repack"):
            if (layout == "kn" and info.ggml_type in CODED_TYPES and info.shape[-1] % 256 == 0
                    and coded_load()):
                q, sc, mc, group, sup, sup_min = repack_coded(raw, info.ggml_type, info.shape)
                fields = dict(q=q, scale=sc, bias=mc, sup=sup, sup_min=sup_min)
            else:
                q, scale, bias, group = repack(raw, info.ggml_type, info.shape)
                fields = dict(q=q, scale=scale, bias=bias)
            if perm is not None:
                fields = {k: v if v is None else v.index_select(0, perm)
                          for k, v in fields.items()}
            fields = {k: v if v is None else (v.T if layout == "kn" else v).contiguous()
                      for k, v in fields.items()}
        return QTensor(**fields, group=group, ggml_type=int(info.ggml_type), layout=layout)


def load_tensor(reader: GGUFReader, name: str, row_perm: np.ndarray | None = None,
                layout: str = "nk", device="cuda") -> QTensor | torch.Tensor:
    """One tensor of an open file, repacked on `device` as the loaders do
    it (counterpart of the reference's `_load_tensor`)."""
    return _Loader(reader, resolve_device(device), None).tensor(name, row_perm, layout)


def _stack(items: list) -> QTensor | torch.Tensor:
    """Stack per-layer tensors along a new leading layer axis. Layers of
    different formats (a Q4_K_M file's Q4_K and Q6_K `w_down`) do not stack,
    as in the reference, whose np.stack refuses them."""
    first = items[0]
    if not isinstance(first, QTensor):
        return torch.stack(items)
    for t in items:
        if (t.ggml_type, t.group, t.layout, t.coded, t.bias is None) != (
                first.ggml_type, first.group, first.layout, first.coded, first.bias is None):
            raise NotImplementedError(
                f"layers of ggml types {GGMLType(first.ggml_type).name} and "
                f"{GGMLType(t.ggml_type).name} do not stack (mixed-format files are not "
                "ported yet)")
    return QTensor(
        **{k: None if v is None else torch.stack([getattr(t, k) for t in items])
           for k, v in first.tensors().items()},
        group=first.group, ggml_type=first.ggml_type, layout=first.layout,
    )


def fuse_layer_weights(stacked: dict[str, Any]) -> dict[str, Any]:
    """Fuse q/k/v into `wqkv` and gate/up into `w_gate_up` along N, and a
    gate bias with the up bias into `b_gate_up` (jais)."""
    out = dict(stacked)
    if "wq" in out:
        out["wqkv"] = concat_qtensors([out.pop("wq"), out.pop("wk"), out.pop("wv")])
    if "w_gate" in out:
        out["w_gate_up"] = concat_qtensors([out.pop("w_gate"), out.pop("w_up")])
        if "b_gate" in out:
            out["b_gate_up"] = torch.cat([out.pop("b_gate"), out.pop("b_up")], dim=-1)
    return out


def _check_names(reader: GGUFReader, top: set[str], layer_suffixes, n_layers: int) -> None:
    known = set(top) | {f"blk.{i}.{s}" for i in range(n_layers) for s in layer_suffixes}
    extra = sorted(set(reader.tensors) - known)
    if extra:
        raise NotImplementedError(f"tensors not ported yet: {extra[:8]}")


def load_llama_params(path: str | Path, device="cuda", times: dict | None = None,
                      dense_dtype=torch.bfloat16) -> tuple[dict[str, Any], ModelConfig, dict]:
    """Load a GGUF of `TARGET_ARCHS`. Returns (params, config, metadata);
    every weight lies on `device`. `times`, when given, gathers the seconds
    spent reading, uploading, repacking and decoding. A MoE file's dense
    expert, shared-expert and router weights are stored as `dense_dtype`
    (the compute dtype of the engine that runs them)."""
    dev = resolve_device(device)
    reader = GGUFReader(path)
    cfg = ModelConfig.from_gguf_metadata(reader.metadata)
    if cfg.arch not in TARGET_ARCHS:
        raise NotImplementedError(f"load_llama_params reads {TARGET_ARCHS} files, not "
                                  f"{cfg.arch!r}")
    if "blk.0.attn_norm_2.weight" in reader.tensors:
        # Falcon-40B / 180B's FFN norm (new_decoder_architecture): the
        # reference never reads it, and its FFN would share the attention's
        raise NotImplementedError("attn_norm_2 (the FFN norm of Falcon-40B / 180B) is not "
                                  "ported yet (ROADMAP queue 1, item 8)")
    if "blk.0.ffn_norm_exps.weight" in reader.tensors:
        # arctic's residual MoE beside its dense FFN (build_arctic)
        raise NotImplementedError("ffn_norm_exps (arctic's residual mixture of experts) is not "
                                  "ported yet (ROADMAP queue 1, item 8)")
    moe = "blk.0.ffn_gate_inp.weight" in reader.tensors
    _check_names(reader, _TOP_TENSORS,
                 [*LAYER_KEY_MAP.values(), *OPTIONAL_NORMS.values(), *OPTIONAL_BIASES.values(),
                  *BIASES, *FUSED_QKV, *(MOE_KEY_MAP.values() if moe else ())], cfg.n_layers)
    q_perm = k_perm = qkv_perm = None
    if cfg.arch in PERMUTED_ROPE_ARCHS:  # NEOX rows are half-split already
        q_perm = unpermute_rows(cfg.n_q_dim, cfg.n_heads, cfg.rope_dim)
        k_perm = unpermute_rows(cfg.n_kv_dim, cfg.n_kv_heads, cfg.rope_dim)
        nq, nkv = cfg.n_q_dim, cfg.n_kv_dim
        qkv_perm = np.concatenate([q_perm, nq + k_perm, nq + nkv + np.arange(nkv)])
    key_map = dict(LAYER_KEY_MAP)
    if "blk.0.attn_qkv.weight" in reader.tensors:  # pre-fused (loader.py:728-732)
        for ours in ("wq", "wk", "wv"):
            key_map.pop(ours)
        key_map["wqkv"] = "attn_qkv.weight"
    if moe:  # the experts replace the dense FFN (loader.py:731-735)
        for ours in ("w_gate", "w_up", "w_down"):
            key_map.pop(ours)
    # a missing norm or gate (loader.py:756-758): command-r / phi2 share one
    # input norm, the no-gate MLP has no ffn_gate
    for ours in ("attn_norm", "ffn_norm", "w_gate"):
        if ours in key_map and f"blk.0.{key_map[ours]}" not in reader.tensors:
            key_map.pop(ours)
    for ours, suffix in {**OPTIONAL_NORMS, **OPTIONAL_BIASES}.items():
        if f"blk.0.{suffix}" in reader.tensors:
            key_map[ours] = suffix
    ld = _Loader(reader, dev, times)
    layers: dict[str, list] = {k: [] for k in key_map}
    for i in range(cfg.n_layers):
        for ours, suffix in key_map.items():
            perm = {"wq": q_perm, "wk": k_perm, "wqkv": qkv_perm}.get(ours)
            layout = "kn" if ours[0] == "w" else "nk"  # the matmul weights are "kn"
            layers[ours].append(ld.tensor(f"blk.{i}.{suffix}", row_perm=perm, layout=layout))
    if "blk.0.attn_qkv.bias" in reader.tensors:  # pre-fused (loader.py:790-797)
        layers["bqkv"] = [ld.tensor(f"blk.{i}.attn_qkv.bias", row_perm=qkv_perm)
                          for i in range(cfg.n_layers)]
    if "blk.0.attn_q.bias" in reader.tensors:  # qwen2, starcoder2, ... (loader.py:798-808)
        rows = []
        for i in range(cfg.n_layers):
            bq, bk, bv = (ld.tensor(f"blk.{i}.{name}") for name in BIASES)
            if q_perm is not None:
                bq = bq.index_select(0, torch.from_numpy(q_perm).to(dev))
                bk = bk.index_select(0, torch.from_numpy(k_perm).to(dev))
            rows.append(torch.cat([bq, bk, bv]))
        layers["bqkv"] = rows
    stacked = {k: _stack(v) for k, v in layers.items()}
    if moe:  # read densely, every layer's (loader.py:771-786)
        for ours, suffix in MOE_KEY_MAP.items():
            if f"blk.0.{suffix}" in reader.tensors:
                stacked[ours] = ld.dense([f"blk.{i}.{suffix}" for i in range(cfg.n_layers)],
                                         dense_dtype)
        if "ffn_gate_inp_shexp" in stacked:  # llama.cpp's [D] or the converter's [1, D]
            stacked["ffn_gate_inp_shexp"] = stacked["ffn_gate_inp_shexp"].reshape(
                cfg.n_layers, -1, cfg.n_embd)
    for ours in ("attn_q_norm", "attn_k_norm"):
        if ours in stacked and stacked[ours].shape[-1] != cfg.head_dim:
            raise NotImplementedError(
                f"{ours} of width {stacked[ours].shape[-1]}: only per-head q/k norms "
                f"[{cfg.head_dim}] are ported (olmo2's flat norm: ROADMAP queue 1, item 8)")
    params = {
        "tok_embd": ld.tensor("token_embd.weight"),
        "layers": fuse_layer_weights(stacked),
    }
    if "output_norm.weight" in reader.tensors:  # olmo's final norm has none
        params["output_norm"] = ld.tensor("output_norm.weight")
    if "output_norm.bias" in reader.tensors:
        params["output_norm_b"] = ld.tensor("output_norm.bias")
    if "rope_freqs.weight" in reader.tensors:  # Llama-3.1's per-frequency divisors
        params["rope_factors"] = ld.tensor("rope_freqs.weight")
    if "output.weight" in reader.tensors:
        params["output"] = ld.tensor("output.weight", layout="kn")
    else:  # tied embeddings: the table is the head, "nk"
        params["output"] = params["tok_embd"]
    if "output.bias" in reader.tensors:  # phi2's lm_head bias
        params["output_b"] = ld.tensor("output.bias")
    if "token_embd_norm.weight" in reader.tensors:  # bloom's embedding LayerNorm
        params["tok_embd_norm"] = ld.tensor("token_embd_norm.weight")
        if "token_embd_norm.bias" in reader.tensors:
            params["tok_embd_norm_b"] = ld.tensor("token_embd_norm.bias")
    if "position_embd.weight" in reader.tensors:  # gpt2 / starcoder learned positions
        # f32, any format read densely, as the reference's tensor_f32
        params["pos_embd"] = ld.dense(["position_embd.weight"], torch.float32).reshape(
            -1, cfg.n_embd)
    return params, cfg, reader.metadata


def load_eagle_params(path: str | Path, device="cuda",
                      times: dict | None = None) -> tuple[dict[str, Any], ModelConfig, dict]:
    """Load an EAGLE draft-head GGUF: token_embd, the fusion fc (+ bias) and
    one decoder layer without attn_norm. Unlike the reference, the layer's
    q/k/v and gate/up are fused, as the port's layer step takes them."""
    dev = resolve_device(device)
    reader = GGUFReader(path)
    cfg = ModelConfig.from_gguf_metadata(reader.metadata)
    if cfg.arch != "eagle":
        raise NotImplementedError(f"load_eagle_params reads eagle files, not {cfg.arch!r}")
    key_map = {k: v for k, v in LAYER_KEY_MAP.items() if k != "attn_norm"}
    if any(f"blk.0.{name}" in reader.tensors for name in BIASES):
        raise NotImplementedError("an EAGLE draft with q/k/v biases: the reference's "
                                  "load_eagle_params drops them (ROADMAP queue 3); not ported")
    _check_names(reader, _EAGLE_TOP_TENSORS, key_map.values(), 1)
    q_perm = unpermute_rows(cfg.n_q_dim, cfg.n_heads)
    k_perm = unpermute_rows(cfg.n_kv_dim, cfg.n_kv_heads)
    ld = _Loader(reader, dev, times)
    layer = {}
    for ours, suffix in key_map.items():
        perm = q_perm if ours == "wq" else k_perm if ours == "wk" else None
        layout = "nk" if ours.endswith("norm") else "kn"
        layer[ours] = _stack([ld.tensor(f"blk.0.{suffix}", row_perm=perm, layout=layout)])
    params = {
        "tok_embd": ld.tensor("token_embd.weight"),
        "fc_w": ld.tensor("fc.weight", layout="kn"),
        "fc_b": ld.tensor("fc.bias") if "fc.bias" in reader.tensors else None,
        "layers": fuse_layer_weights(layer),
    }
    return params, cfg, reader.metadata
