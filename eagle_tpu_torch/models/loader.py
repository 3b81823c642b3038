"""GGUF -> params on the device (port of eagle_tpu/models/loader.py:
`unpermute_rows`, `_load_tensor`, `_stack`, `fuse_layer_weights`, the plain
llama branch of `load_llama_params`, and `load_eagle_params`).

Each tensor's raw block bytes are copied from the file's map into a pinned
staging buffer ("read"), uploaded ("upload") and repacked on the device
("repack", quant/qtensor.py), so the host never holds the file twice and
never sees a float weight. Matmul weights are stored "kn" (K-major, the qmm
layout), stacked over layers, with q/k and gate/up fused along N. The q/k
rows of llama-family GGUFs carry convert_hf_to_gguf's adjacent-pair rope
permutation; it is inverted along N at load, so the runtime's rope is
half-split.

Coded load (`EAGLE_TPU_CODED_LOAD`, default on; "0" or "false" turns it
off, read at each load): k-quant matmul weights keep int8 sub-scale codes
and f32 per-256 super-scales instead of materialized f32 products.

A Llama-3.1 file's `rope_freqs.weight` loads as `params["rope_factors"]`
(f32); a file without `output.weight` (tied embeddings, Llama-3.2-1B / 3B)
takes `token_embd` as its head, which stays "nk".

Anything outside the plain llama block (MoE, MLA, biases, q/k norms,
per-layer head counts, recurrent layers, ...) raises
NotImplementedError."""

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
from ..quant.qtensor import CODED_TYPES, REPACKABLE_TYPES, QTensor, concat_qtensors, repack, repack_coded
from .config import ModelConfig

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
_TOP_TENSORS = {"token_embd.weight", "output_norm.weight", "output.weight",
                "rope_freqs.weight"}
_EAGLE_TOP_TENSORS = {"token_embd.weight", "fc.weight", "fc.bias"}
_DENSE_TYPES = (GGMLType.F32, GGMLType.F16)


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
    to `times` ("read", "upload", "repack" seconds) when it is given."""

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

    def tensor(self, name: str, row_perm: np.ndarray | None = None,
               layout: str = "nk") -> QTensor | torch.Tensor:
        """One tensor: a QTensor for the block formats, f32 for F32/F16.
        The row permutation (logical N axis) comes before the transpose to
        "kn"."""
        info = self.reader.tensors[name]
        perm = None if row_perm is None else torch.from_numpy(row_perm).to(self.dev)
        if info.ggml_type in _DENSE_TYPES:
            with self.phase("read"):
                w = torch.from_numpy(self.reader.tensor_f32(name))
            with self.phase("upload"):
                w = w.to(self.dev)
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
    """Fuse q/k/v into `wqkv` and gate/up into `w_gate_up` along N."""
    out = dict(stacked)
    if "wq" in out:
        out["wqkv"] = concat_qtensors([out.pop("wq"), out.pop("wk"), out.pop("wv")])
    if "w_gate" in out:
        out["w_gate_up"] = concat_qtensors([out.pop("w_gate"), out.pop("w_up")])
    return out


def _check_names(reader: GGUFReader, top: set[str], layer_suffixes, n_layers: int) -> None:
    known = set(top) | {f"blk.{i}.{s}" for i in range(n_layers) for s in layer_suffixes}
    extra = sorted(set(reader.tensors) - known)
    if extra:
        raise NotImplementedError(f"tensors not ported yet: {extra[:8]}")


def load_llama_params(path: str | Path, device="cuda",
                      times: dict | None = None) -> tuple[dict[str, Any], ModelConfig, dict]:
    """Load a plain llama GGUF. Returns (params, config, metadata); every
    weight lies on `device`. `times`, when given, gathers the seconds spent
    reading, uploading and repacking."""
    dev = resolve_device(device)
    reader = GGUFReader(path)
    cfg = ModelConfig.from_gguf_metadata(reader.metadata)
    if cfg.arch != "llama":
        raise NotImplementedError(f"load_llama_params reads llama files, not {cfg.arch!r}")
    _check_names(reader, _TOP_TENSORS, LAYER_KEY_MAP.values(), cfg.n_layers)
    q_perm = unpermute_rows(cfg.n_q_dim, cfg.n_heads, cfg.rope_dim)
    k_perm = unpermute_rows(cfg.n_kv_dim, cfg.n_kv_heads, cfg.rope_dim)
    ld = _Loader(reader, dev, times)
    layers: dict[str, list] = {k: [] for k in LAYER_KEY_MAP}
    for i in range(cfg.n_layers):
        for ours, suffix in LAYER_KEY_MAP.items():
            perm = q_perm if ours == "wq" else k_perm if ours == "wk" else None
            layout = "nk" if ours.endswith("norm") else "kn"
            layers[ours].append(ld.tensor(f"blk.{i}.{suffix}", row_perm=perm, layout=layout))
    stacked = {k: _stack(v) for k, v in layers.items()}
    params = {
        "tok_embd": ld.tensor("token_embd.weight"),
        "layers": fuse_layer_weights(stacked),
        "output_norm": ld.tensor("output_norm.weight"),
    }
    if "rope_freqs.weight" in reader.tensors:  # Llama-3.1's per-frequency divisors
        params["rope_factors"] = ld.tensor("rope_freqs.weight")
    if "output.weight" in reader.tensors:
        params["output"] = ld.tensor("output.weight", layout="kn")
    else:  # tied embeddings: the table is the head, "nk"
        params["output"] = params["tok_embd"]
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
