"""The codebook quant formats IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S
and IQ1_M (port of eagle_tpu/quant/iq_blocks.py: the decoders and the
`ksigns` derivation).

A value is scale * grid[index] * sign (IQ2/IQ3) or scale * (grid[index] +
delta) (IQ1). After the codebook lookup both collapse exactly onto the
affine QTensor model:

    IQ2/IQ3:  q = sign * grid_byte  (|q| <= 62, int8), no bias
    IQ1:      q = grid in {-1, 0, 1},  bias = scale * (+-0.125)

so each decoder gives (q int8, scale f32, bias|None, group) as the affine
repackers do, as torch ops on the device that holds the bytes, bit-exact
with the reference (every scale is the same f32 operations in the same
order; the sign flip and the +-delta products are exact). IQ1_M has groups
of 8: its delta changes every 8 values.

The codebooks are format data (ggml-common.h's iq*_grid tables), kept in
the port's own copy of `iq_grids.npz` beside this file."""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from ..gguf.constants import GGML_TYPE_TRAITS, QK_K, GGMLType

NPZ = Path(__file__).resolve().parent / "iq_grids.npz"
_IQ1_DELTA = 0.125  # IQ1S_DELTA / IQ1M_DELTA, ggml-quants.c


@functools.lru_cache(maxsize=None)
def _host_grids() -> dict[str, np.ndarray]:
    """The grids as little-endian byte rows (as the C code reads
    `(const uint8_t *)(iqX_grid + index)`), and ksigns."""
    z = np.load(NPZ)
    out = {
        "iq2xxs": z["iq2xxs_grid"].astype("<u8").view(np.uint8).reshape(256, 8),
        "iq2xs": z["iq2xs_grid"].astype("<u8").view(np.uint8).reshape(512, 8),
        "iq2s": z["iq2s_grid"].astype("<u8").view(np.uint8).reshape(1024, 8),
        "iq3xxs": z["iq3xxs_grid"].astype("<u4").view(np.uint8).reshape(256, 4),
        "iq3s": z["iq3s_grid"].astype("<u4").view(np.uint8).reshape(512, 4),
        "iq1s": z["iq1s_grid"].astype("<u8").view(np.int8).reshape(2048, 8),
    }
    # ksigns_iq2xs (ggml-common.h) is derivable: byte i carries the 7 stored
    # sign bits plus their odd parity in bit 7 (the 8th sign)
    i = np.arange(128, dtype=np.uint8)
    parity = i.copy()
    parity ^= parity >> 4
    parity ^= parity >> 2
    parity ^= parity >> 1
    out["ksigns"] = (i | ((parity & 1) << 7)).astype(np.uint8)
    return out


@functools.lru_cache(maxsize=None)
def _grids(device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v.copy()).to(device) for k, v in _host_grids().items()}


def _f16(b: torch.Tensor) -> torch.Tensor:
    """Little-endian f16 bytes (nb, 2) -> (nb,) f32, exactly."""
    return b.contiguous().view(torch.float16).float().squeeze(-1)


def _uint(b: torch.Tensor) -> torch.Tensor:
    """Little-endian unsigned bytes (..., w) -> (...) int64."""
    out = b[..., 0].to(torch.int64)
    for i in range(1, b.shape[-1]):
        out = out | (b[..., i].to(torch.int64) << (8 * i))
    return out


def _bits(x: torch.Tensor, shifts) -> torch.Tensor:
    """x[..., None] >> shifts, as int64."""
    return x.to(torch.int64)[..., None] >> torch.as_tensor(shifts, dtype=torch.int64,
                                                            device=x.device)


def _sign_bits(sign_bytes: torch.Tensor) -> torch.Tensor:
    """uint8 [...] -> [..., 8] of {0, 1}: bit j is the sign of grid value j."""
    return _bits(sign_bytes, range(8)) & 1


def _signed(grid_vals: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Unsigned grid magnitudes with sign bits -> int8 codes."""
    g = grid_vals.to(torch.int16)
    return torch.where(bits == 1, -g, g).to(torch.int8)


def _ksign_bits(gr, aux: torch.Tensor) -> torch.Tensor:
    """Four 7-bit ksigns indices per u32 `aux` -> [..., 4, 8] sign bits."""
    return _sign_bits(gr["ksigns"][_bits(aux, [0, 7, 14, 21]) & 0x7F])


def _decode_iq2_xxs(bl: torch.Tensor):
    gr = _grids(bl.device)
    nb = bl.shape[0]
    d = _f16(bl[:, :2])
    sub = bl[:, 2:].reshape(nb, 8, 8)
    aux = _uint(sub[:, :, 4:])  # [nb, 8]
    scale = d[:, None] * (0.5 + (aux >> 28).float()) * 0.25
    q = _signed(gr["iq2xxs"][sub[:, :, :4].long()], _ksign_bits(gr, aux))  # [nb, 8, 4, 8]
    return q.reshape(nb, QK_K), scale, None, 32


def _decode_iq2_xs(bl: torch.Tensor):
    gr = _grids(bl.device)
    nb = bl.shape[0]
    d = _f16(bl[:, :2])
    qs = _uint(bl[:, 2:66].reshape(nb, 32, 2))  # 9-bit grid index + 7-bit ksigns index
    sc = bl[:, 66:74]
    ls = torch.stack([sc & 0xF, sc >> 4], dim=-1).reshape(nb, 16).float()
    scale = d[:, None] * (0.5 + ls) * 0.25  # per 16 values
    q = _signed(gr["iq2xs"][qs & 511], _sign_bits(gr["ksigns"][qs >> 9]))
    return q.reshape(nb, QK_K), scale, None, 16


def _decode_iq2_s(bl: torch.Tensor):
    gr = _grids(bl.device)
    nb = bl.shape[0]
    d = _f16(bl[:, :2])
    qh = bl[:, 66:74].repeat_interleave(4, dim=1)  # byte l // 4 for index l
    shift = torch.arange(0, 8, 2, dtype=torch.int64, device=bl.device).repeat(8)
    idx = bl[:, 2:34].to(torch.int64) | (((qh.to(torch.int64) >> shift) & 3) << 8)
    sc = bl[:, 74:82]
    ls = torch.stack([sc & 0xF, sc >> 4], dim=-1).reshape(nb, 16).float()
    scale = d[:, None] * (0.5 + ls) * 0.25
    q = _signed(gr["iq2s"][idx], _sign_bits(bl[:, 34:66]))
    return q.reshape(nb, QK_K), scale, None, 16


def _decode_iq3_xxs(bl: torch.Tensor):
    gr = _grids(bl.device)
    nb = bl.shape[0]
    d = _f16(bl[:, :2])
    aux = _uint(bl[:, 66:98].reshape(nb, 8, 4))  # [nb, 8]
    scale = d[:, None] * (0.5 + (aux >> 28).float()) * 0.5
    bits = _ksign_bits(gr, aux).reshape(nb, 8, 32)
    vals = gr["iq3xxs"][bl[:, 2:66].long()].reshape(nb, 8, 32)  # 8 rows of 4 per sub-block
    return _signed(vals, bits).reshape(nb, QK_K), scale, None, 32


def _decode_iq3_s(bl: torch.Tensor):
    gr = _grids(bl.device)
    nb = bl.shape[0]
    d = _f16(bl[:, :2])
    qs = bl[:, 2:66].reshape(nb, 8, 8).to(torch.int64)
    idx = qs | ((_bits(bl[:, 66:74], range(8)) & 1) << 8)
    vals = gr["iq3s"][idx].reshape(nb, 8, 32)
    bits = _sign_bits(bl[:, 74:106]).reshape(nb, 8, 32)
    sc = bl[:, 106:110]
    ls = torch.stack([sc & 0xF, sc >> 4], dim=-1).reshape(nb, 8).float()
    scale = d[:, None] * (1.0 + 2.0 * ls)
    return _signed(vals, bits).reshape(nb, QK_K), scale, None, 32


def _delta(sign_bit: torch.Tensor) -> torch.Tensor:
    return torch.where(sign_bit != 0, -_IQ1_DELTA, _IQ1_DELTA).float()


def _decode_iq1_s(bl: torch.Tensor):
    gr = _grids(bl.device)
    nb = bl.shape[0]
    d = _f16(bl[:, :2])
    qs = bl[:, 2:34].reshape(nb, 8, 4).to(torch.int64)
    qh = _uint(bl[:, 34:50].reshape(nb, 8, 2))  # [nb, 8]
    idx = qs | ((_bits(qh, [0, 3, 6, 9]) & 7) << 8)
    q = gr["iq1s"][idx].reshape(nb, QK_K)  # already signed {-1, 0, 1}
    dl = d[:, None] * (2.0 * ((qh >> 12) & 7).float() + 1.0)
    return q, dl, dl * _delta(qh & 0x8000), 32


def _decode_iq1_m(bl: torch.Tensor):
    gr = _grids(bl.device)
    nb = bl.shape[0]
    sc16 = _uint(bl[:, 48:56].reshape(nb, 4, 2))  # [nb, 4]
    # the f16 super-scale hides in the top 4 bits of the four scale words
    dbits = (sc16 & 0xF000) >> torch.tensor([12, 8, 4, 0], device=bl.device)
    dbits = dbits[:, 0] | dbits[:, 1] | dbits[:, 2] | dbits[:, 3]
    d = _f16(torch.stack([dbits & 0xFF, dbits >> 8], dim=1).to(torch.uint8))
    ls = (_bits(sc16, [0, 3, 6, 9]) & 7).reshape(nb, 16)
    dl = d[:, None] * (2.0 * ls.float() + 1.0)  # per 16 values
    qh = bl[:, 32:48]
    qhn = torch.stack([qh & 0xF, qh >> 4], dim=-1).reshape(nb, 32).to(torch.int64)  # per 8
    idx = bl[:, 0:32].to(torch.int64) | ((qhn & 7) << 8)
    q = gr["iq1s"][idx].reshape(nb, QK_K)
    scale8 = dl.repeat_interleave(2, dim=1)  # per-16 scale -> group 8
    return q, scale8, scale8 * _delta(qhn & 8), 8


def _repack(fn, type_size: int):
    def rp(data: torch.Tensor, n: int, k: int):
        if data.dtype != torch.uint8:
            raise TypeError(f"block bytes must be uint8, got {data.dtype}")
        q, scale, bias, g = fn(data.reshape(-1, type_size))
        return (q.reshape(n, k), scale.reshape(n, k // g),
                None if bias is None else bias.reshape(n, k // g), g)

    return rp


IQ_REPACKERS = {
    t: _repack(fn, GGML_TYPE_TRAITS[t].type_size)
    for t, fn in ((GGMLType.IQ2_XXS, _decode_iq2_xxs), (GGMLType.IQ2_XS, _decode_iq2_xs),
                  (GGMLType.IQ2_S, _decode_iq2_s), (GGMLType.IQ3_XXS, _decode_iq3_xxs),
                  (GGMLType.IQ3_S, _decode_iq3_s), (GGMLType.IQ1_S, _decode_iq1_s),
                  (GGMLType.IQ1_M, _decode_iq1_m))
}
