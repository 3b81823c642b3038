"""QTensor — group-quantized weights on the device, and the repack of GGUF
block bytes into it (port of eagle_tpu/quant/qtensor.py: `QTensor`, the
`_repack_*` functions behind `repack_numpy` and `repack_coded_numpy`, and
`concat_qtensors`; the helpers they use from eagle_tpu/quant/blocks.py,
and its `dequantize`: the dense read of every repackable format).

    w[n, k] = scale[n, k // G] * q[n, k] + bias[n, k // G]

with q a small integer:
    Q4_0:   G=32, q in [0,15],     scale=d,       bias=-8*d
    Q4_1:   G=32, q in [0,15],     scale=d,       bias=m
    Q5_0:   G=32, q in [0,31],     scale=d,       bias=-16*d
    Q5_1:   G=32, q in [0,31],     scale=d,       bias=m
    Q8_0:   G=32, q in [-128,127], scale=d,       no bias
    Q8_1:   G=32, q in [-128,127], scale=d,       no bias
    Q2_K:   G=16, q in [0,3],      scale=d*sc4,   bias=-dmin*m4
    Q3_K:   G=16, q in [-4,3],     scale=d*sc6,   no bias
    Q4_K:   G=32, q in [0,15],     scale=d*sc6,   bias=-dmin*m6
    Q5_K:   G=32, q in [0,31],     scale=d*sc6,   bias=-dmin*m6
    Q6_K:   G=16, q in [-32,31],   scale=d*sc8,   no bias
    IQ4_NL: G=32, q = kvalues[code] (codebook applied at repack), scale=d
    IQ4_XS: G=32, the same codebook, scale=d*ls6
The codebook formats (IQ1/IQ2/IQ3) collapse onto the same model after their
grid lookup (quant/iq_blocks.py).

The repackers are torch ops on whatever device holds the bytes, so the
loader uploads a tensor's raw blocks and repacks them on the card. They are
bit-exact with the reference's numpy and native repackers: f16 -> f32 is
exact, -8*d and -16*d are exact, and each k-quant product d*sc is one f32
multiply. `dequantize` builds dense values from the same parts in ggml's
order of operations, so they equal the reference's `dequantize` bit for
bit, signed zeros included."""

from __future__ import annotations

import dataclasses

import torch

from ..gguf.constants import GGMLType, ggml_row_bytes

Q4_K = int(GGMLType.Q4_K)
Q6_K = int(GGMLType.Q6_K)


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Group-quantized 2-D weight, logically [N, K] (out-features, in-features),
    optionally with a leading layer axis.

    Layouts:
      - "nk": q [N, K], scale/bias [N, K/G];
      - "kn": q [K, N], scale/bias [K/G, N] — the layout the qmm kernel reads.

    `packed` ("kn" only): 4-bit codes two per byte along K; within each group
    of G K-rows, packed row j holds values (j, j+G/2) in (lo, hi) nibbles —
    NOT adjacent pairs.

    Coded scales (`sup` set): `scale` holds int8 sub-scale codes and the
    effective scale is sup[k//256] * scale[k//G] (f32 product). Likewise
    `bias` holds min codes and bias = sup_min[k//256] * bias[k//G], with
    `sup_min` stored NEGATED (-dmin).

    `int4` ("kn" only; the reference's `q.dtype == jnp.int4`): signed codes
    in [-8, 7], 4 bits per weight, with w = q * scale + bias and no
    zero-point. q is int8 [.., K/2, N] of two's-complement nibbles in
    `packed`'s pairing: within each group of G K-rows, packed row j holds
    values (j, j+G/2) in its (lo, hi) nibbles. `packed` stays False: that
    flag means unsigned codes, which the qmm kernel reads; the qmm_i4
    kernel reads this form."""

    q: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor | None
    group: int = 32
    ggml_type: int = Q4_K
    layout: str = "nk"
    packed: bool = False
    sup: torch.Tensor | None = None
    sup_min: torch.Tensor | None = None
    int4: bool = False

    @property
    def shape(self):
        """Logical (N, K) shape of one layer regardless of layout/packing."""
        r, c = self.q.shape[-2:]
        if self.layout == "nk":
            return (r, c)
        return (c, 2 * r if self.packed or self.int4 else r)

    @property
    def coded(self) -> bool:
        return self.sup is not None

    def tensors(self) -> dict[str, torch.Tensor | None]:
        return {"q": self.q, "scale": self.scale, "bias": self.bias,
                "sup": self.sup, "sup_min": self.sup_min}

    def layer(self, i: int) -> "QTensor":
        """Layer `i` of a layer-stacked weight, as views (no copy)."""
        return dataclasses.replace(
            self, **{k: None if v is None else v[i] for k, v in self.tensors().items()}
        )

    def effective_scale_bias(self):
        """Materialized f32 (scale [.., K/G], bias|None) regardless of coding.
        Group axis is -1 for "nk", -2 for "kn"."""
        if self.sup is None:
            s = self.scale.float()
            b = None if self.bias is None else self.bias.float()
            return s, b
        ax = -1 if self.layout == "nk" else -2
        per = self.scale.shape[ax] // self.sup.shape[ax]

        def expand(sup, codes):
            return sup.float().repeat_interleave(per, dim=ax) * codes.float()

        s = expand(self.sup, self.scale)
        b = None if self.bias is None else expand(self.sup_min, self.bias)
        return s, b

    def unpack(self) -> "QTensor":
        """Expand nibble packing back to one int8 per value ("kn" only):
        unsigned codes in [0, 15], or signed ones in [-8, 7] for `int4`."""
        if not (self.packed or self.int4):
            return self
        assert self.layout == "kn"
        g = self.group
        *lead, kp, n = self.q.shape
        p = self.q.view(torch.uint8).reshape(*lead, kp // (g // 2), g // 2, n)
        lo = (p & 0xF).to(torch.int8)
        hi = (p >> 4).to(torch.int8)
        if self.int4:  # sign-extend the nibbles
            lo, hi = (lo ^ 8) - 8, (hi ^ 8) - 8
        q = torch.cat([lo, hi], dim=-2).reshape(*lead, 2 * kp, n)
        return dataclasses.replace(self, q=q, packed=False, int4=False)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Materialize dense [N, K] weights (reference path; the qmm kernel
        never does this)."""
        if self.packed or self.int4:
            return self.unpack().dequantize(dtype)
        g = self.group
        scale, bias = self.effective_scale_bias()
        if self.layout == "nk":
            n, k = self.q.shape
            w = self.q.float().reshape(n, k // g, g) * scale[:, :, None]
            if bias is not None:
                w = w + bias[:, :, None]
            return w.reshape(n, k).to(dtype)
        k, n = self.q.shape
        w = self.q.float().reshape(k // g, g, n) * scale[:, None, :]
        if bias is not None:
            w = w + bias[:, None, :]
        return w.reshape(k, n).T.to(dtype)


def pack_int4(q: torch.Tensor, group: int) -> torch.Tensor:
    """[..., K, N] int8 values in [-8, 7] -> [..., K/2, N] two's-complement
    nibbles in the (j, j + G/2) pairing of `QTensor.int4`."""
    half = group // 2
    *lead, k, n = q.shape
    qg = (q.view(torch.uint8) & 0xF).reshape(*lead, k // group, group, n)
    p = qg[..., :half, :] | (qg[..., half:, :] << 4)
    return p.reshape(*lead, k // 2, n).view(torch.int8)


# ---------------------------------------------------------------------------
# repack: GGUF block bytes (a uint8 tensor on any device) -> q, scale, bias
# ---------------------------------------------------------------------------


def _f16(b: torch.Tensor) -> torch.Tensor:
    """Little-endian f16 bytes (..., 2) uint8 -> (...) f32, exactly."""
    return b.contiguous().view(torch.float16).float().squeeze(-1)


def _blocks(data: torch.Tensor, size: int) -> torch.Tensor:
    if data.dtype != torch.uint8:
        raise TypeError(f"block bytes must be uint8, got {data.dtype}")
    return data.reshape(-1, size)


def _u16(b: torch.Tensor) -> torch.Tensor:
    """Little-endian u16 bytes (..., 2) uint8 -> (...) int32."""
    return b[..., 0].to(torch.int32) | (b[..., 1].to(torch.int32) << 8)


def _arange(n: int, like: torch.Tensor, step: int = 1) -> torch.Tensor:
    return torch.arange(0, n * step, step, dtype=like.dtype, device=like.device)


def _scale_min_k4(s: torch.Tensor):
    """Q4_K / Q5_K packed scales (nb, 12) -> (sc, m) uint8 (nb, 8) each
    (the reference's `_unpack_scale_min_k4`)."""
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)], dim=1)
    m = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], dim=1)
    return sc, m


def _q5_unpack(qs: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """(nb, 16) nibbles + (nb, 4) qh bytes -> (nb, 32) 5-bit values in block
    order; bit i of the little-endian u32 qh is the 5th bit of value i."""
    nb = qs.shape[0]
    bits = ((qh[:, :, None] >> _arange(8, qh)) & 1).reshape(nb, 32)
    return torch.cat([(qs & 0xF) | (bits[:, :16] << 4), (qs >> 4) | (bits[:, 16:] << 4)], dim=1)


def _kq_chunked_unpack2(qs: torch.Tensor) -> torch.Tensor:
    """Q2_K / Q3_K low bits (nb, 64) -> (nb, 16, 16) group-ordered 2-bit
    values: two 128-value chunks of 32 bytes, four 2-bit levels each; level
    j of chunk c holds groups 8c+2j (bytes 0-15) and 8c+2j+1 (bytes 16-31)."""
    nb = qs.shape[0]
    ch = qs.reshape(nb, 2, 1, 32)
    return ((ch >> _arange(4, qs, 2)[:, None]) & 3).reshape(nb, 16, 16)


def _q3k_unpack_scales(s: torch.Tensor) -> torch.Tensor:
    """Q3_K packed scales (nb, 12) -> (nb, 16) 6-bit values in [0, 63]."""
    hi = s[:, 8:12]
    return torch.cat([(s[:, 0:4] & 0xF) | ((hi & 3) << 4),
                      (s[:, 4:8] & 0xF) | (((hi >> 2) & 3) << 4),
                      (s[:, 0:4] >> 4) | (((hi >> 4) & 3) << 4),
                      (s[:, 4:8] >> 4) | (((hi >> 6) & 3) << 4)], dim=1)


#: IQ4_NL / IQ4_XS codebook (ggml-quants.c kvalues_iq4nl)
KVALUES_IQ4NL = (-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113)


def _iq4_values(codes: torch.Tensor) -> torch.Tensor:
    kv = torch.tensor(KVALUES_IQ4NL, dtype=torch.int8, device=codes.device)
    return kv[codes.long()]


def _q4_k_parts(data: torch.Tensor):
    """Q4_K super-blocks -> (q [nb, 256], d, dmin, sc [nb, 8], m [nb, 8])."""
    bl = _blocks(data, 144)
    nb = bl.shape[0]
    sc, m = _scale_min_k4(bl[:, 4:16])
    qs = bl[:, 16:].reshape(nb, 4, 32)  # 4 chunks of 32 bytes: groups 2c (lo), 2c+1 (hi)
    q = torch.stack([qs & 0xF, qs >> 4], dim=2).reshape(nb, 256).to(torch.int8)
    return q, _f16(bl[:, 0:2]), _f16(bl[:, 2:4]), sc, m


def _q5_k_parts(data: torch.Tensor):
    """Q5_K super-blocks -> (q [nb, 256] in [0, 31], d, dmin, sc, m)."""
    bl = _blocks(data, 176)
    nb = bl.shape[0]
    sc, m = _scale_min_k4(bl[:, 4:16])
    qh = bl[:, None, 16:48]  # bit 2c of byte l: 5th bit of group 2c's value l
    ql = bl[:, 48:].reshape(nb, 4, 32)
    shift = _arange(4, bl, 2)[:, None]
    lo = (ql & 0xF) | (((qh >> shift) & 1) << 4)
    hi = (ql >> 4) | (((qh >> (shift + 1)) & 1) << 4)
    q = torch.stack([lo, hi], dim=2).reshape(nb, 256).to(torch.int8)
    return q, _f16(bl[:, 0:2]), _f16(bl[:, 2:4]), sc, m


def _q6_k_parts(data: torch.Tensor):
    """Q6_K super-blocks -> (q [nb, 256] in [-32, 31], sc int8 [nb, 16], d)."""
    bl = _blocks(data, 210)
    nb = bl.shape[0]
    ql = bl[:, 0:128].reshape(nb, 2, 64)
    qh = bl[:, 128:192].reshape(nb, 2, 32)
    lo, hi = ql[:, :, :32], ql[:, :, 32:]
    q = torch.cat([(lo & 0xF) | ((qh & 3) << 4), (hi & 0xF) | (((qh >> 2) & 3) << 4),
                   (lo >> 4) | (((qh >> 4) & 3) << 4), (hi >> 4) | (((qh >> 6) & 3) << 4)],
                  dim=2)
    q = (q.to(torch.int16) - 32).to(torch.int8).reshape(nb, 256)
    return q, bl[:, 192:208].contiguous().view(torch.int8), _f16(bl[:, 208:210])


def _repack_q8_0(data, n, k):
    bl = _blocks(data, 34)
    q = bl[:, 2:].contiguous().view(torch.int8)
    return q.reshape(n, k), _f16(bl[:, :2]).reshape(n, k // 32), None, 32


def _repack_q4_0(data, n, k):
    bl = _blocks(data, 18)
    d = _f16(bl[:, :2])
    qs = bl[:, 2:]
    q = torch.cat([qs & 0xF, qs >> 4], dim=1).to(torch.int8)  # block order lo | hi
    return q.reshape(n, k), d.reshape(n, k // 32), (-8.0 * d).reshape(n, k // 32), 32


def _repack_q4_1(data, n, k):
    bl = _blocks(data, 20)
    qs = bl[:, 4:]
    q = torch.cat([qs & 0xF, qs >> 4], dim=1).to(torch.int8)
    return (q.reshape(n, k), _f16(bl[:, 0:2]).reshape(n, k // 32),
            _f16(bl[:, 2:4]).reshape(n, k // 32), 32)


def _repack_q5_0(data, n, k):
    bl = _blocks(data, 22)
    d = _f16(bl[:, 0:2])
    q = _q5_unpack(bl[:, 6:], bl[:, 2:6]).to(torch.int8)
    return q.reshape(n, k), d.reshape(n, k // 32), (-16.0 * d).reshape(n, k // 32), 32


def _repack_q5_1(data, n, k):
    bl = _blocks(data, 24)
    q = _q5_unpack(bl[:, 8:], bl[:, 4:8]).to(torch.int8)
    return (q.reshape(n, k), _f16(bl[:, 0:2]).reshape(n, k // 32),
            _f16(bl[:, 2:4]).reshape(n, k // 32), 32)


def _repack_q8_1(data, n, k):
    bl = _blocks(data, 36)
    q = bl[:, 4:].contiguous().view(torch.int8)
    return q.reshape(n, k), _f16(bl[:, 0:2]).reshape(n, k // 32), None, 32


def _repack_q2_k(data, n, k):
    bl = _blocks(data, 84)
    d, dmin = _f16(bl[:, 80:82]), _f16(bl[:, 82:84])
    sc = bl[:, 0:16]
    q = _kq_chunked_unpack2(bl[:, 16:80]).to(torch.int8)
    scale = d[:, None] * (sc & 0xF).float()
    bias = -(dmin[:, None] * (sc >> 4).float())
    return q.reshape(n, k), scale.reshape(n, k // 16), bias.reshape(n, k // 16), 16


def _repack_q3_k(data, n, k):
    bl = _blocks(data, 110)
    nb = bl.shape[0]
    # high bit of group 2s (bytes 0-15 of hmask) and 2s+1 (bytes 16-31) at bit s
    hm = bl[:, 0:32].reshape(nb, 1, 2, 16)
    hb = ((hm >> _arange(8, bl)[:, None, None]) & 1).reshape(nb, 16, 16)
    q2 = _kq_chunked_unpack2(bl[:, 32:96])
    q = (q2.to(torch.int16) - (1 - hb.to(torch.int16)) * 4).to(torch.int8)
    sc = _q3k_unpack_scales(bl[:, 96:108]).to(torch.int32) - 32
    scale = _f16(bl[:, 108:110])[:, None] * sc.float()
    return q.reshape(n, k), scale.reshape(n, k // 16), None, 16


def _repack_q4_k(data, n, k):
    q, d, dmin, sc, m = _q4_k_parts(data)
    scale = d[:, None] * sc.float()
    bias = -(dmin[:, None] * m.float())
    return q.reshape(n, k), scale.reshape(n, k // 32), bias.reshape(n, k // 32), 32


def _repack_q5_k(data, n, k):
    q, d, dmin, sc, m = _q5_k_parts(data)
    scale = d[:, None] * sc.float()
    bias = -(dmin[:, None] * m.float())
    return q.reshape(n, k), scale.reshape(n, k // 32), bias.reshape(n, k // 32), 32


def _repack_q6_k(data, n, k):
    q, sc, d = _q6_k_parts(data)
    return q.reshape(n, k), (d[:, None] * sc.float()).reshape(n, k // 16), None, 16


def _repack_iq4_nl(data, n, k):
    bl = _blocks(data, 18)
    qs = bl[:, 2:]
    q = torch.cat([_iq4_values(qs & 0xF), _iq4_values(qs >> 4)], dim=1)
    return q.reshape(n, k), _f16(bl[:, 0:2]).reshape(n, k // 32), None, 32


def _repack_iq4_xs(data, n, k):
    bl = _blocks(data, 136)
    nb = bl.shape[0]
    d = _f16(bl[:, 0:2])
    scales_h = _u16(bl[:, 2:4])
    ib = _arange(8, scales_h)
    sl = bl[:, 4:8].repeat_interleave(2, dim=1).to(torch.int32)  # byte ib // 2
    ls_lo = torch.where(ib % 2 == 0, sl & 0xF, sl >> 4)
    ls = (ls_lo | (((scales_h[:, None] >> (2 * ib)) & 3) << 4)) - 32
    qs = bl[:, 8:].reshape(nb, 8, 16)
    q = torch.cat([_iq4_values(qs & 0xF), _iq4_values(qs >> 4)], dim=2)
    scale = d[:, None] * ls.float()
    return q.reshape(n, k), scale.reshape(n, k // 32), None, 32


def _repack_q4_k_coded(data, n, k):
    q, d, dmin, sc, m = _q4_k_parts(data)
    return (q.reshape(n, k), sc.to(torch.int8).reshape(n, k // 32),
            m.to(torch.int8).reshape(n, k // 32), 32, d.reshape(n, k // 256),
            (-dmin).reshape(n, k // 256))


def _repack_q5_k_coded(data, n, k):
    q, d, dmin, sc, m = _q5_k_parts(data)
    return (q.reshape(n, k), sc.to(torch.int8).reshape(n, k // 32),
            m.to(torch.int8).reshape(n, k // 32), 32, d.reshape(n, k // 256),
            (-dmin).reshape(n, k // 256))


def _repack_q6_k_coded(data, n, k):
    q, sc, d = _q6_k_parts(data)
    return q.reshape(n, k), sc.reshape(n, k // 16), None, 16, d.reshape(n, k // 256), None


_REPACKERS = {
    GGMLType.Q8_0: _repack_q8_0,
    GGMLType.Q8_1: _repack_q8_1,
    GGMLType.Q4_0: _repack_q4_0,
    GGMLType.Q4_1: _repack_q4_1,
    GGMLType.Q5_0: _repack_q5_0,
    GGMLType.Q5_1: _repack_q5_1,
    GGMLType.Q2_K: _repack_q2_k,
    GGMLType.Q3_K: _repack_q3_k,
    GGMLType.Q4_K: _repack_q4_k,
    GGMLType.Q5_K: _repack_q5_k,
    GGMLType.Q6_K: _repack_q6_k,
    GGMLType.IQ4_NL: _repack_iq4_nl,
    GGMLType.IQ4_XS: _repack_iq4_xs,
}

# the codebook formats collapse onto the same affine model after their grid
# lookup (quant/iq_blocks.py)
from .iq_blocks import IQ_REPACKERS  # noqa: E402

_REPACKERS.update(IQ_REPACKERS)
REPACKABLE_TYPES = tuple(sorted(_REPACKERS, key=int))

#: k-quant formats whose super-block factorization the loader keeps (coded
#: scales: int8 sub-scale codes + f32 per-256 super-scales)
_CODED_REPACKERS = {GGMLType.Q4_K: _repack_q4_k_coded, GGMLType.Q5_K: _repack_q5_k_coded,
                    GGMLType.Q6_K: _repack_q6_k_coded}
CODED_TYPES = tuple(sorted(_CODED_REPACKERS, key=int))


def _nk(shape) -> tuple[int, int]:
    if len(shape) != 2:
        n = 1
        for s in shape[:-1]:
            n *= int(s)
        return n, int(shape[-1])
    return int(shape[0]), int(shape[1])


def repack(data: torch.Tensor, ggml_type, shape):
    """GGUF block bytes -> (q int8 [N, K], scale f32 [N, K/G], bias|None, G)
    on data's device (counterpart of `repack_numpy`). `shape` is the
    numpy-convention (N, K), K contiguous."""
    n, k = _nk(shape)
    return _REPACKERS[GGMLType(ggml_type)](data, n, k)


def repack_coded(data: torch.Tensor, ggml_type, shape):
    """GGUF block bytes -> (q, sub-scale codes, min codes|None, G, super-scale
    f32 [N, K/256], -super-min|None) for CODED_TYPES (counterpart of
    `repack_coded_numpy`)."""
    n, k = _nk(shape)
    return _CODED_REPACKERS[GGMLType(ggml_type)](data, n, k)


#: formats whose ggml formula subtracts the zero point from the code before
#: the scale, (q - z) * d: the repack's q * d + (-z * d) gives +0 where
#: ggml gives -0 (q == z under a negative d)
_ZERO_POINT = {GGMLType.Q4_0: 8, GGMLType.Q5_0: 16}
#: values decoded at once by `dequantize` (its f32 temporaries: ~1 GiB)
DENSE_CHUNK = 1 << 26


def _dense_rows(data: torch.Tensor, ggml_type: GGMLType, n: int, k: int) -> torch.Tensor:
    """n rows of k values of one format -> f32 [n, k], as ggml's dequantize
    (the reference's `quant/blocks.py:dequantize`) computes each value."""
    if ggml_type == GGMLType.F32:
        return data.view(torch.float32).reshape(n, k).clone()
    if ggml_type == GGMLType.F16:
        return data.view(torch.float16).float().reshape(n, k)
    q, scale, bias, g = _REPACKERS[ggml_type](data, n, k)
    q = q.reshape(n, k // g, g)
    if ggml_type in _ZERO_POINT:
        return ((q.to(torch.int16) - _ZERO_POINT[ggml_type]).float()
                * scale[:, :, None]).reshape(n, k)
    w = q.float() * scale[:, :, None]
    if bias is not None:
        w = w + bias[:, :, None]
    return w.reshape(n, k)


def dequantize(data: torch.Tensor, ggml_type, shape, out: torch.Tensor | None = None
               ) -> torch.Tensor:
    """GGUF bytes (uint8, on any device) -> dense f32 values of
    numpy-convention `shape` (2-D, or 3-D for an [E, N, K] expert stack),
    decoded on the bytes' device (counterpart of the reference's
    `quant/blocks.py:dequantize`, bit for bit for F32, F16 and every
    repackable format). Rows are decoded `DENSE_CHUNK` values at a time, so the
    f32 temporaries stay bounded; with `out` (any float dtype) each chunk
    is rounded into it."""
    t = GGMLType(ggml_type)
    n, k = _nk(shape)
    if out is None:
        out = torch.empty(tuple(shape), dtype=torch.float32, device=data.device)
    flat = out.view(n, k)
    row_bytes = ggml_row_bytes(t, k)
    if data.numel() != n * row_bytes:
        raise ValueError(f"{t.name} {tuple(shape)}: {data.numel()} bytes, expected "
                         f"{n * row_bytes}")
    step = max(1, DENSE_CHUNK // k)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        flat[r0:r1] = _dense_rows(data[r0 * row_bytes:r1 * row_bytes], t, r1 - r0, k)
    return out


def concat_qtensors(tensors: list) -> "QTensor | torch.Tensor":
    """Concatenate QTensors (or dense [.., N, K] tensors) along the logical N
    axis: fuses q/k/v and gate/up into one weight each."""
    first = tensors[0]
    if not isinstance(first, QTensor):
        return torch.cat(list(tensors), dim=-2)
    for t in tensors:
        if (t.layout, t.group, t.packed, t.int4, t.coded) != (
                first.layout, first.group, first.packed, first.int4, first.coded):
            raise ValueError("concat_qtensors needs one layout, group, packing and coding")
    ax = -1 if first.layout == "kn" else -2

    def cat(field):
        vals = [getattr(t, field) for t in tensors]
        return None if vals[0] is None else torch.cat(vals, dim=ax)

    return dataclasses.replace(first, **{f: cat(f) for f in first.tensors()})
