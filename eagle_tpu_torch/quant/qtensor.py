"""QTensor — group-quantized weights on the device, and the repack of GGUF
block bytes into it (port of eagle_tpu/quant/qtensor.py: `QTensor`, the
`_repack_*` functions behind `repack_numpy` and `repack_coded_numpy`, and
`concat_qtensors`).

    w[n, k] = scale[n, k // G] * q[n, k] + bias[n, k // G]

with q a small integer:
    Q4_0: G=32, q in [0,15],     scale=d,     bias=-8*d
    Q8_0: G=32, q in [-128,127], scale=d,     no bias
    Q4_K: G=32, q in [0,15],     scale=d*sc6, bias=-dmin*m6
    Q6_K: G=16, q in [-32,31],   scale=d*sc8, no bias

The repackers are torch ops on whatever device holds the bytes, so the
loader uploads a tensor's raw blocks and repacks them on the card. They are
bit-exact with the reference's numpy and native repackers: f16 -> f32 is
exact, -8*d is exact, and each k-quant product d*sc is one f32 multiply."""

from __future__ import annotations

import dataclasses

import torch

from ..gguf.constants import GGMLType

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
    `sup_min` stored NEGATED (-dmin)."""

    q: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor | None
    group: int = 32
    ggml_type: int = Q4_K
    layout: str = "nk"
    packed: bool = False
    sup: torch.Tensor | None = None
    sup_min: torch.Tensor | None = None

    @property
    def shape(self):
        """Logical (N, K) shape of one layer regardless of layout/packing."""
        r, c = self.q.shape[-2:]
        if self.layout == "nk":
            return (r, c)
        return (c, 2 * r if self.packed else r)

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
        """Expand nibble packing back to one int8 per value ("kn" only)."""
        if not self.packed:
            return self
        assert self.layout == "kn"
        g = self.group
        *lead, kp, n = self.q.shape
        p = self.q.view(torch.uint8).reshape(*lead, kp // (g // 2), g // 2, n)
        lo = (p & 0xF).to(torch.int8)
        hi = (p >> 4).to(torch.int8)
        q = torch.cat([lo, hi], dim=-2).reshape(*lead, 2 * kp, n)
        return dataclasses.replace(self, q=q, packed=False)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Materialize dense [N, K] weights (reference path; the qmm kernel
        never does this)."""
        if self.packed:
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


def _q4_k_parts(data: torch.Tensor):
    """Q4_K super-blocks -> (q [nb, 256], d, dmin, sc [nb, 8], m [nb, 8])."""
    bl = _blocks(data, 144)
    nb = bl.shape[0]
    s = bl[:, 4:16]
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)], dim=1)
    m = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], dim=1)
    qs = bl[:, 16:].reshape(nb, 4, 32)  # 4 chunks of 32 bytes: groups 2c (lo), 2c+1 (hi)
    q = torch.stack([qs & 0xF, qs >> 4], dim=2).reshape(nb, 256).to(torch.int8)
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


def _repack_q4_k(data, n, k):
    q, d, dmin, sc, m = _q4_k_parts(data)
    scale = d[:, None] * sc.float()
    bias = -(dmin[:, None] * m.float())
    return q.reshape(n, k), scale.reshape(n, k // 32), bias.reshape(n, k // 32), 32


def _repack_q6_k(data, n, k):
    q, sc, d = _q6_k_parts(data)
    return q.reshape(n, k), (d[:, None] * sc.float()).reshape(n, k // 16), None, 16


def _repack_q4_k_coded(data, n, k):
    q, d, dmin, sc, m = _q4_k_parts(data)
    return (q.reshape(n, k), sc.to(torch.int8).reshape(n, k // 32),
            m.to(torch.int8).reshape(n, k // 32), 32, d.reshape(n, k // 256),
            (-dmin).reshape(n, k // 256))


def _repack_q6_k_coded(data, n, k):
    q, sc, d = _q6_k_parts(data)
    return q.reshape(n, k), sc.reshape(n, k // 16), None, 16, d.reshape(n, k // 256), None


_REPACKERS = {
    GGMLType.Q8_0: _repack_q8_0,
    GGMLType.Q4_0: _repack_q4_0,
    GGMLType.Q4_K: _repack_q4_k,
    GGMLType.Q6_K: _repack_q6_k,
}
REPACKABLE_TYPES = tuple(sorted(_REPACKERS, key=int))

#: k-quant formats whose super-block factorization the loader keeps (coded
#: scales: int8 sub-scale codes + f32 per-256 super-scales)
_CODED_REPACKERS = {GGMLType.Q4_K: _repack_q4_k_coded, GGMLType.Q6_K: _repack_q6_k_coded}
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


def concat_qtensors(tensors: list) -> "QTensor | torch.Tensor":
    """Concatenate QTensors (or dense [.., N, K] tensors) along the logical N
    axis: fuses q/k/v and gate/up into one weight each."""
    first = tensors[0]
    if not isinstance(first, QTensor):
        return torch.cat(list(tensors), dim=-2)
    for t in tensors:
        if (t.layout, t.group, t.packed, t.coded) != (first.layout, first.group,
                                                     first.packed, first.coded):
            raise ValueError("concat_qtensors needs one layout, group, packing and coding")
    ax = -1 if first.layout == "kn" else -2

    def cat(field):
        vals = [getattr(t, field) for t in tensors]
        return None if vals[0] is None else torch.cat(vals, dim=ax)

    return dataclasses.replace(first, **{f: cat(f) for f in first.tensors()})
