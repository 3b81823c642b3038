"""Weights carried across from the JAX package.

`params_from_numpy` turns a parameter tree whose leaves were converted with
`np.asarray` on the JAX side into the port's params. A JAX QTensor arrives as
a dict of arrays plus its static fields (`q`, `scale`, `bias`, `sup`,
`sup_min`, `group`, `layout`, `packed`, optionally `ggml_type`), so the port
never sees a JAX type. Layouts stay the reference's ("kn" QTensors,
layer-stacked). A `q` of dtype int4 (`np.asarray` of a JAX int4 array gives
ml_dtypes' int4, one value per byte) becomes the port's `int4` form: signed
nibbles, two per byte. Every other leaf (norms, biases, and a MoE layer's
router, its 3-D expert stacks [L, E, F, D] and its shared expert) becomes
a tensor of its own dtype."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ._device import resolve_device
from .quant.qtensor import Q4_K, QTensor, pack_int4

_QT_ARRAYS = ("q", "scale", "bias", "sup", "sup_min")


def tensor_from_numpy(a, device) -> torch.Tensor:
    """np array (bfloat16 and int4 included, as ml_dtypes gives them; int4
    becomes int8) -> torch tensor."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype.name == "int4":
        a = a.astype(np.int8)
    return torch.from_numpy(a).to(device)


def is_qtensor_dict(d) -> bool:
    return isinstance(d, dict) and "q" in d and "group" in d


def params_from_numpy(tree: Any, device="cuda") -> Any:
    dev = resolve_device(device)
    if is_qtensor_dict(tree):
        arrays = {k: None if tree.get(k) is None else tensor_from_numpy(tree[k], dev)
                  for k in _QT_ARRAYS}
        group, layout = int(tree["group"]), str(tree.get("layout", "nk"))
        int4 = np.asarray(tree["q"]).dtype.name == "int4"
        if int4:
            if layout != "kn":
                raise NotImplementedError("int4 QTensors are 'kn' only")
            arrays["q"] = pack_int4(arrays["q"], group)
        return QTensor(
            **arrays, group=group, layout=layout, packed=bool(tree.get("packed", False)),
            ggml_type=int(tree.get("ggml_type", Q4_K)), int4=int4,
        )
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev) for v in tree)
    if tree is None:
        return None
    return tensor_from_numpy(tree, dev)
