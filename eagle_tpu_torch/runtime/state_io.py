"""Engine state files (port of eagle_tpu/runtime/state_io.py: `save_state`,
`load_state`, `extract_seq_state`, `insert_seq_state`, `save_seq_state`,
`load_seq_state` and the prompt-cache sessions `save_prompt_session`,
`load_prompt_session`, `session_prefix_len`, `insert_session_kv`).

Files are numpy archives with a JSON header (`__meta__`). A bfloat16 array
is stored as its bytes (uint8, the last axis doubled) with the dtype's name
beside it, as the reference stores it; the port reads and writes those
bytes through `torch.Tensor.view`, with no `ml_dtypes`.

- **State files** (`save_state`, slot files): named arrays ("tgt_kv.k",
  "n_past", ...) under the port's own magic. The reference's state files
  are its pytree's leaves in JAX's flattening order, which the port cannot
  reproduce: `load_state` refuses one with a clear error.
- **Per-sequence files** (`save_seq_state`, the batchers' `save_slot`): one
  row as a dense B = 1 state over the rows it has written, [0, n) with n
  one past its highest tagged slot. A row of a dense cache and a row of a
  page pool save the same file, so either restores into either
  (`read_seq_state` + `insert_seq_state`). The draws' stream is the
  engine's, shared by the rows: it is neither saved nor restored with a
  row, as in the reference.
- **Prompt sessions** (the CLI's --prompt-cache): the reference's format,
  so session files interchange with it both ways.

Loading writes into the caller's tensors in place (the port's caches keep
their pointers, so graphs over them stay valid)."""

from __future__ import annotations

import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import torch

from .kvcache import KVCache
from .paged_kv import PagedKVCache
from .sampling import CounterRNG
from .speculative import SpecState

MAGIC = "eagle_tpu_torch_state_v1"
REFERENCE_MAGIC = "eagle_tpu_state_v1"
SESSION_MAGIC = "eagle_tpu_session_v1"

_NATIVE = {torch.float32: np.float32, torch.float16: np.float16, torch.int8: np.int8,
           torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}
_BY_NAME = {"bfloat16": torch.bfloat16, **{np.dtype(v).name: k for k, v in _NATIVE.items()}}


def _pack(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """An npz-safe array of `t` and its dtype's name: bfloat16 as uint8 bytes."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint8).numpy(), "bfloat16"
    return t.numpy(), np.dtype(_NATIVE[t.dtype]).name


def _unpack(a: np.ndarray, name: str) -> torch.Tensor:
    t = torch.from_numpy(a if a.flags.c_contiguous and a.flags.writeable else a.copy())
    want = _BY_NAME.get(name)
    if want is None:
        raise ValueError(f"array dtype {name!r} is not one the port reads")
    return t if t.dtype == want else t.view(want)


def _write(path, arrays: dict[str, torch.Tensor], meta: dict) -> None:
    packed, dtypes = {}, {}
    for name, t in arrays.items():
        packed[name], dtypes[name] = _pack(t)
    meta = {**meta, "dtypes": dtypes}
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **packed)
    Path(path).write_bytes(buf.getvalue())


def _read(path) -> tuple[dict[str, torch.Tensor], dict]:
    """(arrays, meta) of a port state file; refuses anything else."""
    with np.load(io.BytesIO(Path(path).read_bytes()), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("magic") == REFERENCE_MAGIC:
            raise ValueError(f"{path}: a state file of the reference (JAX) package: its arrays "
                             "are the leaves of a JAX pytree in JAX's flattening order, which "
                             "the port does not read; save the state with the port")
        if meta.get("magic") != MAGIC:
            raise ValueError(f"{path}: not an eagle_tpu_torch state file")
        dtypes = meta.get("dtypes", {})
        arrays = {n: _unpack(z[n], dtypes.get(n, z[n].dtype.name))
                  for n in z.files if n != "__meta__"}
    return arrays, meta


# ---------------------------------------------------------------------------
# whole states


def _named(obj, prefix: str = "") -> dict[str, torch.Tensor]:
    """The tensors of a state, cache or RNG by dotted field name."""
    if isinstance(obj, torch.Tensor):
        return {prefix[:-1]: obj}
    if isinstance(obj, CounterRNG):
        return {f"{prefix}seed": obj.seed, f"{prefix}counter": obj.counter}
    if dataclasses.is_dataclass(obj):
        out: dict = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, (torch.Tensor, CounterRNG)) or dataclasses.is_dataclass(v):
                out.update(_named(v, f"{prefix}{f.name}."))
        return out
    raise TypeError(f"cannot save a {type(obj).__name__}")


def save_state(state, path, extra: dict | None = None) -> None:
    """Write a state (`SpecState`, `KVCache`, `PagedKVCache`) to `path`:
    every tensor by name, the type's name and `extra` in the header."""
    meta: dict = {"magic": MAGIC, "kind": "state", "type": type(state).__name__}
    if extra:
        meta["extra"] = extra
    _write(path, _named(state), meta)


def load_state(template, path):
    """Fill `template` (a state of the saved one's type and shapes, e.g. an
    engine's state) in place from `path`. Returns (template, extra)."""
    arrays, meta = _read(path)
    if meta.get("kind") != "state" or meta.get("type") != type(template).__name__:
        raise ValueError(f"{path}: holds a {meta.get('kind')} of {meta.get('type')}, not a "
                         f"{type(template).__name__}")
    want = _named(template)
    if set(arrays) != set(want):
        raise ValueError(f"{path}: arrays {sorted(arrays)} != the template's {sorted(want)}")
    for name, t in want.items():
        a = arrays[name]
        if tuple(a.shape) != tuple(t.shape) or a.dtype != t.dtype:
            raise ValueError(f"{path}: {name} is {a.dtype} {tuple(a.shape)}, the template's "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in want.items():
        t.copy_(arrays[name])
    return template, meta.get("extra", {})


# ---------------------------------------------------------------------------
# one sequence


def _written(slot_pos: torch.Tensor, limit: int) -> int:
    """One past the highest tagged slot of a [S] tag row below `limit`."""
    live = torch.nonzero(slot_pos[:limit] >= 0)
    return int(live.max()) + 1 if live.numel() else 0


def _row_rows(kv, slot: int, n: int) -> dict[str, torch.Tensor]:
    """Cache rows [0, n) of batch row `slot` as dense B = 1 tensors
    (k/v [L, 1, H, n, D], scales [L, 1, H, n]): a dense cache's slice, a
    pool's mapped pages gathered."""
    fields = {"k": kv.k, "v": kv.v, "k_scale": kv.k_scale, "v_scale": kv.v_scale}
    out = {}
    for name, t in fields.items():
        if t is None:
            continue
        if isinstance(kv, PagedKVCache):
            n_pg = -(-n // kv.page_size)
            pt = kv.page_table[slot, :n_pg].clamp(min=0).long()
            g = t[:, pt]  # [L, NP, H, page(, D)]
            g = g.transpose(1, 2).reshape(g.shape[0], g.shape[2], n_pg * kv.page_size,
                                          *g.shape[4:])
            out[name] = g[:, None, :, :n].clone()
        else:
            out[name] = t[:, slot:slot + 1, :, :n].clone()
    return out


def extract_seq_state(state: SpecState, slot: int) -> SpecState:
    """Batch row `slot` of a dense or paged state as a B = 1 dense state
    over the cache rows it has written (each cache's [0, n), n one past its
    highest tagged slot): copies, with the state's RNG."""
    def cache(kv) -> KVCache:
        n = _written(kv.slot_pos[slot], kv.max_seq)
        r = _row_rows(kv, slot, n)
        return KVCache(k=r["k"], v=r["v"], slot_pos=kv.slot_pos[slot:slot + 1, :n].clone(),
                       k_scale=r.get("k_scale"), v_scale=r.get("v_scale"))

    return SpecState(tgt_kv=cache(state.tgt_kv), dft_kv=cache(state.dft_kv),
                     last_token=state.last_token[slot:slot + 1].clone(),
                     feature=state.feature[slot:slot + 1].clone(),
                     n_past=state.n_past[slot:slot + 1].clone(), rng=state.rng)


def _check_fits(kv, sub: KVCache, what: str) -> None:
    l, h, d = kv.k.shape[0], kv.k.shape[2], kv.k.shape[-1]
    got = (sub.k.shape[0], sub.k.shape[2], sub.k.shape[-1])
    if got != (l, h, d) or sub.k.dtype != kv.k.dtype or sub.quantized != kv.quantized:
        raise ValueError(f"{what}: a saved {sub.k.dtype} cache of (layers, kv heads, head dim) "
                         f"{got} does not fit a {kv.k.dtype} cache of {(l, h, d)}")
    if sub.k.shape[3] > kv.max_seq:
        raise ValueError(f"{what}: {sub.k.shape[3]} saved rows do not fit {kv.max_seq} slots")


def insert_seq_state(state: SpecState, sub: SpecState, slot: int) -> SpecState:
    """Write a B = 1 dense state (`extract_seq_state`, `read_seq_state`)
    into batch row `slot`, in place: its cache rows [0, n) and tags, empty
    tags (and zero rows) above, its last token, feature and n_past. A page
    pool's row must already map pages over [0, n) (the paged batcher maps
    them)."""
    for name in ("tgt_kv", "dft_kv"):
        kv, row = getattr(state, name), getattr(sub, name)
        _check_fits(kv, row, name)
        n = row.k.shape[3]
        tags = torch.full_like(kv.slot_pos[slot], -1)
        tags[:n] = row.slot_pos[0].to(tags.device)
        kv.slot_pos[slot].copy_(tags)
        fields = {"k": (kv.k, row.k), "v": (kv.v, row.v),
                  "k_scale": (kv.k_scale, row.k_scale), "v_scale": (kv.v_scale, row.v_scale)}
        for dst, src in fields.values():
            if dst is None:
                continue
            src = src[:, 0].to(dst.device)  # [L, H, n(, D)]
            if isinstance(kv, PagedKVCache):
                ps = kv.page_size
                n_pg = -(-n // ps)
                if n_pg == 0:
                    continue
                pt = kv.page_table[slot, :n_pg].long()
                if bool((pt < 0).any()):
                    raise ValueError(f"{name}: row {slot} maps no page over its {n} rows")
                pad = torch.zeros(src.shape[:2] + (n_pg * ps - n,) + src.shape[3:],
                                  dtype=src.dtype, device=src.device)
                pages = torch.cat([src, pad], dim=2).reshape(
                    src.shape[0], src.shape[1], n_pg, ps, *src.shape[3:]).transpose(1, 2)
                dst[:, pt] = pages
            else:
                dst[:, slot, :, :n] = src
                dst[:, slot, :, n:] = 0
    state.last_token[slot] = sub.last_token[0]
    state.feature[slot] = sub.feature[0]
    state.n_past[slot] = sub.n_past[0]
    return state


def save_seq_state(state: SpecState, slot: int, path, extra: dict | None = None) -> None:
    """Write batch row `slot` of a dense or paged state to `path` as a
    per-sequence file (the server's slot save)."""
    sub = extract_seq_state(state, slot)
    arrays = {k: v for k, v in _named(sub).items() if not k.startswith("rng.")}
    meta: dict = {"magic": MAGIC, "kind": "seq", "type": "SpecState"}
    if extra:
        meta["extra"] = extra
    _write(path, arrays, meta)


def read_seq_state(path, device="cpu") -> tuple[SpecState, dict]:
    """A per-sequence file as a B = 1 dense state on `device` (its RNG a
    fresh one: a row's file carries none) and the file's extra metadata."""
    arrays, meta = _read(path)
    if meta.get("kind") != "seq":
        raise ValueError(f"{path}: not a per-sequence state file")
    a = {k: v.to(device) for k, v in arrays.items()}

    def cache(p) -> KVCache:
        return KVCache(k=a[f"{p}.k"], v=a[f"{p}.v"], slot_pos=a[f"{p}.slot_pos"],
                       k_scale=a.get(f"{p}.k_scale"), v_scale=a.get(f"{p}.v_scale"))

    sub = SpecState(tgt_kv=cache("tgt_kv"), dft_kv=cache("dft_kv"), last_token=a["last_token"],
                    feature=a["feature"], n_past=a["n_past"], rng=CounterRNG(device=device))
    return sub, meta.get("extra", {})


def load_seq_state(state: SpecState, slot: int, path):
    """Restore a per-sequence file into batch row `slot` of a dense state
    (or of a pool whose row maps the pages). Returns (state, extra)."""
    sub, extra = read_seq_state(path, state.last_token.device)
    if sub.feature.shape[1:] != state.feature.shape[1:]:
        raise ValueError(f"{path}: a feature of {tuple(sub.feature.shape[1:])}, not "
                         f"{tuple(state.feature.shape[1:])}")
    return insert_seq_state(state, sub, slot), extra


# ---------------------------------------------------------------------------
# CLI prompt-cache sessions (main.cpp:235-253 --prompt-cache): the tokens and
# the KV rows they produced, matched next run by longest token prefix


def save_prompt_session(path, tokens, kv: KVCache, end: int) -> None:
    """Persist `tokens[:end]` and their KV rows (cache slots [0, end)), in
    the reference's session format."""
    end = int(min(end, kv.max_seq, len(tokens)))
    raw = {"tokens": torch.tensor([int(t) for t in tokens[:end]], dtype=torch.int32),
           "k": kv.k[:, :, :, :end], "v": kv.v[:, :, :, :end],
           "slot_pos": kv.slot_pos[:, :end]}
    if kv.quantized:
        raw["k_scale"] = kv.k_scale[:, :, :, :end]
        raw["v_scale"] = kv.v_scale[:, :, :, :end]
    _write(path, raw, {"magic": SESSION_MAGIC, "end": end})


def load_prompt_session(path, kv_template: KVCache):
    """(tokens, arrays) of a session file, or None when it is absent,
    malformed, or shaped for another model or cache dtype (the reference
    starts afresh on a bad session rather than failing the run)."""
    p = Path(path)
    if not p.exists() or p.stat().st_size == 0:
        return None
    try:
        with np.load(io.BytesIO(p.read_bytes()), allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"]))
            if meta.get("magic") != SESSION_MAGIC:
                return None
            dtypes = meta.get("dtypes", {})
            arrs = {n: _unpack(z[n], dtypes.get(n, z[n].dtype.name))
                    for n in z.files if n != "__meta__"}
        k, ref = arrs["k"], kv_template.k
        if (k.shape[:3] != ref.shape[:3] or k.shape[4:] != ref.shape[4:]
                or k.dtype != ref.dtype or ("k_scale" in arrs) != kv_template.quantized):
            return None
        return arrs["tokens"].tolist(), arrs
    except Exception:
        return None


def session_prefix_len(session_tokens, prompt) -> int:
    """Longest common prefix (main.cpp:312-318's matching walk)."""
    n = 0
    for a, b in zip(session_tokens, prompt):
        if int(a) != int(b):
            break
        n += 1
    return n


def insert_session_kv(kv: KVCache, arrs: dict, n: int) -> KVCache:
    """Place a session's first `n` KV rows and tags into the cache, in place;
    rows >= n keep their tags."""
    n = int(min(n, arrs["k"].shape[3], kv.max_seq))
    for name, dst in (("k", kv.k), ("v", kv.v), ("k_scale", kv.k_scale),
                      ("v_scale", kv.v_scale)):
        if dst is not None:
            dst[:, :, :, :n] = arrs[name][:, :, :, :n].to(dst.device)
    kv.slot_pos[:, :n] = arrs["slot_pos"][:, :n].to(kv.slot_pos.device)
    return kv
