"""High-level engine API: load a GGUF target (and an EAGLE draft), tokenize,
generate, chat, embed (port of eagle_tpu/api.py: `EngineConfig`, `Engine`
with its load, tokenizer and engine choice, `_plain_generator`,
`chat_session`, `generate_text` with prompt-cache sessions, `infill`,
`rerank` and `embed` for llama targets).

One object owns the target (+ draft) params on the device, the tokenizer
from the target's metadata and the engine: `Generator` without a draft,
else `EagleChainEngine`, `EagleTreeEngine` (`tree_branching`) or
`EagleTree2Engine` (`tree2`); with `lookahead` and no draft a
`LookaheadEngine` (the draft takes precedence, as in the reference). With
`batch` > 1 and a chain draft it also owns a `ContinuousBatcher` over a
chain engine of `batch` rows, or with
`paged` a `PagedBatcher` over a pool of `kv_pages` pages of `page_size`
rows, as the reference (the tree engines and `Generator` take no batch
there either). The caches are bf16, f32 or int8 (`kv_dtype`).
A chat session and the embeddings run on a plain `Generator`'s forward
over the same target params, as the reference's. It runs on the card
unless `device="cpu"`. `generate_text` takes a GBNF grammar or a JSON
schema: a chain engine of batch 1 speculates under it
(`EagleChainEngine.generate_constrained`), any other runs the plain
constrained generator. A stateful sampler (penalties, DRY, mirostat) runs
on a plain `Generator` and in chat; with a draft, or with a grammar, the
reference drops its state, and the port refuses it
(`sampling.DroppedSamplerState`). Lookahead decoding is greedy: the
reference ignores the sampler there, and the port refuses a sampled one
(`sampling.SamplerIgnored`). `infill` fills in the middle with the
reference's infill sampler on the host, one graphed forward per token of
a plain `Generator`. What the port lacks raises NotImplementedError naming
its ROADMAP item."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ._device import resolve_device
from .gguf import GGUFReader, Keys
from .models.config import TARGET_ARCHS
from .models.loader import load_eagle_params, load_llama_params
from .quant.serving import prepare_params_for_serving
from .models.llama import llama_forward
from .runtime.generate import Generator, pad_bucket
from .runtime.kvcache import KVCache, causal_mask_from_tags
from .runtime.lookahead import LookaheadEngine
from .runtime.sampling import SamplerConfig, refuse_dropped_state, refuse_sampled
from .runtime.paged_batcher import PagedBatcher
from .runtime.scheduler import ContinuousBatcher
from .runtime.speculative import EagleChainEngine
from .runtime.tree import EagleTreeEngine, TreeSpec
from .runtime.tree2 import EagleTree2Engine
from .tokenizer import tokenizer_from_gguf_metadata

_ITEM8 = "ROADMAP queue 1, item 8"


@dataclasses.dataclass
class EngineConfig:
    model_path: str | Path = ""
    draft_path: str | Path | None = None  # EAGLE gguf
    lora_path: str | Path | None = None  # not ported (ROADMAP queue 1, item 9)
    lora_scale: float | None = None
    max_seq: int = 2048
    batch: int = 1  # > 1 with a chain draft: continuous-batching slots
    n_draft: int = 5  # chain draft length
    #: speculative cycles chained per dispatch (one CUDA graph replay on the
    #: card); applied to the chain and EAGLE-2 engines, as in the reference
    cycles_per_dispatch: int = 1
    tree_branching: tuple[int, ...] | None = None  # static tree mode
    tree2: tuple[int, int, int] | None = None  # (beam, depth, n_verify): EAGLE-2
    lookahead: tuple[int, int, int] | None = None  # (W, N, G): model-free lookahead decoding
    compute_dtype: Any = torch.bfloat16
    kv_dtype: Any = torch.bfloat16
    feature_source: str = "pre_norm"
    sampler: SamplerConfig = dataclasses.field(default_factory=lambda: SamplerConfig(greedy=True))
    #: serving scale stream: "f32" (ggml's exact products) or "bf16"
    scale_mode: str = "f32"
    paged: bool = False  # batch > 1: serve from a shared page pool with prefix reuse
    kv_pages: int | None = None  # pool pages (default batch * pages per slot)
    page_size: int = 64
    device: Any = "cuda"


def _refuse(cfg: EngineConfig) -> None:
    if cfg.lora_path or cfg.lora_scale is not None:
        raise NotImplementedError("LoRA adapters are not ported yet (ROADMAP queue 1, item 9)")
    if cfg.draft_path:
        refuse_dropped_state(cfg.sampler, "a speculative engine")
    elif cfg.lookahead:
        refuse_sampled(cfg.sampler, "lookahead decoding")


class Engine:
    def __init__(self, cfg: EngineConfig):
        _refuse(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        with GGUFReader(cfg.model_path) as reader:
            arch = reader.metadata.get(Keys.General.ARCHITECTURE)
        if arch not in TARGET_ARCHS:  # recurrent and every other architecture
            raise NotImplementedError(f"architecture {arch!r} is not ported yet ({_ITEM8}); "
                                      f"the port loads {', '.join(TARGET_ARCHS)} targets")
        # the dense MoE weights are stored in the compute dtype they are read in
        self.params, self.model_cfg, self.metadata = load_llama_params(
            cfg.model_path, device=self.device, dense_dtype=cfg.compute_dtype)
        self.params = prepare_params_for_serving(self.params, scale_mode=cfg.scale_mode)
        self.tokenizer = tokenizer_from_gguf_metadata(self.metadata)
        self.draft_params = self.draft_cfg = None
        if cfg.draft_path:
            self.draft_params, self.draft_cfg, _ = load_eagle_params(cfg.draft_path,
                                                                     device=self.device)
            self.draft_params = prepare_params_for_serving(self.draft_params,
                                                           scale_mode=cfg.scale_mode)
        self.engine = self.make_engine()
        self.batcher = None
        if cfg.batch > 1 and type(self.engine) is EagleChainEngine:
            if cfg.paged:
                mp = -(-cfg.max_seq // cfg.page_size)
                self.batcher = PagedBatcher(self.engine, n_pages=cfg.kv_pages or cfg.batch * mp,
                                            page_size=cfg.page_size)
            else:
                self.batcher = ContinuousBatcher(self.engine)

    def _engine_kw(self) -> dict:
        c = self.cfg
        return dict(max_seq=c.max_seq, compute_dtype=c.compute_dtype, kv_dtype=c.kv_dtype,
                    eos_id=self.tokenizer.eos_id, device=self.device)

    def make_engine(self, kind: str | None = None, sampler: SamplerConfig | None = None):
        """An engine over the loaded params: "plain" (`Generator`),
        "lookahead" (the config's `lookahead` (W, N, G), else the reference's
        default (8, 4, 8)), "chain", "tree" (the config's `tree_branching`,
        else the reference's default (4, 2, 2)) or "tree2" (the config's
        `tree2`, else beam 8, depth 6, 32 verify rows). By default the
        config's choice: without a draft "lookahead" or "plain", else
        "tree2", "tree" or "chain". Another sampler or engine kind over the
        same params costs no load."""
        c = self.cfg
        if kind is None:
            kind = (("lookahead" if c.lookahead else "plain") if self.draft_params is None
                    else "tree2" if c.tree2 else "tree" if c.tree_branching else "chain")
        kw = self._engine_kw()
        if kind == "plain":
            return Generator(self.params, self.model_cfg, **kw)
        if kind == "lookahead":
            w, n, g = c.lookahead or (8, 4, 8)
            return LookaheadEngine(self.params, self.model_cfg, W=w, N=n, G=g, **kw)
        if self.draft_params is None:
            raise ValueError(f"a {kind!r} engine needs a draft (draft_path)")
        spec = (self.params, self.draft_params, self.model_cfg, self.draft_cfg)
        kw.update(feature_source=c.feature_source, sampler=sampler or c.sampler)
        if kind == "tree2":
            bm, dpt, nv = c.tree2 or (8, 6, 32)
            eng = EagleTree2Engine(*spec, beam=bm, depth=dpt, n_verify=nv, **kw)
        elif kind == "tree":
            eng = EagleTreeEngine(*spec, tree=TreeSpec(c.tree_branching or (4, 2, 2)), **kw)
        elif kind == "chain":
            eng = EagleChainEngine(*spec, n_draft=c.n_draft, batch=c.batch, **kw)
        else:
            raise ValueError(f"engine kind {kind!r}")
        if c.cycles_per_dispatch > 1 and kind != "tree":  # as the reference: not the static tree
            eng.cycles_per_dispatch = int(c.cycles_per_dispatch)
        return eng

    def _plain_generator(self) -> Generator:
        """A non-speculative generator over the same target params."""
        if not hasattr(self, "_plain"):
            self._plain = self.make_engine("plain")
        return self._plain

    def generate_text(
        self,
        prompt: str,
        max_new_tokens: int = 256,
        sampler: SamplerConfig | None = None,
        seed: int = 0,
        grammar: str | None = None,
        json_schema: dict | str | None = None,
        session_path: str | None = None,
        session_cache_all: bool = False,
    ) -> tuple[str, dict]:
        """(text, stats) for `prompt`. A speculative engine samples with the
        config's sampler (`sampler` is for `Generator`, as in the reference);
        stats holds the speculative counts. With `session_path` the prompt
        runs on a plain `Generator` (the reference's main.cpp is not
        speculative), reusing and then rewriting the session file's cached
        prefix; stats holds `session_prefix_reused`. An engine whose state
        is a page pool generates through its `PagedBatcher`.

        With `grammar` (GBNF) or `json_schema` (a dict or its JSON text) the
        output is constrained: a chain engine speculates under the grammar
        (greedy, stats with `constrained` and the cycle counts), a tree
        engine or no draft runs the plain generator's constrained path with
        `sampler` (stats `{"constrained": True}`). A lookahead engine
        decodes greedily and refuses a sampled `sampler`; its stats are the
        reference's `n_steps`, `n_predict`, `n_accept`, `tokens_per_step`."""
        ids = self.tokenizer.encode(prompt)
        sampler = sampler or self.cfg.sampler
        if isinstance(self.engine, LookaheadEngine) and not (session_path or grammar
                                                             or json_schema):
            refuse_sampled(sampler, "lookahead decoding")
        if grammar or json_schema:
            return self._generate_constrained(ids, grammar, json_schema, max_new_tokens,
                                              sampler, seed)
        if session_path or isinstance(self.engine, Generator):
            gen = self.engine if isinstance(self.engine, Generator) else self._plain_generator()
            out = gen.generate(ids, max_new_tokens=max_new_tokens, sampler=sampler, seed=seed,
                               session_path=session_path, session_cache_all=session_cache_all)
            stats: dict = ({"session_prefix_reused": gen.session_prefix_reused}
                           if session_path else {})
        elif isinstance(self.batcher, PagedBatcher):
            slot = self.batcher.submit(ids, max_new_tokens=max_new_tokens)
            if slot is None:
                raise RuntimeError("every slot of the paged batcher is busy")
            self.batcher.run_until_done()
            out, stats = list(slot.generated), {}
        else:
            out, stats = self.engine.generate(ids, max_new_tokens=max_new_tokens, seed=seed)
        text = self.tokenizer.decode([t for t in out if t != self.tokenizer.eos_id],
                                     skip_special=True)
        return text, stats

    def _generate_constrained(self, ids, grammar, json_schema, max_new_tokens, sampler,
                              seed) -> tuple[str, dict]:
        from .runtime.grammar import Grammar
        from .runtime.json_schema import json_schema_to_gbnf

        refuse_dropped_state(sampler, "grammar-constrained generation")
        g = Grammar(grammar or json_schema_to_gbnf(json_schema))
        # a tree engine's K counts its tree's nodes, not a chain's drafts:
        # it runs the plain constrained path
        if type(self.engine) is EagleChainEngine:
            out, stats = self.engine.generate_constrained(ids, g, self.tokenizer,
                                                          max_new_tokens=max_new_tokens,
                                                          seed=seed)
        else:
            gen = self.engine if isinstance(self.engine, Generator) else self._plain_generator()
            out = gen.generate_constrained(ids, g, self.tokenizer, max_new_tokens=max_new_tokens,
                                           sampler=sampler, seed=seed)
            stats = {"constrained": True}
        text = self.tokenizer.decode([t for t in out if t != self.tokenizer.eos_id],
                                     skip_special=True)
        return text, stats

    def chat_session(self, system: str | None = None, template: str | None = None,
                     use_jinja: bool = False):
        """Multi-turn chat with the cache kept across turns (llama-cli's
        conversation mode), non-speculative as the reference's: on the
        engine itself when it is a `Generator`, else on a plain one over the
        same target params. The template defaults to the GGUF's own."""
        from .runtime.chat import ChatSession

        gen = self.engine if isinstance(self.engine, Generator) else self._plain_generator()
        return ChatSession(gen, self.tokenizer, template=template,
                           jinja_src=self.metadata.get("tokenizer.chat_template"),
                           use_jinja=use_jinja, system=system)

    def infill(self, input_prefix: str, input_suffix: str, max_new_tokens: int = 128,
               spm_infill: bool = False, seed: int = 0, top_k: int = 64) -> str:
        """Fill-in-the-middle completion (examples/infill and the server's
        /infill): the prompt [FIM_PRE] prefix [FIM_SUF] suffix [FIM_MID]
        (the suffix first with `spm_infill`) through a plain `Generator`'s
        prefill, then each token's logits from its graphed one-token
        forward (`_constrained_step`); on the host, the top `top_k`
        candidates of the softmax go through the reference's infill sampler
        (`infill_filter`), and the token is the argmax of the filtered
        probabilities for a greedy config, else a draw from numpy's
        `default_rng(seed)`, as the reference. An end-of-generation token
        (EOS or the GGUF's EOT) ends it. A vocabulary without FIM tokens
        raises ValueError."""
        from .runtime.infill import fim_tokens_from_metadata, format_infill, infill_filter

        mc, tok = self.model_cfg, self.tokenizer
        pieces = [tok.piece(i) for i in range(mc.vocab_size)]
        fim = fim_tokens_from_metadata(self.metadata, pieces)
        if fim is None:
            raise ValueError("model vocab has no FIM tokens — cannot infill")
        ids = format_infill(tok.encode(input_prefix, add_bos=False),
                            tok.encode(input_suffix, add_bos=False), fim,
                            spm_infill=spm_infill, bos_id=tok.bos_id,
                            add_bos=getattr(tok, "add_bos", False))
        is_eog = np.zeros(mc.vocab_size, bool)
        if tok.eos_id >= 0:
            is_eog[tok.eos_id] = True
        eot = self.metadata.get("tokenizer.ggml.eot_token_id")
        eot_id = int(eot) if eot is not None else tok.eos_id
        if eot is not None:
            is_eog[int(eot)] = True

        gen = self.engine if isinstance(self.engine, Generator) else self._plain_generator()
        gen.kv.rollback(torch.zeros((gen.batch,), dtype=torch.int32, device=self.device))
        logits = gen._prompt(np.asarray(ids, np.int32), None)
        rng = np.random.default_rng(seed)
        out: list[int] = []
        pos = len(ids)
        for _ in range(max_new_tokens):
            lg = logits[0].cpu().numpy()
            p = np.exp(lg - lg.max())
            p /= p.sum()
            cand = np.argsort(-p)[:top_k]
            f_ids, f_p = infill_filter(cand, p[cand], pieces, is_eog, eot_id)
            nxt = int(f_ids[int(np.argmax(f_p))]) if self.cfg.sampler.greedy else int(
                rng.choice(f_ids, p=f_p / f_p.sum()))
            if is_eog[nxt]:
                break
            out.append(nxt)
            if pos + 1 >= self.cfg.max_seq:
                break
            logits = gen._constrained_step(nxt, pos)
            pos += 1
        return tok.decode(out, skip_special=True)

    def rerank(self, query: str, documents: list[str]) -> list[float]:
        """Relevance scores query -> documents: the cosine of their
        embeddings, the reference's fallback for a causal model without a
        classification head. A head (`cls` tensors, which come with the
        bert family) is not ported."""
        if self.params.get("cls") is not None:
            raise NotImplementedError(f"the rank-pooling classification head (cls) comes with "
                                      f"the bert family, not ported yet ({_ITEM8})")
        qv = self.embed([query])[0]
        return [float(np.dot(qv, dv)) for dv in self.embed(documents)]

    def embed(self, texts: list[str], pooling: str = "mean", normalize: bool = True):
        """Sequence embeddings (llama-embedding): the pooled final-norm
        hidden states of one forward over a fresh cache of the padded
        length, pooling "mean" or "last", as f32 numpy vectors."""
        mc = self.model_cfg
        if mc.arch in ("bert", "nomic-bert"):
            raise NotImplementedError(f"encoder embedding models ({mc.arch}) are not ported "
                                      f"yet ({_ITEM8})")
        out = []
        for text in texts:
            ids = self.tokenizer.encode(text)
            n, t = len(ids), pad_bucket(len(ids))
            padded = torch.zeros((1, t), dtype=torch.int32)
            padded[0, :n] = torch.tensor(ids, dtype=torch.int32)
            kv = KVCache.create(mc.n_layers, 1, t, mc.n_kv_heads, mc.head_dim,
                                dtype=self.cfg.kv_dtype, device=self.device)
            pos = torch.arange(t, dtype=torch.int32, device=self.device)[None, :]
            kv.with_tags(pos, pos, valid=pos < n)
            mask = causal_mask_from_tags(kv.slot_pos, pos)
            fo = llama_forward(self.params, mc, padded.to(self.device), pos, kv, pos, mask,
                               compute_dtype=self.cfg.compute_dtype, return_logits=False)
            h = fo.hidden[0, :n].float().cpu().numpy()
            v = h.mean(0) if pooling == "mean" else h[-1]
            if normalize:
                v = v / (np.linalg.norm(v) + 1e-9)
            out.append(v.astype(np.float32))
        return out
