"""Model hyperparameters (the fields of eagle_tpu's `ModelConfig` that the
ported block reads, with the same names and defaults), and
`ModelConfig.from_gguf_metadata` for the llama, EAGLE, Qwen2, Qwen3, Gemma,
Gemma-2, Mixtral, Qwen2-MoE, Phi-2, StarCoder2, StableLM, GPT-NeoX,
Command-R, Nemotron, OLMo, Orion, CodeShell, Falcon, GPT-J, GPT-2,
StarCoder, BLOOM, MPT, Refact and JAIS architectures.

The ported block is the pre-norm llama block and its config-driven
branches: qkv biases (qwen2), per-head q/k RMSNorm (qwen3), sandwich norms,
GELU and the embedding scale (gemma, gemma2), `query_pre_attn_scalar`, the
attention and final softcaps and the alternating sliding window (gemma2);
LayerNorm with biases, the parallel residual, partial rotary and the
logit scale (phi2, starcoder2, stablelm, gptneox, command-r, falcon,
gptj, codeshell, orion); the squared ReLU (nemotron), the non-parametric
LayerNorm and the q/k/v clamp (olmo; the clamp also mpt); no rotary at
all, with learned absolute positions (gpt2, starcoder) or ALiBi (bloom,
mpt, refact, jais), the embedding LayerNorm (bloom), the gated FFN's
biases and the 1 / head_dim score scale (jais); the mixture-of-experts
FFN of Mixtral (a llama file with `expert_count`, or the `mixtral`
architecture: softmax over the top k) and Qwen2-MoE (softmax over every
expert, the rest zeroed, and a shared expert under a sigmoid gate).
Fields of other
architectures are kept at their defaults so that a config carried across
from the reference can be checked: `check_ported` raises on any setting the
port does not implement."""

from __future__ import annotations

import dataclasses
from typing import Any

from ..gguf.constants import Keys

#: the rotary LayerNorm families: mean-subtracted LayerNorm (with biases
#: where the file has them, none at all for olmo) and no learned positions
#: or ALiBi
LAYERNORM_TARGETS = ("phi2", "starcoder2", "stablelm", "gptneox", "command-r", "nemotron",
                     "olmo", "orion", "codeshell", "falcon", "gptj")
#: the architectures without rotary positions (a copy of eagle_tpu/models/
#: config.py:NO_ROPE_ARCHS): learned absolute positions added to the token
#: embedding (POS_EMBD_ARCHS) or an ALiBi bias on the scores (ALIBI_ARCHS)
NO_ROPE_ARCHS = frozenset({"gpt2", "starcoder", "bloom", "mpt", "refact", "jais"})
POS_EMBD_ARCHS = frozenset({"gpt2", "starcoder"})
#: the reference's ALIBI_ARCHS less jina-bert-v2 (an encoder); Baichuan-13B,
#: which the reference also reads as ALiBi, stays refused
ALIBI_ARCHS = frozenset({"bloom", "mpt", "refact", "jais"})
#: the position families: LayerNorm but refact (RMSNorm)
POSITION_TARGETS = ("gpt2", "starcoder", "bloom", "mpt", "refact", "jais")
#: architectures on the mean-subtracted LayerNorm (the reference's
#: LAYERNORM_ARCHS among the ported ones)
LAYERNORM_ARCHS = frozenset(LAYERNORM_TARGETS) | {"gpt2", "starcoder", "bloom", "mpt", "jais"}
#: the mixture-of-experts targets: llama.cpp writes Mixtral as `llama` with
#: `llama.expert_count`, the reference's converter as `mixtral`
MOE_TARGETS = ("mixtral", "qwen2moe")
TARGET_ARCHS = (("llama", "qwen2", "qwen3", "gemma", "gemma2") + LAYERNORM_TARGETS
                + POSITION_TARGETS + MOE_TARGETS)
#: the architectures whose experts the port runs, and those among them
#: that route by a softmax over every expert (the reference's
#: `moe_softmax_all` archs that the port reads)
MOE_ARCHS = frozenset({"llama"} | set(MOE_TARGETS))
SOFTMAX_ALL_ARCHS = frozenset({"qwen2moe"})
#: GGUF architectures the port reads: the targets, and EAGLE drafts
GGUF_ARCHS = TARGET_ARCHS + ("eagle",)
#: the reference's GELU_ARCHS among the ported architectures (and the
#: Gemma family)
GELU_ARCHS = frozenset({"starcoder2", "phi2", "gptneox", "gpt2", "starcoder", "bloom", "mpt",
                        "falcon", "gptj", "codeshell"})
#: the reference's PARALLEL_BLOCK_ARCHS among the ported architectures: one
#: shared input norm feeds attention and the FFN, summed into the residual
PARALLEL_BLOCK_ARCHS = frozenset({"command-r", "phi2", "falcon", "gptj"})
#: the reference's NONPARAM_NORM_ARCHS: the block and final LayerNorms apply
#: with no weight and no bias, and the file has no norm tensors
NONPARAM_NORM_ARCHS = frozenset({"olmo"})
#: architectures whose q/k/v the reference clamps to +-clamp_kqv after the
#: projection: olmo (`attention.clamp_kqv`) and mpt (its `clip_qkv`)
CLAMP_KQV_ARCHS = frozenset({"olmo", "mpt"})

#: archs whose GGUF q/k rows carry convert_hf_to_gguf's adjacent-pair rope
#: permutation, which the loader inverts (a copy of eagle_tpu/models/config.py:
#: PERMUTED_ROPE_ARCHS). NEOX-rope archs (qwen*, gemma*, ...) store the rows
#: half-split already, as the runtime's rope takes them.
PERMUTED_ROPE_ARCHS = frozenset(
    {"llama", "mixtral", "eagle", "vicuna", "command-r", "granite", "olmo", "minicpm",
     "xverse", "baichuan", "orion", "internlm2", "plamo", "cohere2", "chatglm", "arctic",
     "deepseek", "deepseek2", "granitemoe", "chameleon", "deci"}
)

_ITEM8 = "ROADMAP queue 1, item 8"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "llama"
    vocab_size: int = 32000
    n_embd: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    head_dim: int = 128
    n_ff: int = 11008
    rms_eps: float = 1e-5
    rope_base: float = 10000.0
    rope_dim: int = 128  # rotary dims per head
    n_ctx_train: int = 2048
    rope_scaling: str | None = None
    rope_scale_factor: float = 1.0
    rope_orig_ctx: int = 0
    rope_attn_factor: float = 1.0
    # extrapolation mix: <0 = auto (1.0 when scaling type is yarn, else 0)
    rope_ext_factor: float = -1.0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_yarn_log_mul: float = 0.0
    # EAGLE draft head: one decoder layer fed by ReLU(FC([embed; hidden])),
    # no attn_norm / output_norm weight, lm_head borrowed from the target
    is_eagle: bool = False
    attn_bias: bool = False  # qwen2: q/k/v biases (the weights say whether they exist)
    swa_window: int = 0  # sliding-window attention; 0 = off
    #: layers the window applies to: every n-th from layer 0 (gemma2: 2)
    swa_every: int = 0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    post_norms: bool = False  # gemma2: post-attention / post-FFN (sandwich) norms
    embd_scale: float = 1.0
    # attention score scale override; None = 1/sqrt(head_dim)
    attn_scale: float | None = None
    act: str = "silu"
    norm_type: str = "rms"
    parallel_blocks: bool = False
    logit_scale: float = 1.0
    has_pos_embd: bool = False
    use_alibi: bool = False
    mrope_sections: tuple = ()
    head_counts: tuple = ()
    kv_head_counts: tuple = ()
    resid_scale: float = 1.0
    kv_lora_rank: int = 0
    v_head_dim: int = 0  # 0 = same as head_dim
    clamp_kqv: float = 0.0
    nonparam_norms: bool = False
    # MoE (the reference's names and defaults): experts, experts used per
    # token, the router's rule (softmax over the top k; over every expert,
    # the rest zeroed; phimoe's sparsemixer) and deepseek's fields
    n_expert: int = 0
    n_expert_used: int = 0
    moe_softmax_all: bool = False
    moe_sparsemixer: bool = False
    router_jitter: float = 0.01
    n_dense_layers: int = 0
    n_shared_experts: int = 0
    n_ff_exp: int = 0
    expert_weights_scale: float = 1.0
    expert_weights_norm: bool = False

    @property
    def v_dim(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def n_q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def n_kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @staticmethod
    def from_gguf_metadata(md: dict[str, Any]) -> "ModelConfig":
        """The config of a GGUF of `GGUF_ARCHS`, read as the reference reads
        it (eagle_tpu/models/config.py:173); any other architecture raises
        NotImplementedError."""
        arch = md[Keys.General.ARCHITECTURE]
        if arch not in GGUF_ARCHS:
            raise NotImplementedError(f"GGUF architecture {arch!r} is not ported yet ({_ITEM8})")
        if float(md.get(f"{arch}.attention.max_alibi_bias", 8.0) or 8.0) != 8.0:
            # the reference's slopes take ggml's default maximum bias of 8
            raise NotImplementedError(f"an ALiBi maximum bias other than 8 is not ported "
                                      f"yet ({_ITEM8})")

        def k(pattern: str, default=None):
            v = md.get(pattern.format(arch=arch), default)
            if v is None:
                raise KeyError(f"missing GGUF key {pattern.format(arch=arch)}")
            return v

        n_embd = int(k(Keys.LLM.EMBEDDING_LENGTH))
        n_heads = int(k(Keys.Attention.HEAD_COUNT))
        head_dim = int(k(Keys.Attention.KEY_LENGTH, n_embd // n_heads))
        vocab_size = md.get(Keys.LLM.VOCAB_SIZE.format(arch=arch))
        if vocab_size is None:
            vocab_size = len(md[Keys.Tokenizer.LIST])
        if md.get(f"{arch}.rope.scaling.yarn_log_multiplier"):  # deepseek2's MLA only
            raise NotImplementedError("YaRN's attention-scale multiplier (deepseek2's MLA) is "
                                      f"not ported yet ({_ITEM8})")
        if f"{arch}.attention.scale" in md:
            attn_scale = float(md[f"{arch}.attention.scale"])
        elif f"{arch}.attention.query_pre_attn_scalar" in md:
            attn_scale = float(md[f"{arch}.attention.query_pre_attn_scalar"]) ** -0.5
        else:  # jais: muP's 1 / d_head, hard-coded (the reference's build_jais)
            attn_scale = 1.0 / head_dim if arch == "jais" else None
        # keys the ported block does not implement are read all the same, so
        # that check_ported refuses such a file instead of ignoring them
        opt = lambda key, default: md.get(f"{arch}.{key}", default) or default
        gemma = arch.startswith("gemma")
        # LayerNorm archs store layer_norm_epsilon, RMSNorm archs
        # layer_norm_rms_epsilon (the reference's eps_key)
        layer = arch in LAYERNORM_ARCHS
        eps_key = Keys.Attention.LAYERNORM_EPS if layer else Keys.Attention.LAYERNORM_RMS_EPS
        return ModelConfig(
            arch=arch,
            vocab_size=int(vocab_size),
            n_embd=n_embd,
            n_layers=int(k(Keys.LLM.BLOCK_COUNT)),
            n_heads=n_heads,
            n_kv_heads=int(k(Keys.Attention.HEAD_COUNT_KV, n_heads)),
            head_dim=head_dim,
            n_ff=int(k(Keys.LLM.FEED_FORWARD_LENGTH)),
            rms_eps=float(k(eps_key, 1e-5)),
            rope_base=float(md.get(Keys.Rope.FREQ_BASE.format(arch=arch), 10000.0)),
            rope_dim=(0 if arch in NO_ROPE_ARCHS
                      else int(md.get(Keys.Rope.DIMENSION_COUNT.format(arch=arch), head_dim))),
            n_ctx_train=int(k(Keys.LLM.CONTEXT_LENGTH, 2048)),
            rope_scaling=md.get(Keys.Rope.SCALING_TYPE.format(arch=arch)),
            rope_scale_factor=float(md.get(Keys.Rope.SCALING_FACTOR.format(arch=arch), 1.0)),
            rope_orig_ctx=int(md.get(Keys.Rope.SCALING_ORIG_CTX.format(arch=arch), 0) or 0),
            rope_attn_factor=float(
                md.get(Keys.Rope.SCALING_ATTN_FACTOR.format(arch=arch), 1.0) or 1.0),
            is_eagle=(arch == "eagle"),
            attn_bias=(arch in ("qwen2", "qwen2moe", "starcoder2")),
            swa_window=int(opt("attention.sliding_window", 0)),
            swa_every=2 if arch == "gemma2" else 0,
            clamp_kqv=float(opt("attention.clamp_kqv", 0.0)),
            nonparam_norms=arch in NONPARAM_NORM_ARCHS,
            attn_softcap=float(opt("attn_logit_softcapping", 0.0)),
            final_softcap=float(opt("final_logit_softcapping", 0.0)),
            post_norms=(arch == "gemma2"),
            embd_scale=float(opt("embedding_scale", 0.0) or (n_embd ** 0.5 if gemma else 1.0)),
            attn_scale=attn_scale,
            # the reference's GELU_ARCHS and PARALLEL_BLOCK_ARCHS among the ported
            # archs; gptneox and stablelm opt in to the parallel residual per file
            act=("relu2" if arch == "nemotron"  # squared ReLU (build_nemotron)
                 else "gelu" if gemma or arch in GELU_ARCHS else "silu"),
            norm_type="layer" if layer else "rms",
            parallel_blocks=(arch in PARALLEL_BLOCK_ARCHS
                             or bool(opt("use_parallel_residual", False))),
            logit_scale=float(opt("logit_scale", 1.0)),
            resid_scale=float(opt("residual_scale", 1.0)),
            v_head_dim=int(opt("attention.value_length", 0)),
            has_pos_embd=arch in POS_EMBD_ARCHS,
            use_alibi=arch in ALIBI_ARCHS,
            n_expert=int(opt("expert_count", 0)),
            n_expert_used=int(opt("expert_used_count", 0)),
            moe_softmax_all=arch in SOFTMAX_ALL_ARCHS,
            # a stored 0 is a jitter of 0, not the default (as the reference)
            router_jitter=(0.01 if md.get(f"{arch}.router_jitter") is None
                           else float(md[f"{arch}.router_jitter"])),
            n_dense_layers=int(opt("leading_dense_block_count", 0)),
            n_shared_experts=int(opt("expert_shared_count", 0)),
            n_ff_exp=int(opt("expert_feed_forward_length", 0)),
            expert_weights_scale=float(opt("expert_weights_scale", 1.0)),
            expert_weights_norm=bool(opt("expert_weights_norm", False)),
        )


#: (field, value the ported block needs): the other architectures' branches
_PLAIN = (
    ("mrope_sections", ()),
    ("head_counts", ()), ("kv_head_counts", ()), ("resid_scale", 1.0), ("kv_lora_rank", 0),
    ("rope_yarn_log_mul", 0.0),
    ("moe_sparsemixer", False),  # phimoe
    ("n_dense_layers", 0),  # deepseek v1's leading dense layers
)


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming ROADMAP queue 1, item 8, unless
    `cfg` is the pre-norm block with the branches the port implements:
    RMSNorm, or LayerNorm for `LAYERNORM_ARCHS`; rotary GQA over the whole
    head or its first `rope_dim` features, at any head width, or no rotary
    for `NO_ROPE_ARCHS`, with learned positions for `POS_EMBD_ARCHS` and
    ALiBi for `ALIBI_ARCHS`; SiLU or GELU; the sequential or the parallel
    residual; the softcaps, the embedding, attention and logit scales,
    sandwich norms and a sliding window on every `swa_every`-th layer; the
    squared ReLU on nemotron, the non-parametric norms on olmo and the q/k/v
    clamp on `CLAMP_KQV_ARCHS`; the experts on `MOE_ARCHS`, routed by a
    softmax over the top k, or over every expert on `SOFTMAX_ALL_ARCHS`.
    That is the llama, Qwen2, Qwen3, Gemma, Gemma-2, the LayerNorm
    (`LAYERNORM_TARGETS`), GPT-2, StarCoder, BLOOM, MPT, Refact, JAIS,
    Mixtral and Qwen2-MoE families (`TARGET_ARCHS`) and EAGLE drafts. Each
    position, activation, norm, clamp and routing branch is admitted on
    its own architectures only."""
    bad = [f"{k}={getattr(cfg, k)!r}" for k, v in _PLAIN if getattr(cfg, k) != v]
    if cfg.norm_type not in ("rms", "layer"):
        bad.append(f"norm_type={cfg.norm_type!r}")
    elif cfg.norm_type == "layer" and cfg.arch not in LAYERNORM_ARCHS:
        bad.append(f"norm_type='layer' for arch {cfg.arch!r}")
    if cfg.act not in ("silu", "gelu", "relu2"):
        bad.append(f"act={cfg.act!r}")
    elif cfg.act == "relu2" and cfg.arch != "nemotron":
        bad.append(f"act='relu2' (squared ReLU) for arch {cfg.arch!r}")
    if cfg.nonparam_norms and (cfg.arch not in NONPARAM_NORM_ARCHS or cfg.norm_type != "layer"):
        bad.append(f"nonparam_norms for arch {cfg.arch!r}")
    if cfg.clamp_kqv < 0 or (cfg.clamp_kqv > 0 and cfg.arch not in CLAMP_KQV_ARCHS):
        bad.append(f"clamp_kqv={cfg.clamp_kqv} for arch {cfg.arch!r}")
    if cfg.has_pos_embd and cfg.arch not in POS_EMBD_ARCHS:
        bad.append(f"has_pos_embd (learned positions) for arch {cfg.arch!r}")
    if cfg.use_alibi and cfg.arch not in ALIBI_ARCHS:
        bad.append(f"use_alibi for arch {cfg.arch!r}")
    if cfg.rope_dim <= 0:
        if cfg.rope_dim < 0 or cfg.arch not in NO_ROPE_ARCHS:
            bad.append(f"rope_dim={cfg.rope_dim} (no rotary) for arch {cfg.arch!r}")
    elif cfg.rope_dim > cfg.head_dim or cfg.rope_dim % 2:
        bad.append(f"rope_dim={cfg.rope_dim} over head_dim {cfg.head_dim}")
    elif cfg.arch in NO_ROPE_ARCHS:
        bad.append(f"rope_dim={cfg.rope_dim} for arch {cfg.arch!r}, which has no rotary")
    if cfg.v_dim != cfg.head_dim:
        bad.append(f"v_head_dim={cfg.v_head_dim}")
    if cfg.swa_window > 0 and cfg.swa_every <= 0:
        # the reference turns flash prefill off there but windows no mask
        # (eagle_tpu/models/llama.py:712-721): the window would be ignored
        bad.append(f"swa_window={cfg.swa_window} on every layer (swa_every=0)")
    if cfg.n_expert > 0 or cfg.n_expert_used > 0:
        if cfg.arch not in MOE_ARCHS:  # qwen3moe, olmoe, granitemoe, dbrx, ...
            bad.append(f"a mixture of experts on arch {cfg.arch!r}")
        elif not 1 <= cfg.n_expert_used <= cfg.n_expert:
            bad.append(f"n_expert_used={cfg.n_expert_used} of {cfg.n_expert} experts")
    if cfg.moe_softmax_all != (cfg.arch in SOFTMAX_ALL_ARCHS):
        bad.append(f"moe_softmax_all={cfg.moe_softmax_all} for arch {cfg.arch!r}")
    if bad:
        raise NotImplementedError(f"not ported yet ({_ITEM8}): {', '.join(bad)}")
