"""The GGUF path as a whole: a tiny target/draft GGUF pair, minted by the
reference's writer, through both packages' loaders, serving prep and
engines (the port on the CPU, the reference on JAX's CPU with its XLA
backend).

Variants: Q4_0 layers with a Q6_K output, Q4_0 embeddings and a Q8_0 draft
(the Vicuna-7B Q4_0 path); Q4_K layers and draft with coded load (default)
and with `EAGLE_TPU_CODED_LOAD=0`; one file per family of the other formats:
Q4_1 (nibble-packed at serving), Q5_K (coded load) and IQ1_M (groups of 8;
random codebook blocks, the reference has no encoder for it). Checks:
- configs equal, every loaded leaf bit-equal, before and after
  `prepare_params_for_serving` (the port fuses the draft's q/k/v and
  gate/up at load; the reference's draft is fused with its own
  `fuse_layer_weights` for the comparison);
- logits of a prefill and two decode steps at rtol 1e-4 in f32 (the port
  folds group biases as a side product and sums attention in another order);
- greedy and chain tokens identical to the reference's, and, for Q4_0 and
  IQ1_M, also with the fused FFN block on (`EAGLE_TPU_FUSED_FFN=1`), whose
  plain versions do the unfused arithmetic in f32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.gguf.constants import GGMLType as J
from eagle_tpu.models import loader as jloader
from eagle_tpu.models.llama import llama_forward as jax_llama_forward
from eagle_tpu.quant.qtensor import QTensor as JQTensor
from eagle_tpu.quant.serving import prepare_params_for_serving as jprepare
from eagle_tpu.runtime.generate import Generator as JaxGenerator
from eagle_tpu.runtime.kvcache import KVCache as JaxKV
from eagle_tpu.runtime.kvcache import causal_mask_from_tags as jax_mask
from eagle_tpu.runtime.speculative import EagleChainEngine as JaxEngine
from eagle_tpu_torch import _build
from eagle_tpu_torch.models.llama import llama_forward
from eagle_tpu_torch.models.loader import load_eagle_params, load_llama_params
from eagle_tpu_torch.quant.qtensor import QTensor
from eagle_tpu_torch.quant.serving import prepare_params_for_serving
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.kvcache import KVCache, causal_mask_from_tags
from eagle_tpu_torch.runtime.speculative import EagleChainEngine
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    assert_bits_equal, background_cpu, write_tiny_gguf_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

MAX_SEQ = 128
N_NEW = 16
# variant -> (layer, output, embedding, draft type, EAGLE_TPU_CODED_LOAD)
VARIANTS = {
    "q4_0": (J.Q4_0, J.Q6_K, J.Q4_0, J.Q8_0, None),
    "q4_k_coded": (J.Q4_K, J.Q6_K, J.Q4_K, J.Q4_K, None),
    "q4_k_products": (J.Q4_K, J.Q6_K, J.Q4_K, J.Q4_K, "0"),
    "q4_1": (J.Q4_1, J.Q6_K, J.Q4_1, J.Q4_1, None),
    "q5_k_coded": (J.Q5_K, J.Q5_K, J.Q5_K, J.Q5_K, None),
    "iq1_m": (J.IQ1_M, J.IQ1_M, J.IQ1_M, J.IQ1_M, None),
}
#: variants whose layer weights nibble-pack at serving
PACKED = {"q4_0", "q4_k_coded", "q4_k_products", "q4_1"}
#: variants whose tokens are also checked with the fused FFN block
FUSED = {"q4_0", "iq1_m"}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def loaded(request, tmp_path_factory):
    layer_t, out_t, emb_t, draft_t, coded = VARIANTS[request.param]
    target, draft = write_tiny_gguf_pair(tmp_path_factory.mktemp(request.param), layer_t, out_t,
                                         emb_t, draft_t)
    mp = pytest.MonkeyPatch()
    if coded is not None:
        mp.setenv("EAGLE_TPU_CODED_LOAD", coded)
    else:
        mp.delenv("EAGLE_TPU_CODED_LOAD", raising=False)
    mp.setattr(jloader, "_CODED_LOAD", coded != "0")
    try:
        jt, jcfg, _ = jloader.load_llama_params(target)
        jd, jdcfg, _ = jloader.load_eagle_params(draft)
        tt, tcfg, _ = load_llama_params(target, device="cpu")
        td, tdcfg, _ = load_eagle_params(draft, device="cpu")
    finally:
        mp.undo()
    return dict(name=request.param, jt=jt, jd=jd, jcfg=jcfg, jdcfg=jdcfg, tt=tt, td=td,
                tcfg=tcfg, tdcfg=tdcfg)


def _same_tree(got, want, path=""):
    if isinstance(want, JQTensor):
        assert isinstance(got, QTensor), path
        assert (got.group, got.layout, got.packed, got.ggml_type) == (
            want.group, want.layout, want.packed, int(want.ggml_type)), path
        for k in ("q", "scale", "bias", "sup", "sup_min"):
            w = getattr(want, k)
            if w is None:
                assert getattr(got, k) is None, f"{path}.{k}"
            else:
                assert_bits_equal(getattr(got, k), np.asarray(w), f"{path}.{k}")
    elif isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif want is None:
        assert got is None, path
    else:
        assert_bits_equal(got, np.asarray(want), path)


def test_configs_equal(loaded):
    for port, ref in ((loaded["tcfg"], loaded["jcfg"]), (loaded["tdcfg"], loaded["jdcfg"])):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("prepared", [False, True], ids=["loaded", "served"])
def test_leaves_bit_equal(loaded, prepared):
    jt, jd = loaded["jt"], dict(loaded["jd"])
    jd["layers"] = jloader.fuse_layer_weights(jd["layers"])
    tt, td = loaded["tt"], loaded["td"]
    if prepared:
        jt, jd = jprepare(jt), jprepare(jd)
        tt, td = prepare_params_for_serving(tt), prepare_params_for_serving(td)
        assert tt["layers"]["wo"].packed == (loaded["name"] in PACKED)
        assert not tt["tok_embd"].packed
    _same_tree(tt, jt, "target")
    _same_tree(td, jd, "draft")


def test_logits_match(loaded):
    jt, tt = jprepare(loaded["jt"]), prepare_params_for_serving(loaded["tt"])
    jcfg, tcfg = loaded["jcfg"], loaded["tcfg"]
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(1, 18)).astype(np.int32)
    jkv = JaxKV.create(jcfg.n_layers, 1, MAX_SEQ, jcfg.n_kv_heads, jcfg.head_dim,
                       dtype=jnp.float32)
    tkv = KVCache.create(tcfg.n_layers, 1, MAX_SEQ, tcfg.n_kv_heads, tcfg.head_dim,
                         torch.float32, device="cpu")
    for lo, hi in ((0, 16), (16, 17), (17, 18)):
        pos = np.arange(lo, hi, dtype=np.int32)[None]
        jkv = jkv.with_tags(jnp.asarray(pos), jnp.asarray(pos))
        want = jax_llama_forward(jt, jcfg, jnp.asarray(toks[:, lo:hi]), jnp.asarray(pos), jkv,
                                 jnp.asarray(pos), jax_mask(jkv.slot_pos, jnp.asarray(pos)),
                                 backend="xla", compute_dtype=jnp.float32)
        jkv = want.kv
        tpos = torch.from_numpy(pos)
        tkv.with_tags(tpos, tpos)
        got = llama_forward(tt, tcfg, torch.from_numpy(toks[:, lo:hi]), tpos, tkv, tpos,
                            causal_mask_from_tags(tkv.slot_pos, tpos),
                            compute_dtype=torch.float32)
        want = np.asarray(want.logits)
        np.testing.assert_allclose(got.logits.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))


def test_tokens_identical(loaded, monkeypatch):
    jt, jd = jprepare(loaded["jt"]), jprepare(loaded["jd"])
    tt, td = prepare_params_for_serving(loaded["tt"]), prepare_params_for_serving(loaded["td"])
    jcfg, jdcfg, tcfg, tdcfg = loaded["jcfg"], loaded["jdcfg"], loaded["tcfg"], loaded["tdcfg"]
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=11).tolist()
    want = JaxGenerator(jt, jcfg, max_seq=MAX_SEQ, kv_dtype=jnp.float32,
                        compute_dtype=jnp.float32, backend="xla", eos_id=-1).generate(
        prompt, max_new_tokens=N_NEW, stop_at_eos=False, chunk=8)
    ref_chain, ref_stats = JaxEngine(
        jt, jd, jcfg, jdcfg, n_draft=3, max_seq=MAX_SEQ, kv_dtype=jnp.float32,
        compute_dtype=jnp.float32, backend="xla", eos_id=-1).generate(
        prompt, max_new_tokens=N_NEW, stop_at_eos=False)
    assert ref_chain == want
    fused_modes = ["0", "1"] if loaded["name"] in FUSED else ["0"]
    for mode in fused_modes:
        monkeypatch.setenv("EAGLE_TPU_FUSED_FFN", mode)
        _build.reset_counts()
        greedy = Generator(tt, tcfg, max_seq=MAX_SEQ, kv_dtype=torch.float32,
                           compute_dtype=torch.float32, eos_id=-1, device="cpu").generate(
            prompt, max_new_tokens=N_NEW, stop_at_eos=False, chunk=8)
        chain, stats = EagleChainEngine(
            tt, td, tcfg, tdcfg, n_draft=3, max_seq=MAX_SEQ, kv_dtype=torch.float32,
            compute_dtype=torch.float32, eos_id=-1, device="cpu").generate(
            prompt, max_new_tokens=N_NEW, stop_at_eos=False)
        assert greedy == want, mode
        assert chain == want, mode
        assert (stats["n_cycles"], stats["n_accepted"]) == (
            ref_stats["n_cycles"], ref_stats["n_accepted"]), mode
        assert (_build.plain_calls["gate_up_act"] > 0) == (mode == "1")
