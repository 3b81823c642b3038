"""The port's state files (eagle_tpu_torch/runtime/state_io.py) on the CPU:

- a slot saved mid-stream, restored into a fresh batcher and resumed, gives
  the uninterrupted run's tokens: dense -> dense, paged -> dense, dense ->
  paged, int8 too; a whole `SpecState` round-trips in place;
- a bad file is refused: the reference's slot file (JAX pytree leaves) with
  a clear error, another magic, another model's shapes;
- prompt-cache sessions interchange with the reference's in both
  directions, bf16 and int8 caches: each package reads the other's file,
  reuses its prefix and decodes the reference's tokens;
- the CLI's `--prompt-cache`: a second run reuses the prompt's prefix and
  prints the reference CLI's text and `[session]` line."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models.synth import synth_eagle_params, synth_llama_params
from eagle_tpu.runtime.generate import Generator as JaxGenerator
from eagle_tpu.runtime.speculative import EagleChainEngine as JaxEngine
from eagle_tpu.runtime.state_io import save_seq_state as jax_save_seq_state
from eagle_tpu_torch.convert import params_from_numpy
from eagle_tpu_torch.runtime import state_io
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.paged_batcher import PagedBatcher
from eagle_tpu_torch.runtime.scheduler import ContinuousBatcher
from eagle_tpu_torch.runtime.speculative import EagleChainEngine
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_PROMPT, background_cpu, tiny_cfgs, tiny_engine_pair, tree_to_numpy,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

K, MAX_SEQ = 2, 128
DT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_cfgs()
    jt = synth_llama_params(jcfg, seed=0, on_device=True, packed=True, coded=True)
    jd = synth_eagle_params(dataclasses.replace(jcfg, n_layers=1, is_eagle=True), packed=True)
    return dict(jcfg=jcfg, tcfg=tcfg, jt=jt, jd=jd, tt=params_from_numpy(tree_to_numpy(jt), "cpu"),
                td=params_from_numpy(tree_to_numpy(jd), "cpu"), engines={})


def engine(s, batch=2, kv="f32", role="batcher") -> EagleChainEngine:
    key = (batch, kv, role)
    if key not in s["engines"]:
        s["engines"][key] = EagleChainEngine(
            s["tt"], s["td"], s["tcfg"], n_draft=K, max_seq=MAX_SEQ, batch=batch,
            kv_dtype=DT[kv], compute_dtype=torch.float32, eos_id=-1, device="cpu")
    return s["engines"][key]


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, 512, n).tolist()


def _batcher(s, paged: bool, kv="f32"):
    eng = engine(s, kv=kv)
    return PagedBatcher(eng, n_pages=40, page_size=8) if paged else ContinuousBatcher(eng)


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("saved,restored", [("dense", "dense"), ("paged", "dense"),
                                            ("dense", "paged"), ("paged", "paged")])
def test_slot_resume_equals_an_uninterrupted_run(setup, tmp_path, saved, restored, kv):
    p = _prompt(1, 9)
    want = engine(setup, 1, kv, "single").generate(p, max_new_tokens=16, stop_at_eos=False)[0]
    b = _batcher(setup, saved == "paged", kv)
    b.submit(_prompt(2, 5), max_new_tokens=30, stop_at_eos=False)  # a neighbour in slot 0
    s = b.submit(p, max_new_tokens=16, stop_at_eos=False)
    while len(s.generated) < 5:
        b.step()
    first = list(s.generated)
    b.save_slot(s.id, tmp_path / "slot.bin")
    b2 = _batcher(setup, restored == "paged", kv)
    r = b2.restore_slot(tmp_path / "slot.bin", slot_id=0)
    assert r.state == "restored" and r.generated == first and r.prompt_len == 9
    b2.resume_slot(0)
    b2.run_until_done(max_steps=60)
    assert r.generated == want


def test_whole_state_round_trips_in_place(setup, tmp_path):
    eng = engine(setup, 1, "bf16", "single")
    eng.generate(_prompt(3, 12), max_new_tokens=6, stop_at_eos=False)
    st = eng.state
    saved = {k: v.clone() for k, v in state_io._named(st).items()}
    state_io.save_state(st, tmp_path / "state.bin", extra={"note": 1})
    ptrs = [t.data_ptr() for t in state_io._named(st).values()]
    eng.fresh_state()
    _, extra = state_io.load_state(st, tmp_path / "state.bin")
    assert extra == {"note": 1}
    assert [t.data_ptr() for t in state_io._named(st).values()] == ptrs
    for name, t in state_io._named(st).items():
        assert torch.equal(t, saved[name]), name


def test_bad_files_are_refused(setup, tmp_path):
    ref = JaxEngine(setup["jt"], setup["jd"], setup["jcfg"], n_draft=K, max_seq=32, batch=1,
                    kv_dtype=jnp.float32, compute_dtype=jnp.float32, backend="xla")
    jax_save_seq_state(ref.fresh_state(), 0, tmp_path / "ref_slot.bin", extra={})
    b = ContinuousBatcher(engine(setup))
    with pytest.raises(ValueError, match="reference.*pytree"):
        b.restore_slot(tmp_path / "ref_slot.bin", slot_id=0)
    (tmp_path / "junk.bin").write_bytes(b"not a state file")
    with pytest.raises(Exception):
        b.restore_slot(tmp_path / "junk.bin", slot_id=0)
    state_io.save_state(engine(setup).state.tgt_kv, tmp_path / "cache.bin")
    with pytest.raises(ValueError, match="per-sequence"):
        b.restore_slot(tmp_path / "cache.bin", slot_id=0)
    b8 = ContinuousBatcher(engine(setup, kv="int8"))  # another cache dtype
    s = b8.submit(_prompt(4, 5), max_new_tokens=3, stop_at_eos=False)
    b8.run_until_done(max_steps=10)
    b8.save_slot(s.id, tmp_path / "int8.bin")
    with pytest.raises(ValueError, match="does not fit"):
        b.restore_slot(tmp_path / "int8.bin", slot_id=0)
    with pytest.raises(ValueError, match="of KVCache, not a SpecState"):
        state_io.load_state(engine(setup, 1, "bf16", "single").state, tmp_path / "cache.bin")


# ---- prompt-cache sessions against the reference


def _jax_gen(s, kv):
    return JaxGenerator(s["jt"], s["jcfg"], max_seq=MAX_SEQ, kv_dtype=JDT[kv],
                        compute_dtype=jnp.float32, backend="xla", eos_id=-1)


def _port_gen(s, kv):
    return Generator(s["tt"], s["tcfg"], max_seq=MAX_SEQ, kv_dtype=DT[kv],
                     compute_dtype=torch.float32, eos_id=-1, device="cpu")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sessions_interchange_with_the_reference(setup, tmp_path, kv, writer):
    """Each package writes the session of a 20-token prompt and its 6 new
    tokens (--prompt-cache-all): the two files hold the same arrays, tokens
    and tags. The other package reads the writer's file for a prompt that
    shares 14 tokens, reuses them and decodes the tokens the reference
    decodes from its own file."""
    import shutil

    p1 = _prompt(5, 20)
    p2 = p1[:14] + _prompt(6, 6)
    files = {w: tmp_path / f"{w}.bin" for w in ("reference", "port")}
    _jax_gen(setup, kv).generate(p1, 6, stop_at_eos=False, session_path=str(files["reference"]),
                                 session_cache_all=True)
    _port_gen(setup, kv).generate(p1, 6, stop_at_eos=False, session_path=files["port"],
                                  session_cache_all=True)
    z = {w: np.load(f) for w, f in files.items()}
    assert sorted(z["port"].files) == sorted(z["reference"].files)
    for name in z["port"].files:
        a, b = z["port"][name], z["reference"][name]
        assert (a.shape, a.dtype) == (b.shape, b.dtype), name
    for name in ("tokens", "slot_pos", "__meta__"):
        np.testing.assert_array_equal(z["port"][name], z["reference"][name])
    shutil.copy(files["reference"], tmp_path / "own.bin")
    jg = _jax_gen(setup, kv)
    want = jg.generate(p2, 8, stop_at_eos=False, session_path=str(tmp_path / "own.bin"))
    assert jg.session_prefix_reused == 14
    if writer == "port":
        reader = _jax_gen(setup, kv)
        got = reader.generate(p2, 8, stop_at_eos=False, session_path=str(files["port"]))
    else:
        reader = _port_gen(setup, kv)
        got = reader.generate(p2, 8, stop_at_eos=False, session_path=files["reference"])
    assert reader.session_prefix_reused == 14 and got == want


def test_cli_prompt_cache_second_run_reuses_the_prefix(tmp_path, capsys):
    """The CLI twice with `--prompt-cache` (greedy): the second run reuses
    the prompt's cached tokens but its last, and prints the reference CLI's
    text and `[session]` line."""
    from eagle_tpu.tools import cli as jax_cli
    from eagle_tpu_torch.tools import cli

    target, _ = tiny_engine_pair(tmp_path, ENGINE_PROMPT)
    runs = {}
    for name, main, extra in (("reference", jax_cli.main, ["--backend", "xla"]),
                              ("port", cli.main, ["--device", "cpu"])):
        sess = tmp_path / f"{name}.session"
        outs = []
        for _ in range(2):
            assert main(["-m", str(target), "-p", ENGINE_PROMPT, "-n", "6", "--temp", "0",
                         "--ctx", "128", "--prompt-cache", str(sess), *extra]) in (0, None)
            out, err = capsys.readouterr()
            outs.append((out, [ln.replace(str(sess), "S") for ln in err.splitlines()
                               if ln.startswith("[session]")]))
        runs[name] = outs
    assert runs["port"] == runs["reference"]
    (_, first), (text, second) = runs["port"]
    assert first == ["[session] reused 0 cached prompt tokens from S"]
    assert second[0].startswith("[session] reused ") and " 0 " not in second[0]
    assert text.strip()
