"""The port's HTTP server (eagle_tpu_torch/server/server.py) against the
reference's (eagle_tpu/server/server.py, aiohttp) on the CPU, both on
localhost over one tiny GGUF pair (tests/torch_port_util.py:
`tiny_engine_pair`), f32, at one slot (the single-stream chain engine) and
at 3 slots (the continuous batcher):

- the same greedy requests to /completion, /v1/completions and
  /v1/chat/completions, streamed and not, give the same bodies apart from
  ids and times (`content`, `tokens_predicted`, the speculative stats,
  every SSE chunk's content and token);
- /embedding, /v1/embeddings, /rerank and /v1/rerank give the reference's
  bodies (floats to 1e-4) and status codes;
- /tokenize and /detokenize round trip, /metrics counts the requests,
  /slots lists the slots, /props and the web page are served;
- /infill on a vocabulary without FIM tokens answers the reference's 400;
- `grammar`, `json_schema`, `response_format.schema` and `tools` with
  `tool_choice: "required"` (answering `tool_calls`) give the reference's
  bodies at one chain slot; a
  constraint on a batched server answers 400 naming batch 1, a constrained
  stream 400, a batched request's repeat penalty 400 (the reference drops
  the sampler's state there); `--grammar` is the server's default grammar;
- POST /slots/{id}?action=save|restore|erase answers the reference's bodies
  (501 without a batcher), and the restored slot holds the saved one's
  tags and tokens;
- `--paged` at 3 slots (a pool of 16-row pages, oversubscribed) answers the
  reference's `--paged` server's bodies, and a save of a finished paged
  slot answers 409 as the reference's;
- a batched request's temperature is honoured (the reference drops a
  batched request's sampler: a fault not copied);
- a step fault reaches the waiting request as a 500."""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from eagle_tpu.api import Engine as JaxEngine
from eagle_tpu.api import EngineConfig as JaxEngineConfig
from eagle_tpu.server.server import InferenceServer as JaxServer
from eagle_tpu_torch.api import Engine, EngineConfig
from eagle_tpu_torch.runtime.paged_batcher import PagedBatcher
from eagle_tpu_torch.server.server import InferenceServer
from torch_port_util import ENGINE_PROMPT, background_cpu, tiny_engine_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files
web = pytest.importorskip("aiohttp.web")

SLOTS = [1, 3]
K = 2


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tiny_engine_pair(tmp_path_factory.mktemp("server"), ENGINE_PROMPT)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_health(base: str) -> None:
    for _ in range(200):
        try:
            urllib.request.urlopen(base + "/health", timeout=1)
            return
        except OSError:
            time.sleep(0.05)
    raise TimeoutError(base)


def _reference(pair, slots: int, draft: bool = True, max_seq: int = 128, **kw):
    """The reference server on a thread (as tests/test_server.py starts it)."""
    eng = JaxEngine(JaxEngineConfig(model_path=pair[0], draft_path=pair[1] if draft else None,
                                    n_draft=K, batch=slots, max_seq=max_seq, backend="xla",
                                    compute_dtype=jnp.float32, kv_dtype=jnp.float32, **kw))
    srv, port, loop, holder = JaxServer(eng, model_name="tiny"), _free_port(), \
        asyncio.new_event_loop(), {}

    def run():
        asyncio.set_event_loop(loop)
        runner = holder["runner"] = web.AppRunner(srv.build_app())
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    _wait_health(base)

    def stop():
        asyncio.run_coroutine_threadsafe(holder["runner"].cleanup(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)

    return base, stop


@pytest.fixture(scope="module", params=SLOTS, ids=[f"np{n}" for n in SLOTS])
def servers(request, pair):
    slots = request.param
    eng = Engine(EngineConfig(model_path=pair[0], draft_path=pair[1], n_draft=K, batch=slots,
                              max_seq=128, compute_dtype=torch.float32, kv_dtype=torch.float32,
                              device="cpu"))
    srv = InferenceServer(eng, model_name="tiny")
    host, port = srv.start("127.0.0.1", 0)
    ref, stop_ref = _reference(pair, slots)
    yield dict(port=f"http://{host}:{port}", ref=ref, slots=slots, srv=srv)
    srv.stop()
    stop_ref()


def post(url, body, raw=False):
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        data = r.read()
        return (r.headers.get("Content-Type", ""), data.decode()) if raw else json.loads(data)


def get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.headers.get("Content-Type", ""), r.read().decode()


def _strip(obj):
    """A body without its ids and times."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created", "timings")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _frames(text: str):
    return [line[6:] for line in text.split("\n") if line.startswith("data: ")]


CHAT = [{"role": "system", "content": "the lazy dog"}, {"role": "user", "content": "the fox"}]
REQUESTS = [  # (path, body): greedy, sent in this order to both servers
    ("/completion", {"prompt": ENGINE_PROMPT, "n_predict": 12, "temperature": 0}),
    ("/completion", {"prompt": "a lazy dog", "n_predict": 9, "temperature": 0, "stream": True}),
    ("/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 10, "temperature": 0}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 8, "temperature": 0}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 8, "temperature": 0,
                              "stream": True}),
]


def test_greedy_requests_match_reference(servers):
    for path, body in REQUESTS:
        got = post(servers["port"] + path, body, raw=True)
        want = post(servers["ref"] + path, body, raw=True)
        assert got[0].split(";")[0] == want[0].split(";")[0], path  # the content type
        if body.get("stream"):
            g, w = _frames(got[1]), _frames(want[1])
            assert [f == "[DONE]" or _strip(json.loads(f)) for f in g] == \
                [f == "[DONE]" or _strip(json.loads(f)) for f in w], path
            assert len(g) > 2
        else:
            g, w = _strip(json.loads(got[1])), _strip(json.loads(want[1]))
            assert g == w, path
    # the metrics' counters (uptime apart)
    for base in ("port", "ref"):
        metrics = dict(line.split() for line in get(servers[base] + "/metrics")[1].splitlines()
                       if line and not line.startswith("#"))
        metrics.pop("eagle_tpu_uptime_seconds")
        servers.setdefault("metrics", []).append(metrics)
    assert servers["metrics"][0] == servers["metrics"][1]
    assert servers["metrics"][0]["eagle_tpu_requests_total"] == str(len(REQUESTS))


def test_concurrent_completions_match_single_requests(servers):
    prompts = ["the quick fox", "a lazy dog and then", "over the", ENGINE_PROMPT]

    def go(p):
        return post(servers["port"] + "/completion",
                    {"prompt": p, "n_predict": 10, "temperature": 0})["content"]

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        together = list(ex.map(go, prompts))
    assert together == [go(p) for p in prompts]


def test_tokenize_props_slots_and_page(servers):
    base = servers["port"]
    toks = post(base + "/tokenize", {"content": "the lazy dog"})["tokens"]
    assert toks == post(servers["ref"] + "/tokenize", {"content": "the lazy dog"})["tokens"]
    text = post(base + "/detokenize", {"tokens": toks})["content"]
    assert text == post(servers["ref"] + "/detokenize", {"tokens": toks})["content"]
    assert text.endswith("the lazy dog")
    assert json.loads(get(base + "/props")[1]) == json.loads(get(servers["ref"] + "/props")[1])
    assert json.loads(get(base + "/health")[1]) == {"status": "ok"}
    slots = json.loads(get(base + "/slots")[1])
    if servers["slots"] == 1:
        assert slots == []
    else:
        assert [s["id"] for s in slots] == [0, 1, 2] and {s["state"] for s in slots} == {"free"}
    ctype, html = get(base + "/")
    assert ctype.startswith("text/html") and html == get(servers["ref"] + "/")[1]


REFUSED = [("/infill", {"input_prefix": "a"}, "FIM tokens"),
           ("/v1/chat/completions", {"messages": CHAT, "tools": [{"type": "function"}]},
            "does not fit"),
           ("/completion", {"prompt": "a", "grammar": "root ::= \"a\""}, "batch 1"),
           ("/completion", {"prompt": "a", "json_schema": {"type": "boolean"}}, "batch 1")]


@pytest.mark.parametrize("path,body,item", REFUSED,
                         ids=[f"{r[0]}-{'-'.join(sorted(r[1]))}" for r in REFUSED])
def test_not_ported_answers_501(servers, path, body, item):
    """The requests that answered 501 before: /infill on a vocabulary
    without FIM tokens answers 400 with the reference's body at one and at
    3 slots; `grammar` and `json_schema` answer the reference's
    bodies at one slot (the chain engine speculating under the grammar),
    and at 3 slots 400 naming batch 1 (the reference's chain engine asserts
    it: a 500). `tools` add a system prompt listing them (295 tokens here),
    which fits neither server's 128-slot cache: both answer an error (the
    port's batcher a 400 naming the fit); `test_constrained_bodies_match_
    reference` holds tools against the reference on servers that fit it."""
    got = _answer(servers["port"] + path, body)
    if item == "FIM tokens":
        assert got[0] == 400 and item in got[1]["error"]
        assert got == _answer(servers["ref"] + path, body)
    elif item == "does not fit":  # at 3 slots the reference's batcher answers anyway
        assert (got[0], _status(servers["ref"] + path, body)) == (500, 500) or (
            got[0] == 400 and item in got[1]["error"] and servers["slots"] > 1)
    elif servers["slots"] > 1:
        assert got[0] == 400 and item in got[1]["error"], got
        assert _status(servers["ref"] + path, body) == 500
    else:
        assert got[0] == 200 and _strip(got[1]) == _strip(_answer(servers["ref"] + path, body)[1])


def _status(url, body) -> int:
    try:
        post(url, body, raw=True)
        return 200
    except urllib.error.HTTPError as e:
        return e.code


WORDS = "root ::= [a-z ]+"
SCHEMA = {"type": "object", "properties": {"a": {"type": "boolean"}, "b": {"enum": ["x", "y"]}},
          "required": ["a", "b"]}
TOOLS = [{"type": "function", "function": {
    "name": "add", "description": "add two numbers",
    "parameters": {"type": "object", "properties": {"a": {"type": "boolean"}},
                   "required": ["a"]}}}]
CONSTRAINED = [  # (path, body): through Engine.generate_text on both servers
    ("/completion", {"prompt": "the quick brown fox", "n_predict": 12, "grammar": WORDS,
                     "temperature": 0}),
    ("/v1/completions", {"prompt": "the lazy dog", "max_tokens": 24, "json_schema": SCHEMA,
                         "temperature": 0}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 24, "temperature": 0,
                              "response_format": {"type": "json_object", "schema": SCHEMA}}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "add 1 and 2"}],
                              "max_tokens": 90, "temperature": 0, "tools": TOOLS,
                              "tool_choice": "required", "stream": True}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "add 1 and 2"}],
                              "max_tokens": 10, "temperature": 0, "tools": TOOLS}),
]


@pytest.fixture(scope="module")
def spec_servers(pair):
    """The port's and the reference's servers at one chain slot with
    max_seq 512 (room for the tools' system prompt): both speculate under
    the grammar (`generate_constrained` of their chain engine)."""
    eng = Engine(EngineConfig(model_path=pair[0], draft_path=pair[1], n_draft=K, max_seq=512,
                              compute_dtype=torch.float32, kv_dtype=torch.float32,
                              device="cpu"))
    srv = InferenceServer(eng, model_name="tiny")
    host, port = srv.start("127.0.0.1", 0)
    ref, stop_ref = _reference(pair, 1, draft=True, max_seq=512)
    yield dict(port=f"http://{host}:{port}", ref=ref, srv=srv)
    srv.stop()
    stop_ref()


@pytest.mark.parametrize("path,body", CONSTRAINED,
                         ids=[f"{i}-{c[0]}" for i, c in enumerate(CONSTRAINED)])
def test_constrained_bodies_match_reference(spec_servers, path, body):
    """`grammar`, `json_schema`, `response_format.schema` and `tools`
    (`tool_choice: "required"`: the tool grammar, answered without
    streaming even when asked to stream, as the reference's): the
    reference's bodies apart from ids and times. The schema's text parses
    and the required tool call comes back as `tool_calls`."""
    got = post(spec_servers["port"] + path, body)
    assert _strip(got) == _strip(post(spec_servers["ref"] + path, body))
    if "json_schema" in body:
        obj = json.loads(got["choices"][0]["text"])
        assert isinstance(obj["a"], bool) and obj["b"] in ("x", "y")
    if body.get("tool_choice") == "required":
        choice = got["choices"][0]
        assert choice["finish_reason"] == "tool_calls", choice
        call = choice["message"]["tool_calls"][0]["function"]
        assert call["name"] == "add" and isinstance(json.loads(call["arguments"])["a"], bool)


def test_server_default_grammar(spec_servers):
    """The server's `--grammar` constrains the requests without one of
    their own; a request's own grammar wins."""
    srv = spec_servers["srv"]
    body = {"prompt": "the quick brown fox", "n_predict": 12, "temperature": 0}
    free = post(spec_servers["port"] + "/completion", body)["content"]
    try:
        srv.grammar = 'root ::= "yes" | "no"'
        assert post(spec_servers["port"] + "/completion", body)["content"] in ("yes", "no")
        own = post(spec_servers["port"] + "/completion", {**body, "grammar": WORDS})
        assert own["content"] == post(spec_servers["port"] + "/completion", {
            **body, "grammar": WORDS})["content"]
        assert _answer(spec_servers["port"] + "/completion", {**body, "stream": True})[0] == 400
    finally:
        srv.grammar = None
    assert post(spec_servers["port"] + "/completion", body)["content"] == free


STREAMS = [("/completion", {"prompt": "a dog", "n_predict": 4, "grammar": WORDS,
                            "stream": True}),
           ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 4, "stream": True,
                                     "response_format": {"schema": SCHEMA}})]


@pytest.mark.parametrize("path,body", STREAMS, ids=[s[0] for s in STREAMS])
def test_constrained_stream_answers_400(servers, path, body):
    """The reference's streams ignore a grammar or schema; the port's
    answer 400 before any frame."""
    code, err = _answer(servers["port"] + path, body)
    assert code == 400 and "stream" in err["error"]


def test_batched_stateful_request_answers_400(servers):
    """A request's repeat penalty on a batched server: the reference's rows
    sample without the sampler's state, the port's answers 400 before it
    takes a slot (streamed or not). At one slot the chain engine samples
    with its own sampler, as the reference's."""
    body = {"prompt": "the lazy dog", "n_predict": 6, "temperature": 0, "repeat_penalty": 1.3}
    for extra in ({}, {"stream": True}):
        if servers["slots"] > 1:
            code, got = _answer(servers["port"] + "/completion", {**body, **extra})
            assert code == 400 and "drops the sampler's state" in got["error"]
        else:
            assert _status(servers["port"] + "/completion", {**body, **extra}) == 200
    if servers["slots"] > 1:
        slots = json.loads(get(servers["port"] + "/slots")[1])
        assert all(s["state"] == "free" for s in slots)


EMBEDS = [("/embedding", {"content": "the lazy dog"}),
          ("/v1/embeddings", {"input": ["the fox", "a lazy dog and then"]}),
          ("/rerank", {"query": "the fox", "documents": ["a lazy dog", "the quick brown fox",
                                                        "over"], "top_n": 2}),
          ("/v1/rerank", {"query": "the fox", "texts": ["a dog", "the fox"],
                          "return_documents": True}),
          ("/rerank", {"query": "the fox"})]  # no documents: 400


def _close(got, want):
    """Bodies equal, floats to 1e-4 (the two packages' f32 forwards)."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(_close(got[k], want[k]) for k in want)
    if isinstance(want, list):
        return len(got) == len(want) and all(_close(g, w) for g, w in zip(got, want))
    if isinstance(want, float):
        return got == pytest.approx(want, rel=1e-4, abs=1e-5)
    return got == want


def _answer(url, body):
    try:
        return 200, post(url, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def ref_answers():
    """The reference server's answers by request: they do not depend on its
    slots, so the reference computes each once per module."""
    return {}


@pytest.mark.parametrize("path,body", EMBEDS,
                         ids=[f"{e[0]}-{'-'.join(sorted(e[1]))}" for e in EMBEDS])
def test_embeddings_and_rerank_match_reference(servers, ref_answers, path, body):
    """The reference's bodies and status codes, outside the batcher at 3
    slots as at one."""
    key = json.dumps([path, body])
    if key not in ref_answers:
        ref_answers[key] = _answer(servers["ref"] + path, body)
    (code, got), (want_code, want) = _answer(servers["port"] + path, body), ref_answers[key]
    assert code == want_code and _close(got, want), (got, want)
    if code == 200 and "embedding" in path:
        assert all(abs(sum(x * x for x in d["embedding"]) - 1) < 1e-4 for d in got["data"])


def test_batched_request_keeps_its_temperature(servers):
    """A hot request (temperature 5, no masks) on a batched server samples:
    its text parts from the greedy one, where the reference's batched path
    drops the sampler and answers the greedy text. At one slot both
    servers' chain engine keeps its own (greedy) sampler."""
    greedy = {"prompt": "the lazy dog", "n_predict": 16, "temperature": 0}
    hot = {**greedy, "temperature": 5.0, "top_k": 0, "top_p": 1.0, "min_p": 0.0}
    want = post(servers["port"] + "/completion", greedy)["content"]
    got = post(servers["port"] + "/completion", hot)["content"]
    assert (got != want) == (servers["slots"] > 1)
    assert post(servers["ref"] + "/completion", hot)["content"] == want


def test_step_fault_reaches_the_request(servers, monkeypatch):
    """No fallback: an exception in the engine's step answers 500 with it."""
    srv = servers["srv"]
    eng = srv.engine.engine

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    if servers["slots"] == 1:
        monkeypatch.setattr(eng, "generate", broken)
    else:  # a fresh worker over the same batcher: the module's is ended first, since two
        # workers stepping one (not thread-safe) batcher race for its queue and counters
        from eagle_tpu_torch.server.batch_worker import BatcherWorker

        srv.batch_worker.shutdown()
        srv.batch_worker.join(30)
        assert not srv.batch_worker.is_alive()
        monkeypatch.setattr(eng, "_multi_cycle", broken)
        worker = BatcherWorker(srv.engine.batcher)
        worker.start()
        srv.batch_worker = worker
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            post(servers["port"] + "/completion", {"prompt": "a dog", "n_predict": 4,
                                                   "temperature": 0})
        assert e.value.code == 500 and \
            "kernel launch failed" in json.loads(e.value.read())["error"]
        if servers["slots"] > 1:
            worker.join(10)
            assert isinstance(worker.error, RuntimeError) and not worker.is_alive()
    finally:
        if servers["slots"] > 1:  # leave the module a live worker over a clean batcher
            for slot in srv.engine.batcher.slots:
                srv.engine.batcher._free(slot)
            monkeypatch.undo()
            srv.batch_worker = BatcherWorker(srv.engine.batcher)
            srv.batch_worker.start()


def _slot_action(base, slot, action, body):
    return _answer(f"{base}/slots/{slot}?action={action}", body)


def test_slot_save_restore_erase(servers, tmp_path):
    """A finished greedy request's slot saved, restored into another slot
    (which resumes) and erased: the reference's bodies and status codes; at
    one slot both answer 501. The restored slot's rows equal the saved
    one's."""
    results = {}
    for side in ("port", "ref"):
        base = servers[side]
        post(base + "/completion", {"prompt": "the quick brown fox", "n_predict": 5,
                                    "temperature": 0})
        f = str(tmp_path / f"{side}.bin")
        out = [_slot_action(base, 0, "save", {"filename": f}),
               _slot_action(base, 1, "restore", {"filename": f}),
               _slot_action(base, 1, "erase", {}),
               _slot_action(base, 0, "bogus", {})]
        results[side] = [(code, body if code == 200 else None) for code, body in out]
    assert results["port"] == results["ref"]
    codes = [c for c, _ in results["port"]]
    if servers["slots"] == 1:
        assert codes == [501] * 4
        return
    assert codes == [200, 200, 200, 400]
    save = results["port"][0][1]["result"]
    assert save["prompt_len"] == len(post(servers["port"] + "/tokenize",
                                          {"content": "the quick brown fox"})["tokens"])
    assert len(save["generated"]) == 5
    assert results["port"][1][1]["result"] == {"id": 1, "state": "generating", "n_generated": 5}


def test_erase_ends_the_slots_request(servers):
    """Erasing a slot whose request is generating ends that request: its
    reply comes back with the tokens it had, and the slot is free."""
    if servers["slots"] == 1:
        return
    base = servers["port"]
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        reply = ex.submit(post, base + "/completion", {"prompt": "the lazy dog",
                                                       "n_predict": 100, "temperature": 0,
                                                       "ignore_eos": True})
        for _ in range(600):
            busy = [s for s in json.loads(get(base + "/slots")[1]) if s["state"] != "free"]
            if busy and busy[0]["n_generated"] > 1:
                break
            time.sleep(0.05)
        assert busy, "the request never took a slot"
        assert _slot_action(base, busy[0]["id"], "erase", {}) == (
            200, {"id": busy[0]["id"], "result": {"id": busy[0]["id"], "state": "free"}})
        got = reply.result(timeout=60)
    assert 1 <= got["tokens_predicted"] < 100
    assert all(s["state"] == "free" for s in json.loads(get(base + "/slots")[1]))


@pytest.fixture(scope="module")
def paged_servers(pair):
    """The port's and the reference's `--paged` servers at 3 slots, 16
    pages of 16 rows against 3 x 128 addressable slots."""
    kw = dict(paged=True, kv_pages=16, page_size=16)
    eng = Engine(EngineConfig(model_path=pair[0], draft_path=pair[1], n_draft=K, batch=3,
                              max_seq=128, compute_dtype=torch.float32, kv_dtype=torch.float32,
                              device="cpu", **kw))
    srv = InferenceServer(eng, model_name="tiny")
    host, port = srv.start("127.0.0.1", 0)
    ref, stop_ref = _reference(pair, 3, **kw)
    yield dict(port=f"http://{host}:{port}", ref=ref, srv=srv)
    srv.stop()
    stop_ref()


def test_paged_server_matches_reference(paged_servers, tmp_path):
    """The greedy requests (streamed and not, in order), then four
    concurrent ones sharing a prompt prefix, on both `--paged` servers: the
    same bodies apart from ids and times. A finished slot's save answers
    409 on both (its pages went back to the pool); erase answers 200."""
    srv = paged_servers
    assert isinstance(srv["srv"].engine.batcher, PagedBatcher)
    for path, body in REQUESTS:
        got = post(srv["port"] + path, body, raw=True)
        want = post(srv["ref"] + path, body, raw=True)
        if body.get("stream"):
            assert [f == "[DONE]" or _strip(json.loads(f)) for f in _frames(got[1])] == \
                [f == "[DONE]" or _strip(json.loads(f)) for f in _frames(want[1])], path
        else:
            assert _strip(json.loads(got[1])) == _strip(json.loads(want[1])), path
    prompts = [ENGINE_PROMPT + tail for tail in (" the fox", " a dog", " over", " then the")]

    def go(base, p):
        return post(base + "/completion", {"prompt": p, "n_predict": 10,
                                           "temperature": 0})["content"]

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        got = list(ex.map(lambda p: go(srv["port"], p), prompts))
    assert got == [go(srv["ref"], p) for p in prompts]
    stats = srv["srv"].engine.batcher.stats
    assert stats["prefix_hits"] >= 1 and stats["prefill_tokens_skipped"] >= 16
    for side in ("port", "ref"):
        code, body = _slot_action(srv[side], 0, "save", {"filename": str(tmp_path / "x.bin")})
        assert code == 409 and "pool" in body["error"], (side, body)
        assert _slot_action(srv[side], 2, "erase", {}) == (200, {"id": 2, "result": {
            "id": 2, "state": "free"}})
