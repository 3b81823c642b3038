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
- what the port lacks answers 501 naming its ROADMAP item;
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


def _reference(pair, slots: int):
    """The reference server on a thread (as tests/test_server.py starts it)."""
    eng = JaxEngine(JaxEngineConfig(model_path=pair[0], draft_path=pair[1], n_draft=K,
                                    batch=slots, max_seq=128, backend="xla",
                                    compute_dtype=jnp.float32, kv_dtype=jnp.float32))
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


REFUSED = [("/infill", {"input_prefix": "a"}, "item 7"), ("/slots/0?action=save", {}, "item 6"),
           ("/v1/chat/completions", {"messages": CHAT, "tools": [{"type": "function"}]},
            "item 7"),
           ("/completion", {"prompt": "a", "grammar": "root ::= \"a\""}, "item 7"),
           ("/completion", {"prompt": "a", "json_schema": {"type": "object"}}, "item 7")]


@pytest.mark.parametrize("path,body,item", REFUSED,
                         ids=[f"{r[0]}-{'-'.join(sorted(r[1]))}" for r in REFUSED])
def test_not_ported_answers_501(servers, path, body, item):
    with pytest.raises(urllib.error.HTTPError) as e:
        post(servers["port"] + path, body)
    assert e.value.code == 501 and item in json.loads(e.value.read())["error"]


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
    else:  # a fresh worker over the same batcher, so the module's stays alive
        from eagle_tpu_torch.server.batch_worker import BatcherWorker

        monkeypatch.setattr(eng, "_multi_cycle", broken)
        worker = BatcherWorker(srv.engine.batcher)
        worker.start()
        monkeypatch.setattr(srv, "batch_worker", worker)
    with pytest.raises(urllib.error.HTTPError) as e:
        post(servers["port"] + "/completion", {"prompt": "a dog", "n_predict": 4,
                                               "temperature": 0})
    assert e.value.code == 500 and "kernel launch failed" in json.loads(e.value.read())["error"]
    if servers["slots"] > 1:
        worker.join(10)
        assert isinstance(worker.error, RuntimeError) and not worker.is_alive()
        for slot in srv.engine.batcher.slots:  # leave the batcher as the module found it
            srv.engine.batcher._free(slot)
