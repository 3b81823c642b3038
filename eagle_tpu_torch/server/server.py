"""HTTP inference server, the llama-server equivalent (port of
eagle_tpu/server/server.py: `ServerMetrics`, `InferenceServer` and `main`).

Usage:
  python -m eagle_tpu_torch.server.server -m target.gguf [--draft draft.gguf]
      [-np 4 [--paged [--kv-pages N] [--page-size 64]]] [--host 0.0.0.0]
      [--port 8080] [--ctx 2048] [--device cuda]

Endpoints, bodies, SSE chunks and status codes as the reference's
`build_app`:
  GET  /, /index.html          the built-in chat page
  GET  /health, /props, /metrics (Prometheus text), /slots
  POST /tokenize, /detokenize
  POST /completion, /v1/completions, /v1/chat/completions (`stream`: SSE
       `data: {...}` lines; the chat stream ends with `data: [DONE]`)
  POST /embedding, /v1/embeddings, /rerank, /v1/rerank (`Engine.embed`,
       `Engine.rerank` on the target's params)
  POST /infill (`input_prefix`, `input_suffix`, `n_predict` / `max_tokens`,
       `spm_infill`, `seed`: `Engine.infill`; 400 for a vocabulary without
       FIM tokens)
  POST /slots/{id}?action=save|restore|erase (a body's `filename`, by
       default `slot_{id}.bin`: save writes the slot's state file, restore
       loads it into the slot and resumes it, erase frees the slot; 501
       without a batcher, 409 for a paged slot that is not live)

A completion's `grammar` (GBNF), `json_schema` or `response_format.schema`
(else the server's `--grammar`, its default grammar) runs through
`Engine.generate_text` on the single-stream worker, also beside a batch
worker: a chain engine of batch 1 speculates under the grammar, a plain
engine runs the constrained generator, and a batched chain engine answers
400 (constrained generation is single-sequence). A chat request's `tools`
(the reference's `tool_choice` handling: a system prompt listing the
tools, with "required" the tool grammar, the output parsed into
`message.tool_calls` with `finish_reason: "tool_calls"`) rides the same
path and answers without streaming, as the reference's. A constrained
stream answers 400: the reference's streams ignore the grammar. So does a
stateful sampler (a request's `repeat_penalty`) on a batched server, whose
rows the reference samples without the sampler's state.

The front is the standard library's `ThreadingHTTPServer` (the card's host
has no aiohttp): one thread per connection. Device work runs on one
thread: with `-np 1` an inference worker drains a queue of jobs for the
single-stream engine; with `-np N` > 1 and a chain draft, `BatcherWorker`
drives the `ContinuousBatcher` (with `--paged` the `PagedBatcher` over a
shared page pool) and every request, streamed or not, takes a
slot with its own sampler (the reference drops a batched request's sampler
and streams outside the batcher). Embeddings and rerank run outside the
batcher, on the thread that drives the device: the inference worker, or
the batch worker between two steps.

A request's fault answers 400 (a bad body, a prompt that does not fit a
slot, a vocabulary without FIM tokens), 501 (not ported) or 500 (any
other exception, a failed kernel or step among them), with
`{"error": ...}`. SIGTERM or SIGINT stops the
server: it closes its socket, ends its workers and `main` returns 0."""

from __future__ import annotations

import concurrent.futures
import json
import queue
import signal
import sys
import threading
import time
import urllib.parse
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from ..runtime.sampling import DroppedSamplerState, refuse_dropped_state
from ..utils.args import sampler_from_request

class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


@dataclass
class ServerMetrics:
    requests_total: int = 0
    tokens_generated_total: int = 0
    tokens_prompt_total: int = 0
    started_at: float = field(default_factory=time.time)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def add(self, **counts: int) -> None:
        with self.lock:
            for k, v in counts.items():
                setattr(self, k, getattr(self, k) + v)

    def prometheus(self) -> str:
        lines = [
            "# TYPE eagle_tpu_requests_total counter",
            f"eagle_tpu_requests_total {self.requests_total}",
            "# TYPE eagle_tpu_tokens_generated_total counter",
            f"eagle_tpu_tokens_generated_total {self.tokens_generated_total}",
            "# TYPE eagle_tpu_tokens_prompt_total counter",
            f"eagle_tpu_tokens_prompt_total {self.tokens_prompt_total}",
            "# TYPE eagle_tpu_uptime_seconds gauge",
            f"eagle_tpu_uptime_seconds {time.time() - self.started_at:.1f}",
        ]
        return "\n".join(lines) + "\n"


def _tool_system_prompt(tools: list[dict], fmt: str) -> str:
    """The tools' schemas as a system preamble for templates that carry no
    tools of their own (the reference's generic handler's JSON listing,
    common/chat.cpp:660-710)."""
    decls = json.dumps([t.get("function", t) for t in tools], ensure_ascii=False, indent=None)
    if fmt == "hermes_2_pro":
        how = ('To call a tool, reply with '
               '<tool_call>{"name": <name>, "arguments": <args-object>}</tool_call>')
    elif fmt == "mistral_nemo":
        how = ('To call tools, reply with '
               '[TOOL_CALLS][{"name": <name>, "arguments": <args-object>}]')
    elif fmt.startswith("llama_3"):
        how = 'To call a tool, reply with {"name": <name>, "parameters": <args-object>}'
    else:
        how = ('Respond with JSON: {"tool_call": {"name": <name>, '
               '"arguments": <args-object>}} to call a tool, or '
               '{"response": <text>} to answer directly.')
    return f"You have access to these tools:\n{decls}\n{how}"


class InferenceServer:
    def __init__(self, engine, model_name: str = "eagle-tpu", use_jinja: bool = False,
                 grammar: str | None = None):
        if use_jinja:
            from .chat_templates import JINJA_REFUSED

            raise NotImplementedError(JINJA_REFUSED)
        self.engine = engine
        self.model_name = model_name
        self.grammar = grammar  # --grammar: the default of requests without a constraint
        self.metrics = ServerMetrics()
        self._jobs: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._work, daemon=True,
                                        name="eagle-tpu-torch-inference")
        self._worker.start()
        self.batch_worker = None
        if getattr(engine, "batcher", None) is not None:
            from .batch_worker import BatcherWorker

            self.batch_worker = BatcherWorker(engine.batcher)
            self.batch_worker.start()
        self.httpd: ThreadingHTTPServer | None = None
        self._serving: threading.Thread | None = None

    # -- the single-stream worker ----------------------------------------

    def _work(self):
        while True:
            fut, fn = self._jobs.get()
            if fn is None:
                return
            try:
                fut.set_result(fn())
            except BaseException as e:  # surfaced to the request
                fut.set_exception(e)

    def _submit_job(self, fn) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._jobs.put((fut, fn))
        return fut

    def _generate(self, ids: list[int], body: dict) -> queue.Queue:
        """Start one generation; returns the queue it reports to: ("tok",
        id) per token, then ("done", tokens, stats) or ("error", exc)."""
        sampler = sampler_from_request(body, self.engine.cfg.sampler)
        max_new = int(body.get("max_tokens", body.get("n_predict", 128)))
        seed = int(body.get("seed", 0))
        q: queue.Queue = queue.Queue()

        def on_token(tok):
            q.put(("tok", int(tok)))

        if self.batch_worker is not None:
            from .batch_worker import BatchRequest

            # refused before a stream's headers go out
            refuse_dropped_state(sampler, "a batched server's rows")
            self.batch_worker.submit(BatchRequest(
                prompt_ids=ids, max_new=max_new, on_token=on_token, sampler=sampler,
                on_done=lambda toks: q.put(("done", list(toks), {"batched": True})),
                on_error=lambda e: q.put(("error", e))))
            return q

        def work():
            eng = self.engine.engine
            if self.engine.draft_params is not None:  # the engine's own sampler, as the reference
                return eng.generate(ids, max_new_tokens=max_new, seed=seed, on_token=on_token)
            return eng.generate(ids, max_new_tokens=max_new, sampler=sampler, seed=seed,
                                on_token=on_token), {}

        fut = self._submit_job(work)
        fut.add_done_callback(lambda f: q.put(
            ("error", f.exception()) if f.exception() else ("done", *f.result())))
        return q

    def _on_device(self, fn):
        """Run `fn()` on the thread that drives the device: the inference
        worker, or with a batcher its worker between two steps."""
        if self.batch_worker is not None:
            return self.batch_worker.call(lambda _batcher: fn()).result()
        return self._submit_job(fn).result()

    @staticmethod
    def _events(q: queue.Queue):
        """The generation's events up to its end: ("tok", id) ..., then
        ("done", tokens, stats) or ("error", exc)."""
        while True:
            ev = q.get()
            yield ev
            if ev[0] != "tok":
                return

    # -- handlers ---------------------------------------------------------

    def handle_props(self) -> dict:
        mc = self.engine.model_cfg
        return {"model": self.model_name, "n_ctx": self.engine.cfg.max_seq, "n_embd": mc.n_embd,
                "n_layers": mc.n_layers, "vocab_size": mc.vocab_size,
                "speculative": self.engine.draft_params is not None}

    def handle_slots(self) -> list:
        if self.batch_worker is None:
            return []

        def snap(b):
            return [{"id": s.id, "state": s.state, "request_id": s.request_id,
                     "n_generated": len(s.generated), "prompt_len": s.prompt_len}
                    for s in b.slots]

        return self.batch_worker.call(snap).result()

    def handle_slot_action(self, slot_id: int, action: str, body: dict) -> dict:
        """POST /slots/{id}?action=save|restore|erase (server.cpp:3690,
        3760): on the batch worker, between two steps."""
        if self.batch_worker is None:
            raise HTTPError(501, "slot save / restore / erase need the continuous batcher "
                                 "(-np > 1 with a draft)")
        filename = body.get("filename", f"slot_{slot_id}.bin")
        if action == "save":
            def op(b):
                return b.save_slot(slot_id, filename)
        elif action == "restore":
            def op(b):
                s = b.restore_slot(filename, slot_id)
                b.resume_slot(slot_id)
                return {"id": s.id, "state": s.state, "n_generated": len(s.generated)}
        elif action == "erase":
            def op(b):
                s = b.slots[slot_id]
                if s.state != "free":
                    b._free(s)
                return {"id": slot_id, "state": "free"}
        else:
            raise HTTPError(400, f"unknown action {action!r}")
        try:
            res = self.batch_worker.call(op).result()
        except ValueError as e:  # e.g. a paged save of a finished slot (its pages went back)
            raise HTTPError(409, str(e)) from None
        return {"id": slot_id, "result": res}

    def _constraint(self, body: dict) -> tuple[str | None, Any]:
        """The request's (grammar, json_schema): its own, else the server's
        default grammar."""
        fmt = body.get("response_format")
        schema = body.get("json_schema") or (fmt.get("schema") if isinstance(fmt, dict)
                                             else None)
        grammar = body.get("grammar")
        if not (grammar or schema):
            grammar = self.grammar
        return grammar, schema

    def _refuse_constrained_stream(self, body: dict) -> None:
        if any(self._constraint(body)):
            raise HTTPError(400, "a grammar or JSON schema constrains only a request without "
                                 "`stream`: the reference's streams ignore it")

    def _complete(self, prompt: str, body: dict) -> dict:
        t0 = time.time()
        ids = self.engine.tokenizer.encode(prompt)
        self.metrics.add(requests_total=1, tokens_prompt_total=len(ids))
        grammar, schema = self._constraint(body)
        if grammar or schema:  # on the single-stream worker, batched server or not
            sampler = sampler_from_request(body, self.engine.cfg.sampler)
            max_new = int(body.get("max_tokens", body.get("n_predict", 128)))
            seed = int(body.get("seed", 0))

            def work():
                text, st = self.engine.generate_text(prompt, max_new_tokens=max_new,
                                                     sampler=sampler, seed=seed,
                                                     grammar=grammar, json_schema=schema)
                return self.engine.tokenizer.encode(text, add_bos=False), st

            toks, stats = self._submit_job(work).result()
        else:
            *_, end = self._events(self._generate(ids, body))
            if end[0] == "error":
                raise end[1]
            _, toks, stats = end
        self.metrics.add(tokens_generated_total=len(toks))
        eos = self.engine.tokenizer.eos_id
        text = self.engine.tokenizer.decode([t for t in toks if t != eos], skip_special=True)
        dt = time.time() - t0
        return {"text": text, "tokens": toks, "stats": stats,
                "timings": {"total_s": dt, "predicted_n": len(toks),
                            "predicted_per_second": len(toks) / max(1e-9, dt)}}

    def _stream(self, out, prompt: str, body: dict, chat: bool) -> None:
        """SSE: one `data:` line per token (llama.cpp's `stream: true`, or
        OpenAI chat.completion.chunk frames), then the final frame(s)."""
        ids = self.engine.tokenizer.encode(prompt)
        self.metrics.add(requests_total=1)
        events = self._events(self._generate(ids, body))
        out.start_sse()
        eos = self.engine.tokenizer.eos_id
        cid = f"chatcmpl-{uuid.uuid4().hex[:12]}"

        def chunk(delta, finish):
            return {"id": cid, "object": "chat.completion.chunk", "created": int(time.time()),
                    "model": self.model_name,
                    "choices": [{"index": 0, "delta": delta, "finish_reason": finish}]}

        sent, stopped = 0, False
        for ev in events:
            if ev[0] == "error":  # the headers are out: the fault ends the stream
                out.sse({"error": f"{type(ev[1]).__name__}: {ev[1]}"})
                return
            if ev[0] == "done" or stopped:  # past eos: drained, not sent
                continue
            tok = ev[1]
            sent += 1
            piece = self.engine.tokenizer.piece(tok) if tok != eos else ""
            out.sse(chunk({"content": piece}, None) if chat
                    else {"content": piece, "token": tok, "stop": False})
            stopped = tok == eos
        self.metrics.add(tokens_generated_total=sent)
        if chat:
            out.sse(chunk({}, "stop"))
            out.sse_raw("[DONE]")
        else:
            out.sse({"content": "", "stop": True, "tokens_predicted": sent})

    def handle_completion(self, out, body: dict):
        if body.get("stream"):
            self._refuse_constrained_stream(body)
            return self._stream(out, body.get("prompt", ""), body, chat=False)
        res = self._complete(body.get("prompt", ""), body)
        return {"content": res["text"], "tokens_predicted": res["timings"]["predicted_n"],
                "stop": True, "timings": res["timings"], "speculative": res["stats"]}

    def handle_v1_completions(self, out, body: dict):
        res = self._complete(body.get("prompt", ""), body)
        return {"id": f"cmpl-{uuid.uuid4().hex[:12]}", "object": "text_completion",
                "created": int(time.time()), "model": self.model_name,
                "choices": [{"index": 0, "text": res["text"], "finish_reason": "stop"}],
                "usage": {"prompt_tokens": self.metrics.tokens_prompt_total,
                          "completion_tokens": res["timings"]["predicted_n"]}}

    def handle_v1_chat(self, out, body: dict):
        """A chat completion; with `tools` (unless `tool_choice` is "none")
        the format follows the template's markers (`detect_format`), a
        system message lists the tools, "required" constrains the output to
        a call (`build_tool_grammar`) and the output is parsed into
        `tool_calls`. A request with tools answers without streaming."""
        from .chat_templates import apply_template
        from .tool_calls import build_tool_grammar, detect_format
        from .tool_calls import parse as parse_tool_output

        jinja_src = self.engine.metadata.get("tokenizer.chat_template")
        messages = list(body.get("messages", []))
        tools = body.get("tools") or []
        fmt = "content_only"
        if tools and body.get("tool_choice", "auto") != "none":
            fmt = detect_format(jinja_src or "", has_tools=True)
            messages = [{"role": "system", "content": _tool_system_prompt(tools, fmt)}] + messages
            if body.get("tool_choice") == "required":
                g, _ = build_tool_grammar(tools, fmt, required=True)
                body = {**body, "grammar": g.gbnf_source}
        prompt = apply_template(messages, template=body.get("template"), jinja_src=jinja_src,
                                tools=tools or None)
        if body.get("stream") and not tools:
            self._refuse_constrained_stream(body)
            return self._stream(out, prompt, body, chat=True)
        res = self._complete(prompt, body)
        msg = parse_tool_output(res["text"].strip(), fmt if tools else "content_only")
        message: dict[str, Any] = {"role": "assistant", "content": msg.content or None}
        if msg.reasoning_content:
            message["reasoning_content"] = msg.reasoning_content
        if msg.tool_calls:
            message["tool_calls"] = [tc.as_openai() for tc in msg.tool_calls]
        else:
            message["content"] = res["text"].strip()
        return {"id": f"chatcmpl-{uuid.uuid4().hex[:12]}", "object": "chat.completion",
                "created": int(time.time()), "model": self.model_name,
                "choices": [{"index": 0, "message": message,
                             "finish_reason": "tool_calls" if msg.tool_calls else "stop"}]}

    def handle_infill(self, out, body: dict) -> dict:
        """Fill-in-the-middle (server.cpp's /infill): input_prefix +
        input_suffix -> the middle, on the thread that drives the device. A
        vocabulary without FIM tokens raises ValueError: 400."""
        self.metrics.add(requests_total=1)
        content = self._on_device(lambda: self.engine.infill(
            body.get("input_prefix", ""), body.get("input_suffix", ""),
            max_new_tokens=int(body.get("n_predict", body.get("max_tokens", 128))),
            spm_infill=bool(body.get("spm_infill", False)), seed=int(body.get("seed", 0))))
        return {"content": content, "stop": True}

    def handle_rerank(self, out, body: dict) -> dict:
        """Jina/TEI-style rerank: {"query": ..., "documents"|"texts": [...],
        "top_n": k, "return_documents": bool}."""
        query = body.get("query")
        if not isinstance(query, str):
            raise HTTPError(400, '"query" must be a string')
        docs = body.get("documents") or body.get("texts") or []
        if not docs:
            raise HTTPError(400, '"documents" must be a non-empty string array')
        self.metrics.add(requests_total=1)
        scores = self._on_device(lambda: self.engine.rerank(query, docs))
        ranked = sorted(range(len(docs)), key=lambda i: -scores[i])
        top_n = int(body.get("top_n", len(docs)))
        return {"model": self.model_name,
                "results": [{"index": i, "relevance_score": scores[i]}
                            | ({"document": {"text": docs[i]}} if body.get("return_documents")
                               else {}) for i in ranked[:top_n]]}

    def handle_v1_embeddings(self, out, body: dict) -> dict:
        inputs = body.get("input", body.get("content", ""))
        if isinstance(inputs, str):
            inputs = [inputs]
        vecs = self._on_device(lambda: self.engine.embed(inputs))
        return {"object": "list", "model": self.model_name,
                "data": [{"object": "embedding", "index": i, "embedding": v.tolist()}
                         for i, v in enumerate(vecs)]}

    def route(self, method: str, path: str, out, body_bytes: bytes | None):
        """Answer one request through `out` (the handler); `path` may carry
        a query."""
        path, _, query = path.partition("?")
        if method == "GET":
            if path in ("/", "/index.html"):
                from .webui import INDEX_HTML

                return out.send(200, "text/html", INDEX_HTML)
            gets = {"/health": lambda: {"status": "ok"}, "/props": self.handle_props,
                    "/slots": self.handle_slots}
            if path == "/metrics":
                return out.send(200, "text/plain", self.metrics.prometheus())
            if path in gets:
                return out.send_json(200, gets[path]())
        elif method == "POST":
            if path.startswith("/slots/") and path[7:].isdigit():
                action = urllib.parse.parse_qs(query).get("action", [""])[0]
                return out.send_json(200, self.handle_slot_action(
                    int(path[7:]), action, self._json(body_bytes)))
            posts = {"/tokenize": self._tokenize, "/detokenize": self._detokenize,
                     "/completion": self.handle_completion,
                     "/v1/completions": self.handle_v1_completions,
                     "/v1/chat/completions": self.handle_v1_chat,
                     "/infill": self.handle_infill,
                     "/rerank": self.handle_rerank, "/v1/rerank": self.handle_rerank,
                     "/v1/embeddings": self.handle_v1_embeddings,
                     "/embedding": self.handle_v1_embeddings}
            if path in posts:
                res = posts[path](out, self._json(body_bytes))
                if res is not None:
                    out.send_json(200, res)
                return None
        raise HTTPError(404, f"no {method} {path}")

    @staticmethod
    def _json(body_bytes: bytes | None) -> dict:
        try:
            return json.loads(body_bytes or b"{}")
        except json.JSONDecodeError as e:
            raise HTTPError(400, f"the body is not JSON: {e}") from None

    def _tokenize(self, out, body: dict) -> dict:
        return {"tokens": self.engine.tokenizer.encode(body.get("content", ""))}

    def _detokenize(self, out, body: dict) -> dict:
        return {"content": self.engine.tokenizer.decode(body.get("tokens", []))}

    # -- serving ------------------------------------------------------------

    def start(self, host: str = "0.0.0.0", port: int = 8080) -> tuple[str, int]:
        """Serve on a thread; returns the bound (host, port) (port 0 picks a
        free one)."""
        self.httpd = ThreadingHTTPServer((host, port), _handler(self))
        self.httpd.daemon_threads = True
        self._serving = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                         name="eagle-tpu-torch-http")
        self._serving.start()
        return self.httpd.server_address[:2]

    def stop(self) -> None:
        """Close the socket and end the workers."""
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self._serving.join()
            self.httpd = None
        self._jobs.put((None, None))
        self._worker.join()
        if self.batch_worker is not None:
            self.batch_worker.shutdown()
            self.batch_worker.join()

    def run(self, host: str = "0.0.0.0", port: int = 8080) -> None:
        """Serve until SIGTERM or SIGINT, then stop."""
        stop = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.set())
        host, port = self.start(host, port)
        print(f"[server] listening on http://{host}:{port}", file=sys.stderr, flush=True)
        stop.wait()
        self.stop()
        print("[server] stopped", file=sys.stderr, flush=True)


def _handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # no per-request lines on stderr
            pass

        def send(self, status: int, ctype: str, text: str) -> None:
            data = text.encode()
            self.send_response(status)
            self.send_header("Content-Type", f"{ctype}; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def send_json(self, status: int, obj: Any) -> None:
            self.send(status, "application/json", json.dumps(obj))

        def start_sse(self) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            self.close_connection = True  # the stream ends with the connection

        def sse(self, obj: Any) -> None:
            self.sse_raw(json.dumps(obj))

        def sse_raw(self, text: str) -> None:
            self.wfile.write(f"data: {text}\n\n".encode())
            self.wfile.flush()

        def _serve(self, method: str) -> None:
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else None
            try:
                server.route(method, self.path, self, body)
            except HTTPError as e:
                self.send_json(e.status, {"error": str(e)})
            except NotImplementedError as e:  # not ported: 501; a dropped sampler state: 400
                self.send_json(400 if isinstance(e, DroppedSamplerState) else 501,
                               {"error": str(e)})
            except ValueError as e:
                self.send_json(400, {"error": str(e)})
            except Exception as e:  # a failed kernel or step: the request gets it
                self.send_json(500, {"error": f"{type(e).__name__}: {e}"})

        def do_GET(self):
            self._serve("GET")

        def do_POST(self):
            self._serve("POST")

    return Handler


def main(argv=None) -> int:
    from ..api import Engine, EngineConfig
    from ..utils.args import apply_log_args, build_parser, check_refused

    args = build_parser("server").parse_args(argv)
    check_refused(args, "server")
    apply_log_args(args)
    cfg = EngineConfig(
        model_path=args.model,
        draft_path=args.draft,
        n_draft=args.n_draft,
        cycles_per_dispatch=args.cycles_per_dispatch,
        tree_branching=tuple(int(x) for x in args.tree.split(",")) if args.tree else None,
        max_seq=args.ctx,
        batch=args.parallel,
        paged=args.paged,
        kv_pages=args.kv_pages,
        page_size=args.page_size,
        feature_source=args.feature_source,
        device=args.device,
    )
    InferenceServer(Engine(cfg), grammar=args.grammar).run(host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
