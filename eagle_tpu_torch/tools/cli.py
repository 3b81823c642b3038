"""Command-line generation, the llama-cli equivalent (port of
eagle_tpu/tools/cli.py: `main` and `chat_loop`).

Usage:
  python -m eagle_tpu_torch.tools.cli -m model.gguf -p "prompt" [-n 128]
      [--draft eagle.gguf] [--tree 4,2,2 | --tree2 8,6,32] [--temp 0.8]
      [--top-k 40] [--top-p 0.95] [--min-p 0.05] [--seed 0] [--device cuda]
      [--prompt-cache session.bin [--prompt-cache-all]] [--repeat-penalty 1.1]
      [--grammar GBNF | --json-schema JSON] [--lookahead W,N,G --temp 0]
  python -m eagle_tpu_torch.tools.cli -m model.gguf --chat
      [--chat-template vicuna] [--system "..."] [-n 128] [--temp 0]

Prints the text on stdout and `[load]`, `[perf]` and, with a draft,
`[speculative] accept_rate=... mean_accept_len=... cycles=...` (with
`--lookahead`, `[lookahead] tokens_per_step=... n_accept=... steps=...`) on
stderr, as the reference does. Lookahead decoding is greedy: the reference
ignores the sampler there, so the port refuses the default (sampled) one
and asks for `--temp 0`. With `--prompt-cache` the prompt's longest prefix
cached in the session file skips its prefill (on a plain generator, as the
reference's main.cpp), `[session] reused N cached prompt tokens from ...`
goes to stderr, and the file is rewritten. `--grammar` (GBNF text) and
`--json-schema` (a JSON text) constrain the output, speculating under the
grammar with a chain draft. With `--chat` each line on stdin is one user turn
(`/exit` or end of input quits): the reply streams to stdout and a
`[perf]` line per turn goes to stderr; the session is non-speculative, as
the reference's. It runs on the card unless `--device cpu`."""

from __future__ import annotations

import sys
import time


def build_argparser():
    from ..utils.args import build_parser

    return build_parser("cli")


def chat_loop(eng, args, sampler) -> int:
    """The reference's conversation loop (examples/main): each line from
    stdin is one user turn; only the template's diff is fed, the cache keeps
    the shared history."""
    session = eng.chat_session(system=args.system, template=args.chat_template,
                               use_jinja=args.jinja)
    print("== chat mode (ctrl-d or /exit to quit) ==", file=sys.stderr)
    while True:
        try:
            line = input("> ")
        except EOFError:
            break
        if line.strip() in ("/exit", "/quit"):
            break
        if not line.strip():
            continue
        t0 = time.time()
        n_tok = [0]

        def stream(tok_id, _n=n_tok):
            _n[0] += 1
            print(eng.tokenizer.decode([tok_id], skip_special=True), end="", flush=True)

        session.ask(line, max_new_tokens=args.n_predict, sampler=sampler, seed=args.seed,
                    on_token=stream)
        dt = time.time() - t0
        print(f"\n[perf] {n_tok[0]} tokens in {dt:.2f}s "
              f"({n_tok[0] / max(dt, 1e-9):.1f} t/s, ctx {session.pos})", file=sys.stderr)
    return 0


def _ints(spec: str | None):
    return tuple(int(x) for x in spec.split(",")) if spec else None


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from ..api import Engine, EngineConfig
    from ..utils.args import apply_log_args, check_refused, sampler_from_args

    check_refused(args, "cli")
    apply_log_args(args)
    sampler = sampler_from_args(args)
    cfg = EngineConfig(
        model_path=args.model,
        draft_path=args.draft,
        n_draft=args.n_draft,
        cycles_per_dispatch=args.cycles_per_dispatch,
        tree_branching=_ints(args.tree),
        tree2=_ints(args.tree2),
        lookahead=_ints(args.lookahead),
        max_seq=args.ctx,
        feature_source=args.feature_source,
        sampler=sampler,
        device=args.device,
    )
    t0 = time.time()
    eng = Engine(cfg)
    print(f"[load] {time.time() - t0:.1f}s model={args.model}", file=sys.stderr)

    if args.chat:
        return chat_loop(eng, args, sampler)

    t0 = time.time()
    text, stats = eng.generate_text(
        args.prompt if args.prompt is not None else "Hello",
        max_new_tokens=args.n_predict, sampler=sampler, seed=args.seed,
        grammar=args.grammar, json_schema=args.json_schema,
        session_path=args.prompt_cache, session_cache_all=args.prompt_cache_all,
    )
    dt = time.time() - t0
    print(text)
    print(f"[perf] {dt:.2f}s", file=sys.stderr)
    if stats and "session_prefix_reused" in stats:
        print(f"[session] reused {stats['session_prefix_reused']} cached prompt "
              f"tokens from {args.prompt_cache}", file=sys.stderr)
    if stats and "accept_rate" in stats:
        print(
            f"[speculative] accept_rate={stats['accept_rate']:.3f} "
            f"mean_accept_len={stats['mean_accept_len']:.2f} cycles={stats['n_cycles']}",
            file=sys.stderr,
        )
    if stats and "tokens_per_step" in stats:
        print(f"[lookahead] tokens_per_step={stats['tokens_per_step']:.2f} "
              f"n_accept={stats['n_accept']} steps={stats['n_steps']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
