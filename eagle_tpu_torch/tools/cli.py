"""Command-line generation, the llama-cli equivalent (port of
eagle_tpu/tools/cli.py:main, without the chat loop).

Usage:
  python -m eagle_tpu_torch.tools.cli -m model.gguf -p "prompt" [-n 128]
      [--draft eagle.gguf] [--tree 4,2,2 | --tree2 8,6,32] [--temp 0.8]
      [--top-k 40] [--top-p 0.95] [--min-p 0.05] [--seed 0] [--device cuda]

Prints the text on stdout and `[load]`, `[perf]` and, with a draft,
`[speculative] accept_rate=... mean_accept_len=... cycles=...` on stderr,
as the reference does. It runs on the card unless `--device cpu`."""

from __future__ import annotations

import sys
import time


def build_argparser():
    from ..utils.args import build_parser

    return build_parser("cli")


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
        max_seq=args.ctx,
        feature_source=args.feature_source,
        sampler=sampler,
        device=args.device,
    )
    t0 = time.time()
    eng = Engine(cfg)
    print(f"[load] {time.time() - t0:.1f}s model={args.model}", file=sys.stderr)

    t0 = time.time()
    text, stats = eng.generate_text(
        args.prompt if args.prompt is not None else "Hello",
        max_new_tokens=args.n_predict, sampler=sampler, seed=args.seed,
    )
    dt = time.time() - t0
    print(text)
    print(f"[perf] {dt:.2f}s", file=sys.stderr)
    if stats and "accept_rate" in stats:
        print(
            f"[speculative] accept_rate={stats['accept_rate']:.3f} "
            f"mean_accept_len={stats['mean_accept_len']:.2f} cycles={stats['n_cycles']}",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
