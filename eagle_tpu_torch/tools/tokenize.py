"""llama-tokenize equivalent: print the token stream of a prompt (port of
eagle_tpu/tools/tokenize.py). Reads only the GGUF's metadata; no device.

  python -m eagle_tpu_torch.tools.tokenize -m model.gguf -p "text" [--ids] [--no-bos]"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ..utils.args import build_parser, check_refused

    ap = build_parser("tokenize")
    ap.add_argument("-f", "--file", default=None)
    ap.add_argument("--ids", action="store_true", help="ids only, one line")
    ap.add_argument("--no-bos", action="store_true")
    args = ap.parse_args(argv)
    check_refused(args, "tokenize")

    from ..gguf.reader import GGUFReader
    from ..tokenizer import tokenizer_from_gguf_metadata

    if args.prompt is not None:
        text = args.prompt
    else:
        with open(args.file) as f:
            text = f.read()
    with GGUFReader(args.model) as reader:
        tok = tokenizer_from_gguf_metadata(reader.metadata)
    ids = tok.encode(text, add_bos=not args.no_bos)
    if args.ids:
        print(" ".join(str(i) for i in ids))
        return 0
    for i in ids:
        print(f"{i:>8} -> {tok.decode([i])!r}")
    print(f"# {len(ids)} tokens", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
