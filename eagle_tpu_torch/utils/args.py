"""The declarative option registry of the command-line tools (port of the
rows of eagle_tpu/utils/args.py that its `cli`, `server` and `tokenize`
tools materialize, with `build_parser`, `sampler_from_args`,
`sampler_from_request` and `apply_log_args`).

Every option is one `Opt` row: flags, type / default / choices / help, an
EAGLE_ARG_<NAME> environment fallback (explicit flag > environment >
declared default) and the tools that take it. The port adds `--device`
(its counterpart of `--backend`). The flags of features the port does not
have yet stay in the parser with `refused` naming their ROADMAP item:
`check_refused` raises NotImplementedError when one is given, so a
reference command line either runs or names what is missing."""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any

from ..server.chat_templates import JINJA_REFUSED


@dataclasses.dataclass(frozen=True)
class Opt:
    """One declarative option row."""

    flags: tuple[str, ...]
    help: str = ""
    type: Any = None
    default: Any = None
    choices: tuple | None = None
    action: str | None = None  # "store_true" / "store_false"
    metavar: str | None = None
    required: bool = False
    #: tool-name mask; None = common (every tool)
    tools: tuple[str, ...] | None = None
    #: EAGLE_ARG_<NAME> fallback; None disables
    env: str | None = ""
    #: what the port lacks for this flag (a ROADMAP item), when it lacks it
    refused: str | None = None

    @property
    def dest(self) -> str:
        long = next((f for f in self.flags if f.startswith("--")), self.flags[-1])
        return long.lstrip("-").replace("-", "_")

    @property
    def env_name(self) -> str | None:
        if self.env is None:
            return None
        return f"EAGLE_ARG_{(self.env or self.dest).upper()}"

    def resolve_default(self):
        """EAGLE_ARG_<NAME> overrides the declared default (never an
        explicit flag)."""
        v = os.environ.get(self.env_name) if self.env_name else None
        if v is None:
            return self.default
        if self.action in ("store_true", "store_false"):
            return v not in ("0", "false", "")
        return (self.type or str)(v)


TOOLS = ("cli", "server", "tokenize")

_LORA = "LoRA adapters (ROADMAP queue 1, item 9)"
_CS = ("cli", "server")

REGISTRY: tuple[Opt, ...] = (
    # ---- model / runtime --------------------------------------------------
    Opt(("-m", "--model"), "target GGUF path", required=True,
        tools=("cli", "server", "tokenize")),
    Opt(("--ctx",), "context length", type=int, default=2048, tools=_CS),
    Opt(("--device",), "device: the card (cuda) or the plain PyTorch path (cpu)",
        default="cuda", choices=("cuda", "cpu"), tools=_CS),
    Opt(("--backend",), "the reference's compute backend", choices=(None, "xla", "pallas"),
        refused="the reference's XLA / Pallas choice: the port runs its CUDA kernels "
                "(--device cuda) or their plain versions (--device cpu)"),
    Opt(("--lora",), "LoRA adapter GGUF (merged at load)", tools=_CS, refused=_LORA),
    Opt(("--lora-scale",), "LoRA alpha override", type=float, tools=_CS, refused=_LORA),
    # ---- speculation ------------------------------------------------------
    Opt(("--draft",), "EAGLE draft GGUF (enables speculation)", tools=_CS),
    Opt(("--n-draft",), "chain draft length", type=int, default=5, tools=_CS),
    Opt(("--cycles-per-dispatch",), "speculative cycles chained per dispatch (one CUDA "
        "graph replay on the card)", type=int, default=1, tools=_CS),
    Opt(("--tree",), "tree branching factors, e.g. 4,2,2", tools=_CS),
    Opt(("--tree2",), "EAGLE-2 dynamic draft tree, e.g. 8,6,32",
        metavar="BEAM,DEPTH,NVERIFY", tools=("cli",)),
    Opt(("--lookahead",), "model-free lookahead decoding (W,N,G); greedy: needs --temp 0",
        metavar="W,N,G", tools=("cli",)),
    Opt(("--feature-source",), "EAGLE feature tap", default="pre_norm",
        choices=("pre_norm", "post_norm"), tools=_CS),
    # ---- sampling (the server's per-request overrides read these rows) ------
    Opt(("--temp",), "sampling temperature", type=float, default=0.8, tools=_CS),
    Opt(("--top-k",), "top-k", type=int, default=40, tools=_CS),
    Opt(("--top-p",), "top-p", type=float, default=0.95, tools=_CS),
    Opt(("--min-p",), "min-p", type=float, default=0.05, tools=_CS),
    Opt(("--repeat-penalty",), "repetition penalty (1.0: off)", type=float, default=1.0,
        tools=_CS),
    Opt(("--seed",), "sampling seed", type=int, default=0, tools=("cli",)),
    # ---- generation / prompt ------------------------------------------------
    Opt(("-p", "--prompt"), "prompt text", tools=("cli", "tokenize")),
    Opt(("-n", "--n-predict"), "tokens to generate", type=int, default=128, tools=("cli",)),
    Opt(("--grammar",), "GBNF grammar constraining output", tools=_CS),
    Opt(("--json-schema",), "JSON schema (its JSON text) constraining output", tools=("cli",)),
    Opt(("--prompt-cache",), "session file: save/resume the prompt's KV state "
        "(main.cpp --prompt-cache)", tools=("cli",)),
    Opt(("--prompt-cache-all",), "also cache generated output in the session",
        action="store_true", tools=("cli",)),
    # ---- chat ---------------------------------------------------------------
    Opt(("--chat",), "interactive conversation mode", action="store_true", tools=("cli",)),
    Opt(("--system",), "system prompt (chat mode)", tools=("cli",)),
    Opt(("--chat-template",), "built-in chat template name", tools=("cli",)),
    Opt(("--jinja",), "execute the GGUF's embedded jinja chat template",
        action="store_true", tools=_CS, refused=JINJA_REFUSED),
    # ---- server -------------------------------------------------------------
    Opt(("--host",), "bind address", default="0.0.0.0", tools=("server",)),
    Opt(("--port",), "port", type=int, default=8080, tools=("server",)),
    Opt(("--parallel", "-np"), "number of server slots (continuous batching)",
        type=int, default=1, tools=("server",), env="n_parallel"),
    Opt(("--paged",), "serve KV from a shared page pool with prefix reuse",
        action="store_true", tools=("server",)),
    Opt(("--kv-pages",), "page-pool size (< batch*ctx/page-size oversubscribes)",
        type=int, tools=("server",)),
    Opt(("--page-size",), "KV page size", type=int, default=64, tools=("server",)),
    # ---- logging ------------------------------------------------------------
    Opt(("--log-level",), "log verbosity", choices=(None, "error", "warn", "info", "debug")),
    Opt(("--log-file",), "log destination file"),
)


def _rows(tool: str):
    assert tool in TOOLS, tool
    return [o for o in REGISTRY if o.tools is None or tool in o.tools]


def build_parser(tool: str, prog: str | None = None,
                 description: str | None = None) -> argparse.ArgumentParser:
    """`tool`'s parser from the registry, with EAGLE_ARG_* fallbacks resolved
    into the defaults; a `required` row is met by its variable."""
    ap = argparse.ArgumentParser(prog or f"eagle-tpu-torch {tool}", description=description)
    for opt in _rows(tool):
        kw: dict[str, Any] = {"help": opt.help or None, "dest": opt.dest}
        default = opt.resolve_default()
        if opt.action:
            kw["action"] = opt.action
            if default is not None:
                kw["default"] = default
        else:
            kw.update(type=opt.type, default=default, choices=opt.choices, metavar=opt.metavar)
            if opt.required and default is None:
                kw["required"] = True
            kw = {k: v for k, v in kw.items() if v is not None or k == "default"}
        if opt.env_name and kw.get("help"):
            kw["help"] = f"{kw['help']} [{opt.env_name}]"
        ap.add_argument(*opt.flags, **kw)
    return ap


def check_refused(args: argparse.Namespace, tool: str) -> None:
    """Raise NotImplementedError for the first given flag (one away from its
    default) that the port does not have yet, naming what is missing."""
    for opt in _rows(tool):
        if opt.refused and getattr(args, opt.dest, opt.default) not in (opt.default, False):
            raise NotImplementedError(f"{opt.flags[-1]}: {opt.refused}")


#: CLI dest -> SamplerConfig field
SAMPLING_ARG_FIELDS = {
    "temp": "temperature",
    "top_k": "top_k",
    "top_p": "top_p",
    "min_p": "min_p",
    "repeat_penalty": "penalty_repeat",
}


def sampler_from_args(args):
    """SamplerConfig from parsed registry args (greedy iff temp <= 0)."""
    from ..runtime.sampling import SamplerConfig

    return SamplerConfig(
        **{f: getattr(args, d) for d, f in SAMPLING_ARG_FIELDS.items()},
        greedy=args.temp <= 0,
    )


#: request-JSON key -> (SamplerConfig field, cast): the server API's names
#: for the same parameters as the flags
SAMPLING_REQUEST_KEYS = {
    "temperature": ("temperature", float),
    "top_k": ("top_k", int),
    "top_p": ("top_p", float),
    "min_p": ("min_p", float),
    "repeat_penalty": ("penalty_repeat", float),
}


def sampler_from_request(body: dict, default):
    """A request's SamplerConfig: `default` with the request's overrides;
    greedy iff the effective temperature is <= 0."""
    upd = {f: cast(body[key]) for key, (f, cast) in SAMPLING_REQUEST_KEYS.items() if key in body}
    cfg = dataclasses.replace(default, **upd) if upd else default
    return dataclasses.replace(cfg, greedy=cfg.temperature <= 0.0)


def apply_log_args(args) -> None:
    from .logging import setup_logging

    if getattr(args, "log_level", None) or getattr(args, "log_file", None):
        setup_logging(level=args.log_level, log_file=args.log_file)
