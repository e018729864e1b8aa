"""Command-line entry points of the port.

Counterpart of ``scratchpad_tpu/cli/sp.py`` (argparse):

    python -m scratchpad_tpu_torch.cli.sp serve --preset llama-3.2-1b --random-weights
    python -m scratchpad_tpu_torch.cli.sp chat --model-path ...
    python -m scratchpad_tpu_torch.cli.sp eval --eval-data rows.jsonl [--base-url URL]
    python -m scratchpad_tpu_torch.cli.sp version

Every ``ServerArgs`` field is a flag (``--page-size 4``, ``--no-enable-metrics``;
``--tp-size 2`` serves on two tensor-parallel processes);
``--device`` defaults to ``cuda`` and raises where no card exists (``--device
cpu`` runs the plain PyTorch path). There is no ``benchmark`` subcommand: the
port's benchmark comes with ``bench_gpu.py`` (ROADMAP Queue 1, item 1).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from scratchpad_tpu_torch.config import ServerArgs


def _serve(args: argparse.Namespace) -> None:
    from scratchpad_tpu_torch.server.http_server import launch_server

    launch_server(ServerArgs.from_cli_args(args))


def _chat(args: argparse.Namespace) -> None:
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
    from scratchpad_tpu_torch.server.engine import Engine

    engine = Engine(ServerArgs.from_cli_args(args))
    print("interactive chat; /exit to quit")
    history = []
    while True:
        try:
            user = input("you> ")
        except (EOFError, KeyboardInterrupt):
            break
        if user.strip() in ("/exit", "/quit"):
            break
        history.append({"role": "user", "content": user})
        tok = engine.tokenizer
        if tok is not None and getattr(tok, "chat_template", None):
            prompt = tok.apply_chat_template(history, tokenize=False, add_generation_prompt=True)
        else:
            prompt = "\n".join(f"{m['role']}: {m['content']}" for m in history)
        print("assistant> ", end="", flush=True)
        text = ""
        for chunk in engine.generate_stream(
            prompt=prompt, sampling_params=SamplingParams(temperature=0.7, max_new_tokens=512)
        ):
            sys.stdout.write(chunk["delta"])
            sys.stdout.flush()
            text += chunk["delta"]
        print()
        history.append({"role": "assistant", "content": text})


class _HttpScorer:
    """``Engine.score``'s interface over a server's echo + logprobs
    completions."""

    def __init__(self, base_url: str):
        from scratchpad_tpu_torch.utils.client import post_json

        self.url = base_url.rstrip("/") + "/v1/completions"
        self._post = post_json

    def score(self, input_ids):
        out = self._post(
            self.url,
            {"model": "model", "prompt": [list(map(int, input_ids))], "max_tokens": 0,
             "echo": True, "logprobs": 1},
            timeout=600,
        )
        lps = out["choices"][0]["logprobs"]["token_logprobs"]
        return [float(x) for x in lps if x is not None]


def _eval(args: argparse.Namespace) -> None:
    """Offline evaluation: JSONL rows of {"text"} or {"input_ids"} (corpus
    perplexity) or {"context", "choices", "label"} (multiple choice ranked
    by loglikelihood), scored by a local engine or, with ``--base-url``, by
    a running server."""
    from scratchpad_tpu_torch.server.engine import Engine

    if args.base_url:
        engine, tok = _HttpScorer(args.base_url), None
    else:
        engine = Engine(ServerArgs.from_cli_args(args))
        tok = engine.tokenizer
    with open(args.eval_data) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    if args.limit:
        rows = rows[: args.limit]

    def encode(text):
        if tok is None:
            raise SystemExit("text rows need a tokenizer (--tokenizer-path); send *_ids rows")
        return tok.encode(text)

    if rows and ("choices" in rows[0] or "choices_ids" in rows[0]):
        correct = 0
        for r in rows:
            ctx = list(r["context_ids"]) if "context_ids" in r else encode(r["context"])
            chs = (
                [list(c) for c in r["choices_ids"]]
                if "choices_ids" in r
                else [encode(c) for c in r["choices"]]
            )
            scores = [sum(engine.score(ctx + ch)[max(len(ctx) - 1, 0):]) for ch in chs]
            correct += int(max(range(len(scores)), key=scores.__getitem__) == r["label"])
        print(json.dumps({"metric": "accuracy", "value": correct / max(len(rows), 1), "n": len(rows)}))
        return
    total_lp, total_tok = 0.0, 0
    for r in rows:
        ids = list(r["input_ids"]) if "input_ids" in r else encode(r["text"])
        if len(ids) < 2:
            continue
        lps = engine.score(ids)
        total_lp += sum(lps)
        total_tok += len(lps)
    ppl = math.exp(-total_lp / max(total_tok, 1))
    print(json.dumps({"metric": "perplexity", "value": ppl, "tokens": total_tok}))


def _version(args) -> None:
    import scratchpad_tpu_torch

    print(scratchpad_tpu_torch.__version__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="sp")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, fn in (("serve", _serve), ("chat", _chat)):
        p = sub.add_parser(name)
        ServerArgs.add_cli_args(p)
        p.set_defaults(func=fn)
    pe = sub.add_parser("eval")
    ServerArgs.add_cli_args(pe)
    pe.add_argument("--eval-data", required=True, help="JSONL: {'text'} or {'context','choices','label'}")
    pe.add_argument("--limit", type=int, default=0)
    pe.add_argument("--base-url", default=None, help="score through a running server")
    pe.set_defaults(func=_eval)
    sub.add_parser("version").set_defaults(func=_version)
    return parser


def main(argv=None) -> None:
    ns = build_parser().parse_args(argv)
    ns.func(ns)


if __name__ == "__main__":
    main()
