"""Decode wall time of the port's serving path at MobileLLM-125M's full
width: ``Server`` with the dispatch layer on (a fresh database, so every
op resolves "fixed"), 64-token prompts, 32 generated tokens, at batch 1
and 4 — the N9 cell of ``chip_smoke.py`` phase 6 without its tuner.

It measures whichever ``repro_torch`` comes first on the path, so two trees
are compared by running it once with each tree's ``src`` on
``PYTHONPATH``, alternated (A B B A), on one machine:

    PYTHONPATH=src python tools/serve_decode_ab.py
    PYTHONPATH=../parent/src python tools/serve_decode_ab.py

Prints one JSON line: the package's path, and per batch each round's
decode ms a step and their median. Needs a CUDA device unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics

import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import H100, TuningDatabase
from repro_torch.models.model_zoo import build
from repro_torch.runtime.serve_loop import Server, decode_ops

PROMPT, GEN = 64, 32


def decode_ms(bundle, params, batch: int, rounds: int) -> list[float]:
    """Each round's decode ms a step at ``batch``, after a warm-up round."""
    cfg = bundle.cfg
    prompts = bundle.make_batch(0, ShapeSpec("serve", PROMPT, batch,
                                             "decode"), train=False)["tokens"]
    server = Server(bundle, params, max_len=PROMPT + GEN + 1, hw=H100,
                    serve_ops=decode_ops(cfg, batch),
                    database=TuningDatabase())
    server.generate(prompts, 2)
    return [server.generate(prompts, GEN).decode_s * 1e3 / (GEN - 1)
            for _ in range(rounds)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve_decode_ab: no CUDA device")
    bundle = build(get_config("mobilellm_125m"), remat="none",
                   device=args.device)
    params = bundle.init(torch.Generator().manual_seed(0))
    out = {"package": os.path.dirname(os.path.abspath(repro_torch.__file__))}
    for batch in (1, 4):
        ms = decode_ms(bundle, params, batch, args.rounds)
        out[f"batch{batch}"] = {"decode_ms": ms,
                                "median_ms": statistics.median(ms)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
