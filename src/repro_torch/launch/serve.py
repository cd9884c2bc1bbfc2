"""Serving driver: the continuous-batching engine over a dense zoo arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
        --reduced --device cpu

The port of ``repro.launch.serve``.  The weights are initialised on the
device from a ``torch.Generator`` seeded with 0; the model runs
on CUDA unless ``--device cpu`` is given, and the driver raises when
there is no card and no ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    params = model.init(gen)
    engine = ServeEngine(model, params, n_slots=args.slots, max_len=128)

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        r = Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.max_new)
        reqs.append(r)
        engine.submit(r)

    t0 = time.perf_counter()
    engine.run()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in reqs)
    print(f"served {len(reqs)} requests, {total_tokens} tokens, "
          f"{engine.steps} engine steps, {dt:.2f}s "
          f"({total_tokens / max(dt, 1e-9):.1f} tok/s) on {model.device}")
    for r in reqs[:3]:
        print(f"  req {r.uid}: {r.output}")
    if not all(r.done for r in reqs):
        raise RuntimeError("the engine stopped with requests not done")
    return reqs


if __name__ == "__main__":
    main()
