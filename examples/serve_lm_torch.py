"""Serving example on the PyTorch/CUDA port: continuous batching over a
reduced zoo arch, the twin of ``serve_lm.py``.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch ARCH] [--device cpu]

It runs on the card by default; ``--device cpu`` runs the plain PyTorch
path (a few seconds).  Any arch of ``repro_torch.configs.ARCH_IDS``
serves (granite-3-8b by default); ``--kv-quant`` gives a decoder-only
transformer int8 KV caches.
"""

import argparse

from repro_torch.launch.serve import main

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--arch", default="granite-3-8b")
ap.add_argument("--device", default=None,
                help="torch device (default: cuda)")
ap.add_argument("--kv-quant", action="store_true")
args = ap.parse_args()

argv = ["--arch", args.arch, "--reduced", "--requests", "6", "--slots", "3",
        "--prompt-len", "10", "--max-new", "6"]
if args.device:
    argv += ["--device", args.device]
if args.kv_quant:
    argv.append("--kv-quant")
main(argv)
