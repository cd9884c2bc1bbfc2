"""Training example on the PyTorch/CUDA port: an xLSTM trained on
synthetic tokens with a checkpoint and a restart, the twin of
``train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]   # reduced
    PYTHONPATH=src python examples/train_lm_torch.py --full          # 125M

It runs on the card by default; ``--device cpu`` runs the plain PyTorch
path.  The run checkpoints into a temporary directory, then a second
call to the entry point resumes from its last checkpoint and trains on.
"""

import argparse
import tempfile

from repro_torch.launch.train import main

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--full", action="store_true",
                help="the full 125M config (default: reduced)")
ap.add_argument("--device", default=None,
                help="torch device (default: cuda)")
args = ap.parse_args()

steps = 300 if args.full else 24
argv = ["--arch", "xlstm-125m", "--batch", "8", "--seq", "128",
        "--ckpt-every", "100" if args.full else "8", "--log-every", "8"]
if not args.full:
    argv.append("--reduced")
if args.device:
    argv += ["--device", args.device]
with tempfile.TemporaryDirectory() as ck:
    main(argv + ["--ckpt-dir", ck, "--steps", str(steps * 2 // 3)])
    main(argv + ["--ckpt-dir", ck, "--steps", str(steps)])
