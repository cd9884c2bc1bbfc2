"""End-to-end training entry point of the PyTorch/CUDA port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 200 --batch 8 --seq 256 --ckpt-dir build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 4 --batch 4 --seq 64

The port of ``repro.launch.train``, with its CLI and defaults.  The
model is built on this rank's device (CUDA unless ``--device cpu``), its
weights drawn from a ``torch.Generator`` seeded with 0.  The mesh is
``("data", "model")`` of (world, 1) over the default process group (one
of world size 1 is started when there is none, as
``dist.sharding.data_mesh`` does, and ended with the run): the
parameters and AdamW state are laid out by
``dist.sharding.param_shardings``, each step's ``synthetic_batch``
tokens (seeded per (host, step), bitwise the reference's, so a
restarted run sees the same data) by ``batch_shardings``, and the step
is ``make_train_step(model, run_cfg, mesh)``.  It checkpoints
asynchronously every ``--ckpt-every`` steps and at the end (each leaf
whole), and resumes from the latest checkpoint under ``--ckpt-dir``
through ``checkpoint.restore(..., shardings=)``.  As in the reference, a
mid-run checkpoint is named by the index of the step just run (after
step s, for s > 0 a multiple of ``--ckpt-every``) and the last by
``--steps``; a run resumed from a mid-run checkpoint starts at its
index, so that it runs that step again, as the reference's does.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import RunConfig, get_config
from repro_torch.core.pipeline import resolve_device
from repro_torch.dist import sharding as sh
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint, optimizer
from repro_torch.train.elastic import StragglerMonitor
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import tree_map
from .mesh import ensure_process_group, make_mesh


def synthetic_batch(cfg, step: int, batch: int, seq: int, host: int = 0,
                    device=None):
    """Deterministic per-(host, step) token batch: the reference's
    numbers as int32 (fp32 frontend embeddings) tensors on ``device``
    (CUDA unless the caller asks for another)."""
    device = resolve_device(device)
    rng = np.random.default_rng(hash((host, step)) % (2 ** 31))
    F = cfg.frontend_len if (cfg.frontend != "none"
                             and not cfg.is_encdec) else 0
    tokens = rng.integers(0, cfg.vocab, (batch, seq - F), dtype=np.int32)
    tokens = torch.from_numpy(tokens).to(device)
    out = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    if cfg.frontend != "none":
        out["frontend"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.frontend_len, cfg.d_model))
            .astype(np.float32)).to(device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    run_cfg = RunConfig(lr=args.lr, microbatches=args.microbatches,
                        total_steps=args.steps,
                        warmup_steps=max(1, args.steps // 10))
    started = not dist.is_initialized()
    try:
        return _run(args, cfg, model, run_cfg)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _place(tree, shardings):
    return tree_map(lambda x, s: s.place(x), tree, shardings)


def _run(args, cfg, model, run_cfg):
    world = ensure_process_group(model.device)
    mesh = make_mesh((world, 1), ("data", "model"), device=model.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    opt_state = optimizer.init(params)
    layout = sh.param_shardings((params, opt_state), mesh)
    params, opt_state = _place((params, opt_state), layout)

    start_step = 0
    ckpt = checkpoint.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir \
        else None
    if ckpt and checkpoint.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start_step, _ = checkpoint.restore(
            (params, opt_state), args.ckpt_dir, shardings=layout)
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(model, run_cfg, mesh)
    monitor = StragglerMonitor()

    metrics = {}
    t_start = time.time()
    try:
        for step in range(start_step, args.steps):
            batch = synthetic_batch(cfg, step, args.batch, args.seq,
                                    device=model.device)
            batch = _place(batch, sh.batch_shardings(mesh, batch))
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            monitor.record(0, time.time() - t0)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"gnorm {metrics['grad_norm']:.3f} "
                      f"lr {metrics['lr']:.2e} "
                      f"({time.time() - t0:.2f}s/step)")
            if ckpt and step > 0 and step % args.ckpt_every == 0:
                ckpt.save((params, opt_state), step)
        if ckpt:
            ckpt.save((params, opt_state), args.steps)
    finally:
        if ckpt:
            ckpt.wait()
    print(f"done: {args.steps - start_step} steps in "
          f"{time.time() - t_start:.1f}s")
    return metrics


if __name__ == "__main__":
    main()
