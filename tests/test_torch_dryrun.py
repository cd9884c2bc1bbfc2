"""One-cell integration test of the port's multi-pod dry run
(``repro_torch.launch.dryrun``), the mirror of
``tests/test_dryrun_smoke.py``: the cheapest cell on a fake process
group of 512 ranks, in a subprocess (the dry run starts its own group),
with the reference test's assertions, the roofline's keys the
reference's and the walker's per-op table written beside the record."""

import gzip
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = str(Path(__file__).resolve().parent.parent / "src")
ROOFLINE_KEYS = {"t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                 "hlo_flops_per_dev", "hbm_bytes_per_dev",
                 "wire_bytes_per_dev", "collective_counts",
                 "model_flops_per_dev", "useful_flops_ratio"}


def test_dryrun_one_cell():
    env = dict(os.environ, PYTHONPATH=SRC)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", "xlstm-125m", "--shape", "decode_32k",
             "--mesh", "multi", "--out", out],
            capture_output=True, text=True, env=env, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "dry-run complete: 1/1 cells OK" in proc.stdout
        rec = json.load(open(
            os.path.join(out, "xlstm-125m__decode_32k__multi.json")))
        assert rec["ok"], rec
        assert rec["n_devices"] == 512
        assert rec["mesh"] == "2x16x16"
        assert rec["hw"] == "NVIDIA H100 80GB HBM3"
        ro = rec["roofline"]
        assert set(ro) == ROOFLINE_KEYS
        assert ro["t_memory_s"] > 0 and ro["hlo_flops_per_dev"] > 0
        assert ro["t_memory_s"] == ro["hbm_bytes_per_dev"] / 3.35e12
        assert ro["collective_counts"].get("all-gather", 0) > 0
        assert rec["fits_hbm"] is True
        assert 0 < rec["memory"]["peak_bytes"] < 80e9
        with gzip.open(os.path.join(
                out, "xlstm-125m__decode_32k__multi.ops.jsonl.gz"),
                "rt") as f:
            rows = [json.loads(line) for line in f]
        assert sum(r["flops"] for r in rows) == ro["hlo_flops_per_dev"]


SPLIT_STEP = r"""
import json
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import RunConfig, get_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import cost
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import build_model
from repro_torch.train import optimizer
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import tree_map

DATA, T = 2, 4
sh._MIN_SHARD_ELEMS = 512
cfg = get_config("granite-3-8b").reduced(n_layers=2, n_kv_heads=4)
dist.init_process_group("fake", store=FakeStore(), rank=0,
                        world_size=DATA * T)
mesh = make_mesh((DATA, T), ("data", "model"), device="cpu")
rc = RunConfig(microbatches=2)


def products(walker):
    return sum(v[1] for k, v in walker.table.items()
               if k.startswith(("aten.mm", "aten.bmm", "kernel.flash")))


with FakeTensorMode(allow_non_fake_inputs=True):
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = optimizer.init(params)
    batch = {k: torch.zeros((8, 64), dtype=torch.int32)
             for k in ("tokens", "targets")}
    # the whole step on one data rank's rows, unplaced
    _, whole = cost.walk(make_train_step(model, rc), params, opt,
                         {k: v[:8 // DATA] for k, v in batch.items()})
    state = tree_map(lambda x, s: s.place(x), (params, opt),
                     sh.param_shardings((params, opt), mesh))
    placed = tree_map(lambda x, s: s.place(x), batch,
                      sh.batch_shardings(mesh, batch))
    _, split = cost.walk(make_train_step(model, rc, mesh), *state, placed)
dist.destroy_process_group()
print(json.dumps(dict(whole=products(whole), split=products(split),
                      collectives=dict(split.totals.collective_counts))))
"""


def test_dryrun_split_step_divides_the_products_by_t():
    """A reduced granite (2 layers, 4 heads, 4 kv heads) traced on a fake
    group of 8 ranks, a ("data", "model") (2, 4) mesh: rank 0's flops in
    the layers' products and the flash kernels' charges, within 10% of
    the unplaced step's on one data rank's rows divided by t = 4."""
    env = dict(os.environ, PYTHONPATH=SRC)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, "-c", SPLIT_STEP],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = got["whole"] / 4
    assert abs(got["split"] - want) <= 0.1 * want, got
    assert got["collectives"].get("all-to-all", 0) > 0
