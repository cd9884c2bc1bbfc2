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
