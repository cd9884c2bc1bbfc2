"""The port's cost walker (``launch/cost.py``) against known counts, the
mirror of ``tests/test_hlo_cost.py``, and the kernels' charges.

  * a plain matmul's flops exactly (2 M N K);
  * a loop of L steps costs L times one step, flops and bytes (Python
    loops unroll as they run: the reference's trip-count premise holds
    by construction);
  * nested loops likewise;
  * collective accounting on a fake process group of 4 ranks (in a
    subprocess, as the reference's runs 8 XLA devices in one): a
    ``dist.all_reduce`` of a scalar over the group is one all-reduce of
    2 (S - 1) / S * 4 bytes on the wire, a DTensor's ``full_tensor`` one
    all-gather of (S - 1) / S of the gathered bytes;
  * bytes nonzero and bounded for an elementwise function;
  * one flash-attention call charged the same on the kernel route (its
    wrappers swapped for the plain versions, as the card would run
    them) and on the plain route, forward and backward, and the charge
    the formula's: 4 hd flops a live pair forward, 14 hd backward;
  * a reduced train step counts the same on the CPU and on the meta
    device (the check phase 13g makes between the card and meta).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.kernels import charges, ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import cost  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.tree import tree_map  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")


def test_plain_matmul_flops():
    a, b = torch.ones(128, 256), torch.ones(256, 64)
    totals = cost.analyze(lambda: a @ b)
    assert totals.flops == 2 * 128 * 256 * 64
    assert totals.hbm_bytes == 4 * (128 * 256 + 256 * 64 + 128 * 64)


def test_loop_multiplies_trip_count():
    ws, x = torch.ones(8, 256, 256), torch.ones(128, 256)

    def f(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x.sum()

    one = cost.analyze(f, ws[:1], x)
    eight = cost.analyze(f, ws, x)
    assert eight.flops == 8 * 2 * 128 * 256 * 256 + 8 * 128 * 256 \
        + 128 * 256
    assert eight.flops - 128 * 256 == 8 * (one.flops - 128 * 256)
    assert eight.transcendentals == 8 * one.transcendentals == 8 * 128 * 256


def test_nested_loop():
    ws, x = torch.ones(4, 2, 64, 64), torch.ones(32, 64)

    def f(ws, x):
        for pair in ws:
            for w in pair:
                x = x @ w
        return x

    assert cost.analyze(f, ws, x).flops == 8 * 2 * 32 * 64 * 64


COLLECTIVES = textwrap.dedent("""
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch import cost
    t = cost.analyze(lambda: dist.all_reduce(torch.ones(())))
    assert dict(t.collective_counts) == {"all-reduce": 1}, t
    assert t.collective_wire_bytes == 2 * 3 / 4 * 4, t
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    d = DTensor.from_local(torch.ones(256, 16), mesh, (Shard(0),),
                           run_check=False)
    t = cost.analyze(d.full_tensor)
    assert dict(t.collective_counts) == {"all-gather": 1}, t
    assert t.collective_wire_bytes == 3 / 4 * 1024 * 16 * 4, t
    dist.destroy_process_group()
    print("COLL-OK")
""")


def test_collective_accounting():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", COLLECTIVES],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "COLL-OK" in proc.stdout


def test_bytes_nonzero_and_bounded():
    a = torch.ones(1024, 1024)
    totals = cost.analyze(lambda: (a * 2 + 1).sum())
    nbytes = 1024 * 1024 * 4
    assert nbytes * 0.5 <= totals.hbm_bytes <= nbytes * 10


def _flash_run(q, k, v, grad: bool):
    def f():
        if not grad:
            return ops.flash_attention(q, k, v, window=3)
        leaf = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = ops.flash_attention(*leaf, window=3)
        return torch.autograd.grad(o.square().sum(), leaf)
    return cost.walk(f)


@pytest.mark.parametrize("grad", [False, True])
def test_flash_charge_same_on_both_routes(monkeypatch, grad):
    r = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 7, 4, 8, generator=r),
               torch.randn(2, 9, 2, 8, generator=r),
               torch.randn(2, 9, 2, 8, generator=r))
    plain_out, plain = _flash_run(q, k, v, grad)

    def fwd(q_, k_, v_, *, return_lse=False, **kw):
        o = ref.flash_attention_ref(q_, k_, v_, **kw)
        lse = torch.zeros(q_.shape[0], q_.shape[2],
                          flash_mod.lse_rows(q_.shape[1]))
        return (o, lse) if return_lse else o

    def bwd(q_, k_, v_, o_, do, *, lse=None, **kw):
        return ref.flash_attention_bwd_ref(q_, k_, v_, o_, do, **kw)

    monkeypatch.setattr(ops, "use_kernel", lambda t, backend: True)
    monkeypatch.setattr(flash_mod, "flash_attention_cuda", fwd)
    monkeypatch.setattr(flash_mod, "flash_attention_bwd_cuda", bwd)
    kern_out, kern = _flash_run(q, k, v, grad)
    assert kern.totals.flops == plain.totals.flops
    assert kern.totals.hbm_bytes == plain.totals.hbm_bytes
    assert kern.table == plain.table
    pairs = 2 * 4 * charges.live_pairs(7, 9, True, 3)
    assert charges.live_pairs(7, 9, True, 3) == 3 * 7 - 3
    assert plain.table["kernel.flash_attention"][1] == 4 * 8 * pairs
    if grad:
        assert plain.table["kernel.flash_attention_bwd"][1] == 14 * 8 * pairs
        for a, b in zip(kern_out, plain_out):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    else:
        assert "kernel.flash_attention_bwd" not in plain.table


def test_train_step_counts_the_same_on_cpu_and_meta():
    cfg = get_config("granite-3-8b").reduced(n_layers=2)
    counts = []
    for dev in ("cpu", "meta"):
        model = build_model(cfg, device=dev)
        p = model.init(torch.Generator().manual_seed(0)) if dev == "cpu" \
            else tree_map(lambda x: torch.empty_like(x, device="meta"), p)
        batch = {k: torch.zeros((2, 16), dtype=torch.int32, device=dev)
                 for k in ("tokens", "targets")}
        step = make_train_step(model, RunConfig(microbatches=2))
        _, walker = cost.walk(step, p, optimizer.init(p), batch)
        counts.append((walker.totals.flops, walker.totals.hbm_bytes,
                       walker.table))
    assert counts[0] == counts[1]
    assert counts[0][2]["kernel.flash_attention"][0] == 2 * 2 * 2
    assert counts[0][2]["kernel.flash_attention_bwd"][0] == 2 * 2
