"""The port's cluster launcher and production mesh against the JAX
package's.

  * ``launch/cluster.py``: ``simulate_failure_recovery``'s plans equal
    the reference's for its defaults and three other ``kill``/``straggle``
    sets, ``largest_mesh`` for every device count from 16 to 1024,
    ``worker_cmd`` (the port's module in place of the reference's), the
    ``simulate`` CLI, and the ``worker`` CLI on one host: it joins a gloo
    group at the coordinator and runs its inner command with the
    ``env://`` rendezvous of the next port, which
    ``launch.mesh.ensure_process_group`` joins.
  * ``launch/mesh.make_production_mesh``: the reference's shapes and axis
    names over a fake process group of 256 and of 512 ranks
    (``torch.testing._internal.distributed.fake_pg``, in a subprocess, so
    that this process's group is never touched), the placement rules on
    that ``DeviceMesh`` those of the ``AbstractMesh``; a plain error, and
    no group started, in a process of another size.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.launch import cluster as jcluster  # noqa: E402

import torch.distributed as dist  # noqa: E402

from repro_torch.launch import cluster  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")

FAKE = textwrap.dedent("""
    import json
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_production_mesh
    tree = {"embed": torch.empty((49280, 4096), device="meta"),
            "layers": [{"w": torch.empty((4096, 12800), device="meta"),
                        "b": torch.empty((4096,), device="meta")}] * 4,
            "ln": torch.empty((4096,), device="meta")}
    import os, socket
    from repro_torch.launch.mesh import ensure_process_group
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE="1", RANK="0")
    env_group = [ensure_process_group("cpu"), dist.get_backend()]
    dist.destroy_process_group()
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        del os.environ[k]
    out = [env_group]
    for world, pod in ((256, False), (512, True)):
        dist.init_process_group("fake", store=FakeStore(), rank=3,
                                world_size=world)
        m = make_production_mesh(multi_pod=pod, device="cpu")
        a = sh.AbstractMesh(m.shape, m.mesh_dim_names)
        same = sh.param_specs(tree, m) == sh.param_specs(tree, a)
        out.append(dict(world=world, shape=list(m.shape), same=same,
                        names=list(m.mesh_dim_names),
                        coords=list(m.get_coordinate())))
        dist.destroy_process_group()
    print(json.dumps(out))
""")

# the worker's inner command: the rendezvous it is handed
INNER = ("import os; print('inner', *(os.environ[k] for k in ('MASTER_ADDR', "
         "'MASTER_PORT', 'WORLD_SIZE', 'RANK')))")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def procs():
    """The fake-group script and a one-host worker, run side by side."""
    env = dict(os.environ, PYTHONPATH=SRC, GLOO_SOCKET_IFNAME="lo")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    port = _free_port()
    fake = subprocess.Popen([sys.executable, "-c", FAKE], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    work = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.cluster", "worker",
         "--coordinator", f"localhost:{port}", "--num-hosts", "1",
         "--host-id", "0", "--", sys.executable, "-c", INNER], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {"port": port}
    for name, p in (("fake", fake), ("worker", work)):
        stdout, stderr = p.communicate(timeout=240)
        out[name] = (p.returncode, stdout, stderr)
    return out


KILL_STRAGGLE = [dict(), dict(kill=(), straggle=()),
                 dict(kill=(0, 5), straggle=(9,)),
                 dict(n_hosts=8, chips_per_host=16, kill=(2,),
                      straggle=(1, 4, 6))]


@pytest.mark.parametrize("kw", KILL_STRAGGLE)
def test_simulate_failure_recovery_plans_are_the_references(kw):
    got = cluster.simulate_failure_recovery(**kw)
    assert got == jcluster.simulate_failure_recovery(**kw)
    if kw.get("kill", (3,)):
        assert any(p["action"] == "remesh" for p in got)


def test_largest_mesh_is_the_references():
    for n in range(16, 1025):
        assert cluster.largest_mesh(n) == jcluster.largest_mesh(n), n
    assert cluster.largest_mesh(40, model=8, pod_size=16) == \
        jcluster.largest_mesh(40, model=8, pod_size=16)
    with pytest.raises(AssertionError):
        cluster.largest_mesh(8)


def test_worker_cmd_names_the_port():
    inner = ["python", "-m", "repro_torch.launch.train", "--steps", "3"]
    got = cluster.worker_cmd("h0:29500", 128, 7, inner)
    want = jcluster.worker_cmd("h0:29500", 128, 7, inner)
    assert got[:3] == ["python", "-m", "repro_torch.launch.cluster"]
    assert got[3:] == want[3:]


def test_simulate_cli_prints_the_plans(capsys):
    cluster.main(["simulate"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [str(p) for p in jcluster.simulate_failure_recovery()]


def test_worker_cli_runs_the_inner_command_in_its_group(procs):
    code, out, err = procs["worker"]
    assert code == 0, err[-2000:]
    port = procs["port"]
    assert f"inner localhost {port + 1} 1 0" in out


def test_production_mesh_under_fake_groups(procs):
    import json
    code, out, err = procs["fake"]
    assert code == 0, err[-2000:]
    env_group, *got = json.loads(out.strip().splitlines()[-1])
    assert env_group == [1, "gloo"]
    assert [(g["world"], g["shape"], g["names"]) for g in got] == [
        (256, [16, 16], ["data", "model"]),
        (512, [2, 16, 16], ["pod", "data", "model"])]
    assert all(g["same"] for g in got)
    assert got[0]["coords"] == [0, 3] and got[1]["coords"] == [0, 0, 3]


def test_production_mesh_refuses_another_size():
    had = dist.is_initialized()
    for pod in (False, True):
        with pytest.raises(ValueError, match="needs (256|512) ranks"):
            make_production_mesh(multi_pod=pod, device="cpu")
    assert dist.is_initialized() == had
