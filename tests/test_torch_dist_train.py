"""The port's distributed training (``make_train_step(..., mesh)``,
``dist.sharding``'s parameter and batch placement,
``compression.psum_compressed``, ``elastic.remesh``,
``checkpoint.save``/``restore(shardings=)``) against the step without a
mesh and against JAX's single-device step, on the CPU under gloo.

  * World size 1, in the test process (a ("data", "model") (1, 1) gloo
    mesh, started here when the process has no group and ended after
    the module): the placed step is bitwise the step without a mesh,
    with and without microbatches and int8 compression; so are
    ``psum_compressed`` and ``compress_tree``; checkpoints of the plain
    and the placed state read each other bitwise; ``remesh`` onto a
    ("data",) mesh keeps every value; ``hints.constrain`` redistributes a
    DTensor to its binding.
  * World size 4, one spawned group (``tests/torch_dist_worker.py``,
    task ``train4``; the ranks import torch and ``repro_torch`` only):
    the reduced granite-3-8b (2 layers, fp32, global batch 4, lr 1e-5)
    trained 2 steps on (4, 1), (2, 2) and (1, 4) meshes (and on (2, 2)
    with the parameters TP-sharded only, ``weights_mode="tp_only"``, the
    moments 2-D: ZeRO-1; on (1, 4) also a granite of 2 heads and 1 kv
    head, fewer heads than model ranks), with leaves of 512
    elements and up sharded (the reduced model's leaves are all under
    the real 65536), against JAX's jitted single-device step from the
    same weights on the same batches, each rank's flash calls seeing
    its H / t heads (one where H < t) and its MLP products d_ff / t
    columns; placed prefill and decode on (2, 2) (granite, also with
    int8 caches, and gemma3-4b's window rings; caches split by sequence
    over the model ranks, both holding entries) within 1e-6 of the
    unplaced model; ``remesh`` and a checkpoint from
    (4, 1) onto (2, 2); the plain run's checkpoint read onto (4, 1) and
    the mesh run's read plain; ``psum_compressed`` over the data axis;
    a leaf sharded over ("pod", "data") split rank by rank as JAX splits
    it (a 4-device JAX subprocess).

Tolerances: loss, gradient norm and every parameter within 1e-6 of
JAX's (times max(1, |value|) for the norm, about 3.6: fp32 sums in
another order), with ``compress_grads`` every parameter within 3e-5
(3 lr: an element within rounding of a half-quantum boundary takes
either int8 level, as in ``test_train_step_matches_jax``); the sum of
four ranks' quantized gradients within 1e-6 relative of numpy's (the
all-reduce's order).
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_zoo as zoo  # noqa: E402
from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import compression as jcomp  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.train import optimizer as joptim  # noqa: E402
from repro.train.train_step import make_train_step as jmake  # noqa: E402

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.dist import compression, hints  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train import checkpoint, elastic, optimizer  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.tree import leaves, tree_map  # noqa: E402

import torch_dist_worker as worker  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
LR = 1e-5


def _place(tree, shardings):
    return tree_map(lambda x, s: s.place(x), tree, shardings)


def _batches(cfg, n, B, T, seed):
    r = np.random.default_rng(seed)
    return [{k: r.integers(0, cfg.vocab, (B, T)).astype(np.int32)
             for k in ("tokens", "targets")} for _ in range(n)]


def _same(a, b) -> bool:
    return all(torch.equal(sh.whole(x), sh.whole(y))
               for x, y in zip(leaves(a), leaves(b)))


@pytest.fixture(scope="module")
def granite():
    cfg = get_config("granite-3-8b").reduced(n_layers=2)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# world size 1, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh1():
    """A ("data", "model") (1, 1) gloo mesh; the group it starts (when the
    process has none) ends with the module."""
    started = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    yield mesh
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("m", [1, 2])
def test_world1_placed_step_is_bitwise_unplaced(mesh1, granite, m,
                                                compress):
    cfg, model, p0 = granite
    rc = RunConfig(lr=1e-3, warmup_steps=1, total_steps=10, microbatches=m,
                   compress_grads=compress)
    plain = make_train_step(model, rc)
    placed = make_train_step(model, rc, mesh1)
    state = (p0, optimizer.init(p0))
    p, o = state
    pm, om = _place(state, sh.param_shardings(state, mesh1))
    for b in _batches(cfg, 2, 4, 12, seed=30 + m):
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        p, o, want = plain(p, o, b)
        pm, om, got = placed(pm, om, _place(b, sh.batch_shardings(mesh1, b)))
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(isinstance(x, DTensor) for x in leaves((pm, om)))
    assert _same((pm, om), (p, o))


def test_world1_psum_compressed_is_compress_tree(mesh1, granite):
    """On one rank the all-reduce is a copy: bitwise ``compress_tree``,
    with one scale per leaf across the stacked layers."""
    cfg, model, p0 = granite
    r = np.random.default_rng(3)
    g = tree_map(lambda p: torch.from_numpy(
        (r.normal(size=p.shape) * 1e-3).astype(np.float32)), p0)
    got = compression.psum_compressed(g, "data", mesh1, model.stacked)
    assert _same(got, compression.compress_tree(g, model.stacked))


def test_world1_checkpoints_plain_and_placed_interchange(mesh1, granite,
                                                        tmp_path):
    _, model, p0 = granite
    state = (p0, optimizer.init(p0))
    layout = sh.param_shardings(state, mesh1)
    placed = _place(state, layout)
    checkpoint.save(placed, str(tmp_path / "m"), 3)
    checkpoint.save(state, str(tmp_path / "p"), 3)
    for d in ("m", "p"):
        a = np.load(tmp_path / d / "step_000000003" / "arrays" / "0.npy")
        assert a.shape == tuple(leaves(state)[0].shape)
        plain, step, _ = checkpoint.restore(state, str(tmp_path / d))
        assert step == 3 and _same(plain, state)
        back, _, _ = checkpoint.restore(state, str(tmp_path / d),
                                        shardings=layout)
        assert all(isinstance(x, DTensor) for x in leaves(back))
        assert _same(back, state)


def test_world1_remesh_onto_a_data_mesh(mesh1, granite):
    _, model, p0 = granite
    state = (p0, optimizer.init(p0))
    placed = _place(state, sh.param_shardings(state, mesh1))
    mesh_d = make_mesh((1,), ("data",), device="cpu")
    moved = elastic.remesh(placed, mesh_d)
    assert all(x.device_mesh == mesh_d for x in leaves(moved))
    assert _same(moved, state)


def test_world1_constrain_redistributes_a_dtensor(mesh1):
    """``hints.constrain`` lays a DTensor out as its name's binding says
    (values unchanged); unbound or un-pinned, it returns it as it is."""
    x = torch.arange(8.0).reshape(4, 2)
    d = sh.from_whole(x, mesh1, (sh.Replicate(), sh.Replicate()))
    target = sh.NamedSharding(mesh1, (sh.Shard(0), sh.Replicate()))
    with hints.hints(kv_cache=target):
        got = hints.constrain(d, "kv_cache")
        with hints.hints(kv_cache=None):
            assert hints.constrain(d, "kv_cache") is d
    assert tuple(got.placements) == target.placements
    assert torch.equal(got.full_tensor(), x)
    assert hints.constrain(d, "kv_cache") is d


# ---------------------------------------------------------------------------
# world size 4: one spawned group
# ---------------------------------------------------------------------------

NESTED = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("pod", "data"))
    idx = NamedSharding(mesh, P(("pod", "data"), None)
                        ).devices_indices_map((8, 3))
    out = {}
    for p in range(2):
        for d in range(2):
            out[f"{p},{d}"] = idx[mesh.devices[p, d]][0].start
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def train4(tmp_path_factory, granite):
    """The ranks' outputs, JAX's steps and the JAX split of a nested
    leaf: the spawned group, the JAX steps and the 4-device JAX
    subprocess run side by side."""
    cfg, model, p0 = granite
    tmp = tmp_path_factory.mktemp("train4")
    batches = _batches(cfg, 2, 4, 12, seed=40)
    np.savez(tmp / "train4.npz", **{f"{k}{s}": b[k] for s, b in
                                    enumerate(batches)
                                    for k in ("tokens", "targets")})
    r = np.random.default_rng(41)
    np.savez(tmp / "serve4.npz",
             prompts=r.integers(0, cfg.vocab, (4, 20)).astype(np.int32),
             nexts=r.integers(0, cfg.vocab, (3, 4)).astype(np.int32))
    checkpoint.save((p0, optimizer.init(p0)), str(tmp / "ckpt_plain"), 0)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", NESTED], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    ranks = {}

    def run():
        try:
            ranks["outs"] = worker.spawn("train4", 4, tmp)
        except BaseException as e:             # re-raised below
            ranks["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    want = {}
    for arch_key, over, compresses in (
            ("granite", {}, (False, True)),
            ("h2", dict(n_heads=2, n_kv_heads=1), (False,))):
        jm = jax_build(jax_get_config("granite-3-8b").reduced(n_layers=2,
                                                              **over))
        jp0 = zoo.jax_params(build_model(get_config("granite-3-8b").reduced(
            n_layers=2, **over), device="cpu"), jm)
        for compress in compresses:
            jstep = zoo.jit(jmake(jm, JRunConfig(
                lr=LR, warmup_steps=1, total_steps=10,
                compress_grads=compress)))
            jp, jo = jp0, joptim.init(jp0)
            losses, norms = [], []
            for b in batches:
                jp, jo, met = jstep(jp, jo, {k: jnp.asarray(v)
                                             for k, v in b.items()})
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
            want[arch_key, compress] = (
                losses, norms,
                [zoo.npf(x) for x in leaves(params_from_jax(jp))])
    stdout, stderr = proc.communicate(timeout=300)
    thread.join()
    if "error" in ranks:
        raise ranks["error"]
    assert proc.returncode == 0, stderr[-2000:]
    nested = json.loads(stdout.strip().splitlines()[-1])
    return ranks["outs"], want, tmp, nested


def test_train4_ranks_agree(train4):
    outs, _, _, _ = train4
    for o in outs[1:]:
        for key in o:
            if not key.startswith("nested"):
                np.testing.assert_array_equal(o[key], outs[0][key],
                                              err_msg=key)


def test_train4_layouts_shard_leaves(train4):
    outs, _, _, _ = train4
    for name in ("4x1", "2x2", "2x2tp", "1x4", "h2_1x4"):
        assert outs[0][f"sharded_{name}"].sum() >= 8, name
    # ZeRO-1: some parameters placed otherwise than their moments
    assert outs[0]["zero1_2x2tp"] > 0 and outs[0]["zero1_2x2"] == 0


@pytest.mark.parametrize("name,compress", [
    ("4x1", False), ("4x1", True), ("2x2", False), ("2x2", True),
    ("2x2tp", False), ("1x4", False), ("h2_1x4", False)])
def test_train4_placed_step_matches_jax(train4, name, compress):
    outs, want, _, _ = train4
    o = outs[0]
    assert o[f"layout_kept_{name}_{int(compress)}"]
    losses, norms, params = want["h2" if name.startswith("h2") else
                                 "granite", compress]
    key = f"{name}_{int(compress)}"
    assert np.abs(o[f"loss_{key}"] - losses).max() <= 1e-6
    assert (np.abs(o[f"gnorm_{key}"] - norms)
            <= 1e-6 * np.maximum(1.0, np.abs(norms))).all()
    tol = 3 * LR if compress else 1e-6
    for i, w in enumerate(params):
        d = np.abs(o[f"p_{key}_{i}"] - w).max()
        assert d <= tol, (i, d)


# mesh -> (each flash call's (q heads, kv heads), the MLP's d_ff columns)
# on a rank: the reduced granite has 4 heads, 2 kv heads and d_ff 128;
# "h2" 2 heads and 1 kv head, each head computed by 2 of the 4 ranks
RANK_SHAPES = {"4x1": ((4, 2), 128), "2x2": ((2, 1), 64),
               "2x2tp": ((2, 1), 64), "1x4": ((1, 1), 32),
               "h2_1x4": ((1, 1), 32)}


@pytest.mark.parametrize("name", list(RANK_SHAPES))
def test_train4_rank_computes_its_heads_and_columns(train4, name):
    outs, _, _, _ = train4
    heads, ff = RANK_SHAPES[name]
    for o in outs:
        np.testing.assert_array_equal(o[f"heads_{name}_0"], [heads])
        np.testing.assert_array_equal(o[f"ff_{name}_0"], [ff])


@pytest.mark.parametrize("tag", ["granite", "granite_int8", "gemma"])
def test_train4_placed_prefill_and_decode_match_unplaced(train4, tag):
    outs, _, _, _ = train4
    o = outs[0]
    assert o[f"serve_diff_{tag}"][0] <= 1e-6
    assert o[f"serve_split_{tag}"]
    assert (o[f"serve_filled_{tag}"] > 0).all()


def test_train4_remesh_and_restore_onto_another_mesh(train4):
    outs, _, _, _ = train4
    for o in outs:
        assert o["remesh_bitwise"] and o["restore_bitwise"]
        assert o["placed_on_new"]


def test_train4_plain_and_mesh_checkpoints_interchange(train4, granite):
    outs, _, tmp, _ = train4
    _, _, p0 = granite
    assert all(o["plain_read_bitwise"] for o in outs)
    state = (p0, optimizer.init(p0))
    got, step, _ = checkpoint.restore(state, str(tmp / "ckpt_mesh"))
    assert step == 2
    for i, x in enumerate(leaves(got[0])):
        np.testing.assert_array_equal(x.numpy(), outs[0][f"p_4x1_0_{i}"])


def test_train4_psum_compressed(train4):
    outs, _, _, _ = train4
    for k, shape in (("w", (33, 17)), ("b", (9,))):
        want = np.zeros(shape, np.float32)
        for rank in range(4):
            r = np.random.default_rng(100 + rank)
            g = {"w": (r.normal(size=(33, 17)) * 1e-2).astype(np.float32),
                 "b": r.normal(size=(9,)).astype(np.float32)}
            want += np.asarray(jcomp.quantize_dequantize(jnp.asarray(g[k])))
        np.testing.assert_allclose(outs[0][f"psum_{k}"], want, rtol=1e-6,
                                   atol=1e-7)


def test_train4_nested_shards_follow_jax(train4):
    """A leaf sharded over ("pod", "data") on one dim: each rank's block
    starts where JAX's pod-major split puts that mesh position's."""
    outs, _, _, nested = train4
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    seen = set()
    for o in outs:
        p, d = (int(c) for c in o["nested_coords"])
        start = nested[f"{p},{d}"]
        np.testing.assert_array_equal(o["nested_block"], x[start:start + 2])
        np.testing.assert_array_equal(o["nested_whole"], x)
        seen.add(start)
    assert seen == {0, 2, 4, 6}
