"""The port's LM placement rules and the dry run's inputs against the JAX
package's, with no process group.

  * ``dist.sharding.param_specs`` for every leaf of every arch at full
    size, on ``AbstractMesh`` (16, 16), (2, 16, 16), (4, 1), (2, 2) and
    (1, 1) (and two more ``embed_mode``/``weights_mode`` pairs on (16, 16)
    and (2, 2)), against
    the reference's ``param_specs`` on ``jax.sharding.AbstractMesh``: the
    JAX tree from ``jax.eval_shape(model.init)``, the port's tree its
    meta-tensor twin with each stack split into per-layer leaves, whose
    spec must be the reference's without its first entry (the first
    entry is never an axis at these meshes; the test says so where it
    is).  The lists the rules take as stacks in the port's own reduced
    ``init`` trees are the ones its models name (``model.stacked``).
  * ``batch_specs`` of every arch's ``input_specs`` at every shape of
    ``shapes_for`` on the same meshes; ``input_specs`` (keys, shapes,
    dtypes) and ``layers.mlp_flops`` against the reference's.
  * ``dist.hints``: nesting, shadowing, un-pinning, the identity on a
    plain tensor; the one-hot embedding lookup bitwise the gather and
    JAX's ``_onehot_embed``, and a model's logits under ``onehot_embed``
    bitwise its logits without it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.shapes import shapes_for as jax_shapes_for  # noqa: E402
from repro.dist import hints as jhints  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import shapes_for  # noqa: E402
from repro_torch.dist import hints  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.interop import _STACKS  # noqa: E402
from repro_torch.models import layers, registry  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train.tree import leaves_up_to  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 1), ("data", "model")),
          ((2, 2), ("data", "model")),
          ((1, 1), ("data", "model"))]
MODES = [("2d", "2d"), ("dmodel", "2d"), ("vdata", "tp_only")]


def _meshes(shape, axes):
    return JAbstractMesh(tuple(shape), tuple(axes)), \
        sh.AbstractMesh(shape, axes)


def _port_tree(jtree):
    """The port's tree of meta tensors for a JAX parameter tree of shapes:
    each stack (``interop._STACKS``) split into per-layer leaves."""
    def conv(t, stacked=False):
        if isinstance(t, dict):
            return {k: conv(v, stacked) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v, stacked) for v in t]
        return torch.empty(t.shape[1:] if stacked else t.shape,
                           device="meta")

    out = {}
    for k, v in jtree.items():
        if k in _STACKS and isinstance(v, dict):
            L = jax.tree.leaves(v)[0].shape[0]
            out[k] = [conv(v, True) for _ in range(L)]
        else:
            out[k] = conv(v)
    return out


def _reference_specs(jspecs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, P))[0]
    return {jsh._path_names(path): spec for path, spec in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    jp = jax.eval_shape(jregistry.build_model(jax_get_config(arch)).init,
                        jax.random.PRNGKey(0))
    tp = _port_tree(jp)
    infos = sh._leaf_infos(tp)
    assert any(L for _, L, _ in infos) == (arch != "xlstm-125m")
    n_sharded = 0
    for shape, axes in MESHES:
        jm, tm = _meshes(shape, axes)
        for em, wm in MODES if shape in ((16, 16), (2, 2)) else MODES[:1]:
            ref = _reference_specs(jsh.param_specs(
                jp, jm, embed_mode=em, weights_mode=wm))
            got = leaves_up_to(tp, sh.param_specs(
                tp, tm, embed_mode=em, weights_mode=wm))
            assert len(got) == len(infos)
            for (names, L, leaf), g in zip(infos, got):
                r = list(ref[names])
                r += [None] * (len(leaf.shape) + (L is not None) - len(r))
                if L is not None:
                    # the stack's leading axis is never placed here
                    assert r[0] is None, (names, shape, r)
                    r = r[1:]
                assert g == sh.placements_of(r, tm), (names, shape, em)
                n_sharded += any(p != sh.Replicate() for p in g)
    assert n_sharded > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stacks_are_the_models(arch):
    """The lists the rules take as stacks are the keys of the port's
    model's ``stacked`` (none for xLSTM, whose list of blocks differ)."""
    from repro_torch.models.registry import build_model
    model = build_model(get_config(arch).reduced(), device="cpu")
    tree = model.init(torch.Generator().manual_seed(0))
    stacks = {names[0] for names, L, _ in sh._leaf_infos(tree) if L}
    assert stacks == set(model.stacked)


def test_narrowing_picks_the_widest_data_axis():
    """The reference's test_fsdp_narrows_to_widest_axis on the port: 48
    divides data (16) and pod (2) but not their product."""
    mesh = sh.AbstractMesh((2, 16, 2), ("pod", "data", "model"))
    spec = sh.param_specs({"w": torch.empty((48, 8192), device="meta")},
                          mesh)["w"]
    assert spec == (sh.Replicate(), sh.Shard(0), sh.Shard(1))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_batch_specs_match_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert set(shapes_for(cfg)) == set(jax_shapes_for(jcfg))
    for name, shape in shapes_for(cfg).items():
        jshape = jax_shapes_for(jcfg)[name]
        want = jregistry.input_specs(jcfg, jshape)
        got = registry.input_specs(cfg, shape)
        assert list(got) == list(want)
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(w.shape)
            assert str(got[k].dtype).replace("torch.", "") == str(w.dtype)
        for mshape, axes in MESHES:
            jm, tm = _meshes(mshape, axes)
            ref = jsh.batch_specs(jm, want)
            tb = sh.batch_specs(tm, got)
            for k in want:
                r = list(ref[k]) + [None] * (len(want[k].shape)
                                             - len(ref[k]))
                assert tb[k] == sh.placements_of(r, tm), (name, k, mshape)
    for kind in ("train", "prefill", "decode"):
        shape = shapes_for(cfg)["train_4k"]
        assert list(registry.input_specs(cfg, shape, kind=kind)) == list(
            jregistry.input_specs(jcfg, jax_shapes_for(jcfg)["train_4k"],
                                  kind=kind))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mlp_flops_match_reference(arch):
    for tokens in (1, 4096, 32768 * 32):
        assert layers.mlp_flops(get_config(arch), tokens) == \
            jlayers.mlp_flops(jax_get_config(arch), tokens)


def test_batch_specs_fall_back_to_the_first_axis():
    mesh = sh.AbstractMesh((4,), ("rows",))
    got = sh.batch_specs(mesh, {"x": torch.empty((8, 3), device="meta"),
                                "y": torch.empty((6,), device="meta"),
                                "z": torch.empty((), device="meta")})
    assert got == {"x": (sh.Shard(0),), "y": (sh.Replicate(),),
                   "z": (sh.Replicate(),)}


# ---------------------------------------------------------------------------
# hints
# ---------------------------------------------------------------------------

def test_hints_nest_shadow_and_unpin():
    assert hints.current() == {} and hints.get("a", 7) == 7
    with hints.hints(a=1, b=2):
        assert hints.get("a") == 1 and hints.sharding_of("b") == 2
        with hints.hints(a=3, b=None):
            assert hints.get("a") == 3 and hints.get("b") is None
            assert hints.current() == {"a": 3, "b": None}
        assert hints.current() == {"a": 1, "b": 2}
    assert hints.current() == {}
    with pytest.raises(RuntimeError):
        with hints.hints(a=1):
            raise RuntimeError("unwinds")
    assert hints.current() == {}
    # the reference's semantics, name for name
    with jhints.hints(a=1, b=2), hints.hints(a=1, b=2):
        with jhints.hints(b=None), hints.hints(b=None):
            assert hints.current() == jhints.current()


def test_constrain_is_the_identity_on_a_plain_tensor():
    x = torch.arange(6.0).reshape(2, 3)
    mesh = sh.AbstractMesh((1,), ("data",))
    with hints.hints(logits=sh.NamedSharding(mesh, (sh.Shard(0),))):
        assert hints.constrain(x, "logits") is x
    assert hints.constrain(x, "logits") is x


def test_onehot_embed_is_the_gather_and_jax_lookup():
    r = np.random.default_rng(0)
    embed = r.normal(size=(200, 16)).astype(np.float32)
    tokens = r.integers(0, 200, (3, 37)).astype(np.int32)
    want = embed[tokens]
    for chunk in (512, 8):
        got = transformer._onehot_embed(torch.from_numpy(tokens).long(),
                                        torch.from_numpy(embed), chunk)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jtransformer._onehot_embed(
                jnp.asarray(tokens), jnp.asarray(embed), chunk)))
    eb = torch.from_numpy(embed).to(torch.bfloat16)
    got = transformer._onehot_embed(torch.from_numpy(tokens).long(), eb, 8)
    assert got.dtype == torch.bfloat16 and torch.equal(
        got, eb[torch.from_numpy(tokens).long()])


def test_model_under_onehot_embed_is_bitwise():
    """A reduced granite's logits under ``onehot_embed=True`` bitwise its
    logits without the hint."""
    from repro_torch.models.registry import build_model

    cfg = get_config("granite-3-8b").reduced(n_layers=2)
    tm = build_model(cfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 20)))
    want, _, _ = tm.forward(tp, tokens, for_grad=False)
    with hints.hints(onehot_embed=True):
        got, _, _ = tm.forward(tp, tokens, for_grad=False)
    assert torch.equal(got, want)
