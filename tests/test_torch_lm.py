"""The port's dense decoder against the JAX package's, module by module.

Weights come from the JAX model (``init(PRNGKey(0))``) and cross with
``interop.params_from_jax``, so both packages compute the same function;
inputs are seeded numpy arrays.  Sizes are ``.reduced()`` (fp32), on the
CPU, where ``ops.flash_attention`` runs the plain version.

Tolerances: logits within 1e-4 absolute and greedy tokens equal (fp32:
the two differ by matmul and online-softmax summation order only);
layer outputs within 1e-5.  In bf16, ``attention_full`` scales q in
bf16 before the fp32 products as the reference's ``_flash`` does and
matches it within 1e-6; the bf16 logits (magnitude about 0.7) are held
within 1.9e-2, twice the 9.26e-3 measured, which comes from the two
frameworks rounding bf16 elementwise ops at other places; at hd = 32,
where the scale is not a bf16 number, the placement shows in the logits
(6.84e-3 against 7.81e-3 with the Pallas placement).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.interop import params_from_jax, tensor_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.transformer import layer_windows  # noqa: E402

ATOL = 1e-4


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(t):
    return t.float().numpy()


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_configs_resolve_as_the_reference():
    from repro.configs import ARCH_IDS
    from repro_torch.configs import ARCH_IDS as PORT_IDS
    assert PORT_IDS == ARCH_IDS
    for arch in ARCH_IDS + ["paper-tmfg"]:
        a, b = jax_get_config(arch), get_config(arch)
        assert a.__dict__ == b.__dict__, arch
        if arch != "paper-tmfg":
            assert a.param_count() == b.param_count()
            assert a.reduced(n_layers=7).__dict__ == \
                b.reduced(n_layers=7).__dict__
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-7")


def test_rmsnorm_and_rope():
    r = _rng(0)
    x = r.normal(size=(2, 9, 4, 16)).astype(np.float32)
    scale = r.normal(size=(16,)).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = layers.rmsnorm({"scale": _t(scale)}, _t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    pos = np.tile(np.arange(9, dtype=np.int32) + 1000, (2, 1))
    for theta in (10_000.0, 1e6):
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = layers.apply_rope(_t(x), _t(pos), theta)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp_kinds(kind):
    p = jlayers.mlp_init(jax.random.PRNGKey(1), 32, 64, kind, jnp.float32)
    x = _rng(1).normal(size=(2, 5, 32)).astype(np.float32)
    want = jlayers.mlp_apply(p, jnp.asarray(x), kind)
    got = layers.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), kind)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_mask_vocab():
    x = _rng(2).normal(size=(2, 512)).astype(np.float32)
    want = jlayers.mask_vocab(jnp.asarray(x), 503)
    got = layers.mask_vocab(_t(x), 503)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_setup(arch="granite-3-8b", seed=3, T=24, B=2):
    cfg = jax_get_config(arch).reduced()
    p = jattn.attn_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    x = _rng(seed).normal(size=(B, T, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    return cfg, p, {k: _t(v) for k, v in p.items()}, x, pos


@pytest.mark.parametrize("window", [0, 8])
def test_attention_full(window):
    cfg, jp, tp, x, pos = _attn_setup()
    want, (jk, jv) = jattn.attention_full(jp, jnp.asarray(x),
                                          jnp.asarray(pos), cfg=cfg,
                                          window=window, q_chunk=8,
                                          kv_chunk=8)
    got, (k, v) = attn.attention_full(tp, _t(x), _t(pos), cfg=cfg,
                                      window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(_np(k), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(_np(v), np.asarray(jv), atol=1e-5)


@pytest.mark.parametrize("capacity", [32, 10])   # global; a ring of 10 < T
def test_cache_fill_and_decode_with_per_slot_positions(capacity):
    """Fill from a 24-token prefill, then one decode step per slot at its
    own position (two sequences at different depths), window 0 and 6."""
    cfg, jp, tp, x, pos = _attn_setup(T=24)
    _, (jk, jv) = jattn.attention_full(jp, jnp.asarray(x), jnp.asarray(pos),
                                       cfg=cfg, window=0)
    positions = jnp.arange(24, dtype=jnp.int32)[None]
    jc = jattn.cache_fill_from_prefill(
        jattn.cache_init(cfg, 2, capacity, jnp.float32), jk, jv, positions)
    tc = attn.cache_fill_from_prefill(
        attn.cache_init(cfg, 2, capacity, torch.float32, "cpu"),
        _t(jk), _t(jv), _t(positions))
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    xd = _rng(4).normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    step_pos = np.array([24, 19], np.int32)
    for window in (0, 6):
        want, jc2 = jattn.attention_decode(jp, jnp.asarray(xd), jc,
                                           jnp.asarray(step_pos), cfg=cfg,
                                           window=window)
        fresh = attn.KVCache(*(t.clone() for t in tc))
        got, tc2 = attn.attention_decode(tp, _t(xd), fresh,
                                         _t(step_pos), cfg=cfg,
                                         window=window)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(jc2.slot_pos),
                                      tc2.slot_pos.numpy())
        np.testing.assert_allclose(_np(tc2.k), np.asarray(jc2.k), atol=1e-5)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

_MODELS = {}


def _models(arch, n_layers=None, dtype=None, head_dim=None):
    key = (arch, n_layers, dtype, head_dim)
    if key not in _MODELS:
        over = {}
        if n_layers:
            over["n_layers"] = n_layers
        if dtype:
            over["dtype"] = dtype
        if head_dim:
            over["head_dim"] = head_dim
        jcfg = jax_get_config(arch).reduced(**over)
        cfg = get_config(arch).reduced(**over)
        jm = jax_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(cfg, device="cpu")
        _MODELS[key] = (cfg, jm, jp, tm, params_from_jax(jp))
    return _MODELS[key]


DENSE = [("granite-3-8b", None), ("gemma3-4b", 7), ("nemotron-4-15b", None),
         ("granite-34b", None)]


def test_gemma_layer_pattern_covers_global_and_remainder():
    cfg = get_config("gemma3-4b").reduced(n_layers=7)
    assert layer_windows(cfg) == [16, 16, 16, 16, 16, 0, 16]
    _, jm, _, tm, _ = _models("gemma3-4b", 7)
    assert tm.cache_capacities(48) == jm.cache_capacities(48)
    for jc, tc in zip(jm.decode_state(3, 48), tm.decode_state(3, 48)):
        for a, b in zip(jc, tc):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("arch,n_layers", DENSE)
def test_forward_logits(arch, n_layers):
    cfg, jm, jp, tm, tp = _models(arch, n_layers)
    toks = _rng(5).integers(0, cfg.vocab, (2, 24), dtype=np.int32)
    want, _, _ = jm.forward(jp, jnp.asarray(toks), remat=False,
                            for_grad=False)
    got, _, _ = tm.forward(tp, toks)
    assert got.shape == want.shape == (2, 24, cfg.vocab_padded)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch,n_layers,T", [
    ("granite-3-8b", None, 12), ("gemma3-4b", 7, 10), ("gemma3-4b", 7, 24),
    ("nemotron-4-15b", None, 12), ("granite-34b", None, 12)])
def test_prefill_and_greedy_decode(arch, n_layers, T):
    """Prefill 2 prompts, then 5 greedy decode steps from the port's own
    tokens; gemma3's local window (16) is longer than the 10-token prompt
    and shorter than the 24-token one (a ring buffer)."""
    cfg, jm, jp, tm, tp = _models(arch, n_layers)
    toks = _rng(T).integers(0, cfg.vocab, (2, T), dtype=np.int32)
    jl, jc, jpos = jm.prefill(jp, jnp.asarray(toks), max_len=48)
    tl, tc, tpos = tm.prefill(tp, toks, max_len=48)
    assert int(jpos) == tpos == T
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a.slot_pos),
                                      b.slot_pos.numpy())
    pos = T
    tok = torch.argmax(tl, -1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jnp.argmax(jl, -1)))
    for _ in range(5):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok.numpy(), jnp.int32),
                                jnp.int32(pos))
        tl, tc = tm.decode_step(tp, tc, tok, pos)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
        tok = torch.argmax(tl, -1)
        np.testing.assert_array_equal(tok.numpy(),
                                      np.asarray(jnp.argmax(jl, -1)))
        pos += 1


@pytest.mark.parametrize("window", [0, 8])
def test_bf16_attention_full_scales_q_as_the_reference(window):
    """bf16 ``attention_full`` scales q in bf16 before the fp32 products,
    as the reference's ``_flash`` does, and matches it (measured 0 and
    6e-8); with the Pallas placement (q scaled after its fp32 cast) the
    two differ by 1.6e-2.  hd = 32: 1 / sqrt(hd) is not a power of two
    (at the reduced default hd = 16 the two placements agree)."""
    cfg = jax_get_config("granite-3-8b").reduced(dtype="bfloat16",
                                                 head_dim=32)
    p = jattn.attn_init(jax.random.PRNGKey(3), cfg, jnp.bfloat16)
    tp = {k: _t(v) for k, v in p.items()}
    x = jnp.asarray(_rng(3).normal(size=(2, 40, cfg.d_model)),
                    jnp.bfloat16)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    want, _ = jattn.attention_full(p, x, jnp.asarray(pos), cfg=cfg,
                                   window=window, q_chunk=16, kv_chunk=16)
    want = np.asarray(want, np.float32)
    got, _ = attn.attention_full(tp, _t(x), _t(pos), cfg=cfg, window=window)
    assert got.dtype == torch.bfloat16
    gap = np.abs(_np(got) - want).max()
    q, k, v = attn._project_qkv(tp, _t(x), cfg, _t(pos))
    pallas = ops.flash_attention(q, k, v, causal=True, window=window)
    pallas_gap = np.abs(_np(pallas.reshape(2, 40, -1) @ tp["wo"]) - want).max()
    assert gap <= 1e-6 and pallas_gap >= 1e-3, (gap, pallas_gap)


def test_bf16_forward_within_the_bf16_rounding_gap():
    """The bf16 logits (magnitude about 0.7) within 1.9e-2 of the JAX
    model's: 9.26e-3 measured, twice that is the bound.  Attention is not
    the source (``attention_full`` matches the reference's bitwise at this
    hd = 16); the two frameworks round bf16 elementwise ops at other
    places (SiLU's logistic alone differs by one bf16 ulp on unit
    inputs)."""
    cfg, jm, jp, tm, tp = _models("granite-3-8b", None, "bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    toks = _rng(6).integers(0, cfg.vocab, (1, 40), dtype=np.int32)
    want, _, _ = jm.forward(jp, jnp.asarray(toks), remat=False,
                            for_grad=False)
    got, _, _ = tm.forward(tp, toks)
    gap = np.abs(_np(got) - np.asarray(want)).max()
    assert gap <= 1.9e-2, gap


def test_bf16_forward_at_hd32_matches_the_reference_placement(monkeypatch):
    """At hd = 32, where 1 / sqrt(hd) is not a bf16 number, the bf16
    logits come closer to the JAX model's with q scaled as its _flash
    scales it (6.84e-3 measured) than with the Pallas kernel's scale
    after the fp32 cast (7.81e-3), and below the 9.3e-3 of the reduced
    model's gap before this placement."""
    cfg, jm, jp, tm, tp = _models("granite-3-8b", None, "bfloat16", 32)
    toks = _rng(6).integers(0, cfg.vocab, (1, 40), dtype=np.int32)
    want = np.asarray(jm.forward(jp, jnp.asarray(toks), remat=False,
                                 for_grad=False)[0], np.float32)
    gap = np.abs(_np(tm.forward(tp, toks)[0]) - want).max()

    def pallas_placement(p, x, positions, *, cfg, window, backend="auto"):
        q, k, v = attn._project_qkv(p, x, cfg, positions)
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  backend=backend)
        return out.reshape(*x.shape[:2], -1) @ p["wo"], (k, v)

    monkeypatch.setattr(attn, "attention_full", pallas_placement)
    pallas_gap = np.abs(_np(tm.forward(tp, toks)[0]) - want).max()
    assert gap < pallas_gap and gap < 9.3e-3, (gap, pallas_gap)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_unported_families_raise(arch):
    """Every family of every config builds, prefills and decodes on the
    CPU (no family raises any more): random weights from a seeded
    generator, a 12-token prompt (and stub frontend embeddings where the
    config has a frontend), then two batched decode steps; logits finite,
    the next position the prompt's length (frontend included for a
    decoder-only model)."""
    cfg = get_config(arch).reduced()
    tm = build_model(cfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    rng = _rng(17)
    toks = rng.integers(0, cfg.vocab, (2, 12), dtype=np.int32)
    fe = None
    if cfg.frontend != "none":
        fe = rng.normal(size=(2, cfg.frontend_len, cfg.d_model)) \
            .astype(np.float32)
    logits, caches, pos = tm.prefill(params, toks, fe, max_len=32)
    assert logits.shape == (2, cfg.vocab)
    assert pos == 12 + (cfg.frontend_len if fe is not None
                        and not cfg.is_encdec else 0)
    for _ in range(2):
        tok = torch.argmax(logits, -1)
        logits, caches = tm.decode_step(params, caches, tok,
                                        torch.full((2,), pos))
        assert logits.shape == (2, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
        pos += 1


def test_model_runs_on_cuda_unless_told_otherwise(monkeypatch):
    """No card and no device='cpu': the model refuses to start."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("granite-3-8b").reduced())


def test_init_draws_from_the_generator():
    cfg = get_config("granite-3-8b").reduced(n_layers=2)
    tm = build_model(cfg, device="cpu")
    gens = [torch.Generator().manual_seed(s) for s in (0, 0, 1)]
    a, b, c = (tm.init(g) for g in gens)
    assert torch.equal(a["layers"][1]["attn"]["wq"], b["layers"][1]["attn"]["wq"])
    assert not torch.equal(a["embed"], c["embed"])
    shapes = {k: tuple(v.shape) for k, v in a["layers"][0]["mlp"].items()}
    assert shapes == {"wg": (64, 128), "wu": (64, 128), "wd": (128, 64)}
    n = sum(t.numel() for t in [a["embed"], a["ln_f"]["scale"]]) + sum(
        t.numel() for lp in a["layers"] for d in lp.values()
        for t in d.values())
    # param_count counts the unpadded vocab
    assert n - (cfg.vocab_padded - cfg.vocab) * cfg.d_model == \
        cfg.param_count()
