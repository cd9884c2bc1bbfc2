"""Shared set-up of the zoo's parity tests (``tests/test_torch_moe.py``,
``test_torch_kv_quant.py``, ``test_torch_vlm.py``, ``test_torch_ssm.py``,
``test_torch_encdec.py``).

A pair is the JAX model and the port's, on the CPU, at a ``.reduced()``
fp32 config, computing on the same weights.  The weights are drawn by
the port's ``init`` from a seeded ``torch.Generator`` and laid out as
the JAX model's parameter tree (each stack of layers on a leading axis),
which must have the structure, shapes and dtypes of
``jax.eval_shape(jm.init, key)``; they cross back to the port through
``interop.params_from_jax``.  Drawing them with the JAX model's own
``init`` compiles its random draws for 3 to 5 s an arch here; the
dense models' files (``tests/test_torch_lm.py``, ``test_torch_serve.py``)
carry JAX's own ``init(PRNGKey(0))`` across.

The JAX model's ``prefill`` and ``decode_step`` are wrapped in
``jax.jit`` (``jit`` below) on the instance (the package is not
touched), so that the JAX engine calls them so too: eagerly, every call
retraces the reference's ``lax.scan`` bodies (about 1.3 s a prefill
here), where a jitted call compiles once per shape.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax, tensor_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Request, ServeEngine

# logits within 1e-4 absolute (fp32: matmul and softmax summation order)
ATOL = 1e-4


def jit(fn, **kw):
    """``jax.jit`` with XLA's CPU backend at optimization level 0: a
    third less compile time for these tiny programs, which run once or a
    few times each."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0},
                   **kw)


def t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def npf(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


class Pair(NamedTuple):
    cfg: object
    jm: object
    jp: dict
    tm: object
    tp: dict


def jax_params(tm, jm, seed: int = 0) -> dict:
    """The port's ``init`` drawn from a generator seeded with ``seed``,
    as the JAX model's parameter tree: each list of layers that the JAX
    model stacks becomes one dict of (L, ...) arrays (xLSTM's list stays
    a list).  Raises unless the tree is ``jax.eval_shape(jm.init)``'s,
    leaf for leaf in shape and dtype."""
    tp = tm.init(torch.Generator().manual_seed(seed))
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        if isinstance(x, list):
            return [tree(v) for v in x]
        return x.numpy()

    jp = {}
    for k, v in tp.items():
        if isinstance(v, list) and isinstance(want[k], dict):
            jp[k] = jax.tree.map(lambda *a: np.stack(a), *tree(v))
        else:
            jp[k] = tree(v)
    assert jax.tree.structure(jp) == jax.tree.structure(want)
    for a, w in zip(jax.tree.leaves(jp), jax.tree.leaves(want)):
        assert a.shape == w.shape and a.dtype == w.dtype, (a.shape, w)
    return jax.tree.map(jnp.asarray, jp)


def _jax_forward(jm, cfg):
    """The JAX model's (full-sequence logits, aux loss) as a function of
    (params, tokens, frontend or None), for any family."""
    def fn(p, toks, fe):
        if cfg.is_encdec:
            return jm.forward(p, toks, fe, remat=False, for_grad=False), 0.0
        if cfg.family in ("hybrid", "ssm"):
            out = jm.forward(p, toks, remat=False, for_grad=False)
        else:
            out = jm.forward(p, toks, fe, remat=False, for_grad=False)
        return out[0], out[2]
    return fn


@functools.lru_cache(maxsize=None)
def pair(arch: str, *, kv_quant: bool = False, **over) -> Pair:
    """The pair for ``arch`` reduced with ``over``, built once per
    process (the tests hold it read-only: the port's caches are made
    anew by each prefill).

    The JAX model's ``prefill`` becomes one jitted program that also
    returns ``forward``'s full logits on the same input: the engine's
    prefills and the forward test (at the engine's prompt shape and
    max_len) share one compile."""
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    jm = jax_build(jcfg, kv_quant=kv_quant)
    tm = build_model(cfg, kv_quant=kv_quant, device="cpu")
    jp = jax_params(tm, jm)
    forward, prefill = _jax_forward(jm, jcfg), jm.prefill

    def both(p, toks, fe, max_len):
        return forward(p, toks, fe), prefill(p, toks, fe, max_len=max_len)

    jm.forward_and_prefill = jit(both, static_argnames=("max_len",))
    jm.prefill = lambda p, toks, fe=None, *, max_len: \
        jm.forward_and_prefill(p, toks, fe, max_len=max_len)[1]
    jm.decode_step = jit(jm.decode_step)
    return Pair(cfg, jm, jp, tm, params_from_jax(jp))


def frontend(cfg, rng):
    """Seeded stub frontend embeddings (F, d) of one request, or None."""
    if cfg.frontend == "none":
        return None
    return rng.normal(size=(cfg.frontend_len, cfg.d_model)) \
        .astype(np.float32)


def jax_forward(pr: Pair, toks, fe=None, *, max_len: int):
    """The JAX model's (full-sequence logits, aux loss) on toks (1, T)
    (and frontend (1, F, d)), from the program that the engine's
    prefills at max_len run."""
    (logits, aux), _ = pr.jm.forward_and_prefill(
        pr.jp, jnp.asarray(toks), None if fe is None else jnp.asarray(fe),
        max_len=max_len)
    return np.asarray(logits), float(aux)


class _Recorder:
    """Wraps a model's prefill and decode_step on the instance, keeping
    each call's logits as numpy."""

    def __init__(self, model):
        self.model, self.logits = model, []
        self.fns = model.prefill, model.decode_step

        def prefill(*a, **kw):
            out = self.fns[0](*a, **kw)
            self.logits.append(("prefill", npf(out[0])))
            return out

        def decode_step(*a, **kw):
            out = self.fns[1](*a, **kw)
            self.logits.append(("decode", npf(out[0])))
            return out

        model.prefill, model.decode_step = prefill, decode_step

    def restore(self):
        self.model.prefill, self.model.decode_step = self.fns


def serve_both(pr: Pair, prompts, frontends=None, *, n_new, n_slots: int,
               max_len: int):
    """The same requests through the port's ServeEngine and the JAX
    package's; ``n_new`` an int or one per request (requests that end at
    different steps free their slots mid-stream, so later admissions
    decode beside sequences at other depths).  Asserts the two runs made
    the same calls with logits within ATOL, the same tokens and the same
    steps; returns the outputs and the largest logit gap."""
    frontends = frontends or [None] * len(prompts)
    if isinstance(n_new, int):
        n_new = [n_new] * len(prompts)
    runs = []
    for engine_cls, req_cls, model, params in (
            (ServeEngine, Request, pr.tm, pr.tp),
            (JEngine, JRequest, pr.jm, pr.jp)):
        rec = _Recorder(model)
        try:
            engine = engine_cls(model, params, n_slots=n_slots,
                                max_len=max_len)
            reqs = [req_cls(uid=i, prompt=p, max_new_tokens=m, frontend=f)
                    for i, (p, m, f) in enumerate(zip(prompts, n_new,
                                                      frontends))]
            for r in reqs:
                engine.submit(r)
            engine.run()
        finally:
            rec.restore()
        assert all(r.done and len(r.output) == m
                   for r, m in zip(reqs, n_new))
        runs.append(([r.output for r in reqs], engine.steps, rec.logits))
    (out, steps, logits), (jout, jsteps, jlogits) = runs
    assert [k for k, _ in logits] == [k for k, _ in jlogits]
    gap = max(float(np.abs(a - b).max())
              for (_, a), (_, b) in zip(logits, jlogits))
    assert gap <= ATOL, gap
    assert out == jout and steps == jsteps
    return out, gap
