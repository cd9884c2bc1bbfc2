"""The port's continuous-batching engine against sequential generation and
against the JAX package's engine, on carried parameters (fp32, CPU).

The cases are ``tests/test_serve.py``'s: 2 slots serving 3 prompts, and
staggered admission (5 prompts of mixed lengths through 2 slots, later
requests joining mid-stream at other positions than their slot-mates).
Tokens must be equal, token for token: in fp32 the two packages' logits
differ by about 1e-6 (``tests/test_torch_lm.py``), far below the gaps
between the greedy choices of these prompts.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("granite-3-8b").reduced(n_layers=2)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config("granite-3-8b").reduced(n_layers=2)
    return cfg, build_model(cfg, device="cpu"), params_from_jax(jp), jm, jp


def _sequential_generate(model, params, prompt, n_new, max_len=128):
    logits, caches, pos = model.prefill(params, prompt[None], max_len=max_len)
    out = [int(torch.argmax(logits, -1)[0])]
    for _ in range(n_new - 1):
        tok = torch.tensor([out[-1]])
        logits, caches = model.decode_step(params, caches, tok, pos)
        out.append(int(torch.argmax(logits, -1)[0]))
        pos += 1
    return out


def _serve(engine_cls, request_cls, model, params, prompts, n_new, n_slots,
           max_len):
    engine = engine_cls(model, params, n_slots=n_slots, max_len=max_len)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs], engine.steps


@pytest.mark.parametrize("case", ["three_prompts", "staggered"])
def test_engine_matches_sequential_and_jax_engine(setup, case):
    cfg, model, params, jm, jp = setup
    if case == "three_prompts":
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, 10, dtype=np.int32)
                   for _ in range(3)]
        n_new, max_len = 6, 128
    else:
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab, 6 + 3 * i, dtype=np.int32)
                   for i in range(5)]
        n_new, max_len = 4, 64
    want = [_sequential_generate(model, params, p, n_new) for p in prompts]
    got, steps = _serve(ServeEngine, Request, model, params, prompts, n_new,
                        2, max_len)
    assert got == want
    jax_got, jax_steps = _serve(JEngine, JRequest, jm, jp, prompts, n_new, 2,
                                max_len)
    assert got == jax_got
    assert steps == jax_steps


def test_engine_throughput_counts(setup):
    cfg, model, params, _, _ = setup
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, 8, dtype=np.int32)
               for _ in range(6)]
    outs, steps = _serve(ServeEngine, Request, model, params, prompts, 5, 4,
                         64)
    assert all(len(o) == 5 for o in outs)
    assert all(0 <= t < cfg.vocab for o in outs for t in o)
    assert steps <= 6 * 5


def test_launcher_runs_on_the_cpu():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-3-8b", "--reduced", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "served 8 requests, 64 tokens" in out.stdout
    assert "on cpu" in out.stdout
