"""Deterministic host-sharded token pipeline for LM training.

The port of ``repro.data.tokens``: every (seed, host, step) maps to its
own numpy stream, so the tokens are bitwise the reference's and a
restarted run sees the same batches.  The synthetic corpus mixes
``n_domains`` unigram distributions with Zipfian frequencies inside each
domain's vocab window.  Batches come back as int32 tensors on the
pipeline's device: CUDA unless the caller asks for another.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.pipeline import resolve_device


@dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    n_domains: int = 8
    zipf_a: float = 1.3
    seed: int = 0


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig, host_id: int = 0,
                 weights: Optional[list] = None, *, device=None):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} is not a "
                             f"multiple of {cfg.n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.device = resolve_device(device)
        self.local_batch = cfg.global_batch // cfg.n_hosts
        # per-domain token offsets (vocab slices and a shared tail)
        rng = np.random.default_rng(cfg.seed)
        self._domain_base = rng.integers(
            0, max(1, cfg.vocab - cfg.vocab // 4), cfg.n_domains)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (hash((self.cfg.seed, self.host_id, step)) % (2 ** 31)))

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = self._rng(step)
        dom = rng.integers(0, cfg.n_domains, self.local_batch)
        window = max(2, cfg.vocab // 4)
        z = rng.zipf(cfg.zipf_a, (self.local_batch, cfg.seq_len + 1))
        toks = (self._domain_base[dom][:, None] + (z % window)) % cfg.vocab
        toks = torch.from_numpy(toks.astype(np.int32)).to(self.device)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                "domains": torch.from_numpy(dom.astype(np.int32))
                .to(self.device)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
