"""`PipelineConfig` — the one config object for the TMFG-DBHT pipeline.

A copy of ``repro.core.config`` (DESIGN.md §12.1) with the port's kernel
backends: ``backend`` is ``"auto" | "cuda" | "torch"``.  ``"auto"``
launches the hand-written CUDA kernel for a tensor on the card and runs
the plain PyTorch version for a tensor on the CPU; ``"cuda"`` always
launches the kernel (and raises for a CPU tensor); ``"torch"`` always
runs the plain version, on whatever device the tensor lies.

Every field and every named variant of the reference is kept, so
``content_key`` tuples and ``VARIANTS`` agree between the two packages,
and every value of every field runs in the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# The paper's comparison line-up (same mapping as the reference).
VARIANTS = {
    "par-1": dict(method="orig", prefix=1, topk=0, apsp_method="exact"),
    "par-10": dict(method="orig", prefix=10, topk=0, apsp_method="exact"),
    "par-200": dict(method="orig", prefix=200, topk=0, apsp_method="exact"),
    "corr": dict(method="corr", topk=0, apsp_method="exact"),
    "heap": dict(method="lazy", topk=0, apsp_method="exact"),
    "opt": dict(method="lazy", topk=64, apsp_method="hub"),
}

_METHODS = ("lazy", "corr", "orig")
_APSP_METHODS = ("exact", "hub", "sparse")
_DBHT_IMPLS = ("device", "host")
_BACKENDS = ("auto", "cuda", "torch")
_SIMILARITIES = ("dense", "topk")
_FILTERS = ("tmfg", "mst", "pmfg", "ag")
_CLEANS = ("none", "rmt")


@dataclass(frozen=True)
class PipelineConfig:
    """Frozen, hashable bundle of every pipeline stage knob.

    Fields (defaults reproduce the paper's OPT-TDBHT), as in the
    reference:
      method:      TMFG construction — "lazy" | "corr" | "orig".
      prefix:      prefix size P for method="orig".
      topk:        up-front candidate-table width (0 disables).
      apsp_method: "hub" | "exact" | "sparse".
      apsp_hubs:   hub count for hub-APSP; 0 = ceil(sqrt(n)).
      apsp_rounds: Bellman-Ford relaxation cap; 0 relaxes to the fixed
                   point (cap n).
      backend:     kernel dispatch — "auto" | "cuda" | "torch".
      dbht_impl:   DBHT execution strategy — "device" | "host".
      similarity:  "dense" | "topk".
      sim_k:       candidate-table width for similarity="topk".
      filter:      "tmfg" | "mst" | "pmfg" | "ag".
      clean:       "none" | "rmt".
      ag_m:        edge budget for filter="ag".
    """

    method: str = "lazy"
    prefix: int = 10
    topk: int = 64
    apsp_method: str = "hub"
    apsp_hubs: int = 0
    apsp_rounds: int = 0
    backend: str = "auto"
    dbht_impl: str = "device"
    similarity: str = "dense"
    sim_k: int = 0
    filter: str = "tmfg"
    clean: str = "none"
    ag_m: int = 0

    def __post_init__(self):
        for name, value, allowed in (
                ("method", self.method, _METHODS),
                ("APSP method", self.apsp_method, _APSP_METHODS),
                ("DBHT impl", self.dbht_impl, _DBHT_IMPLS),
                ("backend", self.backend, _BACKENDS),
                ("similarity", self.similarity, _SIMILARITIES),
                ("filter", self.filter, _FILTERS),
                ("clean", self.clean, _CLEANS)):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r}; have {allowed}")
        if self.prefix < 1:
            raise ValueError(f"prefix must be >= 1, got {self.prefix}")
        if self.similarity == "topk" and self.sim_k < 1:
            raise ValueError(
                f"similarity='topk' needs sim_k >= 1, got {self.sim_k}; "
                f"use PipelineConfig.approx(sim_k=...)")
        if self.similarity == "dense" and self.sim_k != 0:
            raise ValueError(
                f"sim_k={self.sim_k} only applies to similarity='topk' "
                f"(dense ignores it; set sim_k=0)")
        if self.filter != "tmfg":
            if self.similarity != "dense":
                raise ValueError(
                    f"filter={self.filter!r} needs similarity='dense', got "
                    f"similarity={self.similarity!r}")
            if self.dbht_impl != "device":
                raise ValueError(
                    f"filter={self.filter!r} has no host DBHT walk; use "
                    f"dbht_impl='device'")
        if self.ag_m < 0:
            raise ValueError(f"ag_m must be >= 0, got {self.ag_m}")
        if self.ag_m > 0 and self.filter != "ag":
            raise ValueError(
                f"ag_m={self.ag_m} only applies to filter='ag' "
                f"(other filters ignore it; set ag_m=0)")
        if self.clean == "rmt" and self.similarity != "dense":
            raise ValueError("clean='rmt' needs similarity='dense'")
        if (self.clean == "rmt" and self.filter == "tmfg"
                and self.apsp_method == "sparse"):
            raise ValueError(
                "clean='rmt' with apsp_method='sparse' is unsupported on "
                "the TMFG path — use apsp_method='hub' or 'exact'")

    # -- constructors -------------------------------------------------------
    @classmethod
    def variant(cls, name: str, **overrides) -> "PipelineConfig":
        """The named paper variant as a config (see VARIANTS); a field
        the variant defines cannot be overridden."""
        fields = dict(VARIANTS[name])
        clash = set(fields) & set(overrides)
        if clash:
            raise ValueError(
                f"variant {name!r} defines {sorted(clash)}; drop the "
                f"override or build PipelineConfig(...) directly")
        return cls(**fields, **overrides)

    @classmethod
    def opt(cls, **overrides) -> "PipelineConfig":
        """OPT-TDBHT (the production default)."""
        return cls.variant("opt", **overrides)

    @classmethod
    def heap(cls, **overrides) -> "PipelineConfig":
        """HEAP-TDBHT (lazy construction, exact APSP)."""
        return cls.variant("heap", **overrides)

    @classmethod
    def corr(cls, **overrides) -> "PipelineConfig":
        """CORR-TDBHT (Algorithm 1, eager)."""
        return cls.variant("corr", **overrides)

    @classmethod
    def par(cls, prefix: int = 10, **overrides) -> "PipelineConfig":
        """PAR-TDBHT-P (Yu & Shun baseline with prefix P)."""
        return cls(method="orig", prefix=prefix, topk=0,
                   apsp_method="exact", **overrides)

    @classmethod
    def mst(cls, **overrides) -> "PipelineConfig":
        """Borůvka MST front-end: the OPT defaults with ``filter="mst"``."""
        if "filter" in overrides:
            raise ValueError("mst() defines ['filter']; drop the override "
                             "or build PipelineConfig(filter=...) directly")
        return cls(filter="mst", **overrides)

    @classmethod
    def approx(cls, sim_k: int = 64, **overrides) -> "PipelineConfig":
        """Sparse-similarity OPT-TDBHT on an (n, sim_k) candidate table."""
        clash = {"similarity", "sim_k"} & set(overrides)
        if clash:
            raise ValueError(f"approx() defines {sorted(clash)}; pass "
                             f"sim_k= directly or build PipelineConfig(...)")
        return cls(**{**dict(VARIANTS["opt"]), **overrides,
                      "similarity": "topk", "sim_k": sim_k})

    @classmethod
    def resolve(cls, variant: Optional[str] = None,
                config: Optional["PipelineConfig"] = None,
                **kwargs) -> "PipelineConfig":
        """An explicit ``config`` wins wholesale (combining it with
        ``variant`` or a non-None kwarg is rejected); otherwise a named
        ``variant`` overrides the fields it defines and the kwargs fill
        the rest; otherwise the kwargs (with the defaults) stand."""
        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        if config is not None:
            if variant is not None or kwargs:
                clash = (["variant"] if variant is not None else []) \
                    + sorted(kwargs)
                raise ValueError(
                    f"config= conflicts with {clash}: pass one surface, "
                    f"or use config.replace(...)")
            return config
        if variant is None:
            return cls(**kwargs)
        fields = dict(VARIANTS[variant])
        fields.update({k: v for k, v in kwargs.items() if k not in fields})
        return cls(**fields)

    # -- key material -------------------------------------------------------
    def content_key(self) -> Tuple:
        """The static half of the content-hash result-cache key — the
        same tuple as the reference's (``dbht_impl`` deliberately
        absent: it selects a strategy, not an answer)."""
        return (self.method, self.prefix, self.topk, self.apsp_method,
                self.apsp_hubs, self.apsp_rounds, self.backend,
                self.similarity, self.sim_k, self.filter, self.clean,
                self.ag_m)

    def replace(self, **changes) -> "PipelineConfig":
        """A copy with ``changes`` applied (frozen-dataclass update)."""
        return dataclasses.replace(self, **changes)


def check_no_conflict(config: Optional[PipelineConfig], **kwargs) -> None:
    """Raise if ``config`` is combined with any explicit (non-None) loose
    kwarg: the contract of :meth:`PipelineConfig.resolve`, for the
    lower-layer entry points (``dbht``, ``dbht_batch``)."""
    if config is None:
        return
    clash = sorted(k for k, v in kwargs.items() if v is not None)
    if clash:
        raise ValueError(f"config= conflicts with {clash}: pass one "
                         f"surface, or use config.replace(...)")
