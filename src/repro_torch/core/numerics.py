"""DotEngine: pluggable matmul numerics for the model stack (port of
`repro/core/numerics.py`).

Every numerics choice is a registered `DotMode`:

  native   - matmul in the activation compute dtype; the baseline.
  tpmm16 / tpmm8 - the paper's truncated-precision inner products
    (kernels/tpmm): operands decomposed into digit planes, plane pairs
    beyond the significance cutoff never computed. n_bits = 16 / 8.
  olm8 / olm16 / olm24 / olm32 - the paper's inner-product array
    (kernels/online_dot/matmul.olm_matmul) at every array width: K-lane
    online multipliers feeding an online adder tree, operands quantized
    to signed-digit grids, digit streams decoded exactly and accumulated
    in f32. n = 24/32 streams take the exact wide decode.
  olm{n}t{p} - the truncated working-precision tiers (TRUNCATED_SPECS):
    the n-digit mode run at p < n working digits.

The digit modes dispatch on the device of their operands: a CUDA tensor
runs a Hopper kernel, a CPU tensor the plain version. Weights go to the
kernel in f32 from their stored dtype, never rounded through the
activation dtype first; the output returns in the activation dtype.

`EngineSpec` is the one declarative description of an engine, and
`resolve_engine(spec, base=)` turns it into a DotEngine; `DotEngine.spec()`
is the inverse. With both `mesh` (a DeviceMesh) and `shard` set, the olm
GEMMs run sharded over the mesh's `shard_axis`
(kernels/online_dot/matmul_sharded); the other modes ignore the mesh.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch

__all__ = ["DotEngine", "DotMode", "register_mode", "TRUNCATED_SPECS",
           "EngineSpec", "resolve_engine"]

# The registered truncated tiers as (n, p) pairs: mode `olm{n}t{p}` is
# the n-digit array run at p working digits.
TRUNCATED_SPECS: Tuple[Tuple[int, int], ...] = (
    (16, 12), (16, 10), (32, 24), (32, 20), (32, 16))


@dataclasses.dataclass(frozen=True)
class DotMode:
    """One registered numerics mode: implementation + trade-off docs."""
    name: str
    summary: str
    error: str
    cost: str
    fn: Callable[["DotEngine", torch.Tensor, torch.Tensor], torch.Tensor]


_MODES: Dict[str, DotMode] = {}


def register_mode(name: str, *, summary: str, error: str, cost: str):
    """Register a DotEngine mode. The decorated function receives
    (engine, x (..., K), w (K, N)) and returns (..., N). Names are
    single-assignment."""
    def deco(fn):
        if name in _MODES:
            raise ValueError(f"DotEngine mode {name!r} already registered")
        _MODES[name] = DotMode(name, summary, error, cost, fn)
        return fn
    return deco


@register_mode(
    "native",
    summary="matmul in the model compute dtype",
    error="exact at compute dtype (its rounding only)",
    cost="full-precision matmul; baseline")
def _native_dot(eng: "DotEngine", x: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


class _DigitDot(torch.autograd.Function):
    """A digit-mode GEMM as a node of the autograd graph. The forward is
    the kernel (or, on a CPU operand, its plain version), bits unchanged.
    The derivative is zero with respect to both operands: the reference's
    oracle quantizes through `jnp.round`, whose derivative is 0, and no
    Pallas kernel of the reference has a backward. So a loss through a
    digit-mode GEMM stays attached to the graph, and every leaf behind it
    gets a gradient tensor, zero exactly where the reference's is."""

    @staticmethod
    def forward(ctx, x, w, matmul_fn, n_bits):
        ctx.operands = [(t.shape, t.dtype, t.device) for t in (x, w)]
        lead = x.shape[:-1]
        out = matmul_fn(x.reshape(-1, x.shape[-1]), w.to(torch.float32),
                        n_bits=n_bits)
        return out.reshape(*lead, w.shape[-1]).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        gx, gw = (torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.operands)
        return gx, gw, None, None


def _lowered_dot(eng: "DotEngine", x: torch.Tensor, w: torch.Tensor,
                 matmul_fn, n_bits: int) -> torch.Tensor:
    """Flatten the lead axes onto a 2-D tile, hand the weights over in f32
    from their stored dtype, and restore the activation shape and dtype;
    the derivative is zero (`_DigitDot`)."""
    return _DigitDot.apply(x, w, matmul_fn, n_bits)


def _tpmm_dot(eng: "DotEngine", x: torch.Tensor, w: torch.Tensor,
              n_bits: int) -> torch.Tensor:
    from repro_torch.kernels.tpmm.ops import tpmm
    return _lowered_dot(eng, x, w, tpmm, n_bits)


@register_mode(
    "tpmm16",
    summary="truncated digit-plane matmul, 16-bit significance",
    error="~6e-4 relative (n-bit plane truncation, tested)",
    cost="10/16 plane-pair MXU matmuls (37.5% MXU ops saved)")
def _tpmm16(eng, x, w):
    return _tpmm_dot(eng, x, w, 16)


@register_mode(
    "tpmm8",
    summary="truncated digit-plane matmul, 8-bit significance",
    error="~8e-2 relative (n-bit plane truncation, tested)",
    cost="3/4 plane-pair MXU matmuls (25% MXU ops saved)")
def _tpmm8(eng, x, w):
    return _tpmm_dot(eng, x, w, 8)


def _olm_dot(eng: "DotEngine", x: torch.Tensor, w: torch.Tensor,
             n_bits: int, trunc: Optional[int] = None) -> torch.Tensor:
    from repro_torch.kernels.online_dot.matmul import olm_matmul
    # k_tile is the numerics knob (array width per K tile); block_m and
    # block_n pin the kernel's block rows and columns. tiling="auto" asks
    # the autotuner for the GEMM's launch plan (k_tile pinned to the
    # numerics default, so the bits stay those of tiling=None); knobs
    # pinned on the engine win over it. The lookup runs for CPU operands
    # too, whose plain version ignores the plan, as the reference's
    # interpret-mode call looks up its tiling.
    tiling = {k: v for k, v in (("k_tile", eng.k_tile),
                                ("block_m", eng.block_m),
                                ("block_n", eng.block_n)) if v is not None}
    if eng.mesh is not None and eng.shard is not None:
        # the sharded front-end resolves tiling="auto" against the LOCAL
        # shard shapes (pinned knobs still win)
        from repro_torch.kernels.online_dot.matmul_sharded import (
            olm_matmul_sharded)
        return _lowered_dot(eng, x, w, functools.partial(
            olm_matmul_sharded, mesh=eng.mesh, partition=eng.shard,
            axis=eng.shard_axis, trunc=trunc, tiling=eng.tiling,
            **tiling), n_bits)
    if eng.tiling == "auto":
        from repro_torch.kernels.online_dot.tuning import get_tiling
        auto = get_tiling(math.prod(x.shape[:-1]), w.shape[-1],
                          x.shape[-1], n_bits, trunc=trunc)
        tiling = {**auto, **tiling}
    return _lowered_dot(eng, x, w, functools.partial(
        olm_matmul, trunc=trunc, **tiling), n_bits)


def _register_olm_modes() -> None:
    for n in (8, 16, 24, 32):
        wide = n > 16
        decode = ("wide int64 stream decode" if wide
                  else "exact plain-f32 stream decode")
        error = f"<= k_tile * 3.1 ulp @ 2^-{n} per K-tile (olm_error_bound)"
        if wide:
            error = (f"<= k_tile * (3.1 @ 2^-{n} + (T+1) @ 2^-26) per "
                     "K-tile (olm_error_bound wide term)")
        register_mode(
            f"olm{n}",
            summary=f"fused online inner-product array, {n}-digit "
                    f"operands ({decode})",
            error=error,
            cost="Eq.8-truncated digit-serial array")(
            functools.partial(_olm_dot, n_bits=n))
    for n, p in TRUNCATED_SPECS:
        wide = "wide int64" if p > 16 else "exact plain-f32"
        error = (f"<= k_tile * 3.1 * (2^-{n} + 2^-{p}) per K-tile "
                 "(olm_error_bound truncation term)")
        if p > 16:
            error = error[:-1] + " + wide term)"
        register_mode(
            f"olm{n}t{p}",
            summary=f"truncated olm{n}: {p} working digits "
                    f"({wide} stream decode)",
            error=error,
            cost=f"p/n = {p}/{n} of olm{n}'s recurrence iterations")(
            functools.partial(_olm_dot, n_bits=n, trunc=p))


_register_olm_modes()


@dataclasses.dataclass(frozen=True)
class DotEngine:
    mode: str = "native"          # any registered mode, see DotEngine.modes()
    # olm array width (lanes per adder tree); None = the kernel default.
    # A numerics parameter: it changes the bits.
    k_tile: Optional[int] = None
    # Block rows and columns of K1/K2's launch (None = the planner's);
    # block shapes never change the bits.
    block_m: Optional[int] = None
    block_n: Optional[int] = None
    # tiling="auto" takes each GEMM's launch plan from the autotuner
    # (kernels/online_dot/tuning); the knobs pinned above win over it.
    tiling: Optional[str] = None
    # Per-role mode overrides {"attn" | "mlp" | "head": mode}; a dict is
    # normalized to a sorted tuple of pairs so the engine stays hashable.
    layer_modes: Union[Mapping[str, str],
                       Tuple[Tuple[str, str], ...], None] = None
    # Mesh-sharded dispatch: when BOTH mesh (a DeviceMesh) and shard are
    # set, the olm GEMMs run through olm_matmul_sharded over the mesh's
    # shard_axis. shard names the partitioned GEMM dim: "m"/"n" are
    # bit-identical to one device, "k" sums f32 partials (within
    # olm_error_bound, in another order). The other modes ignore all
    # three.
    mesh: Any = None
    shard: Optional[str] = None       # None | "m" | "n" | "k"
    shard_axis: str = "model"         # mesh axis the shard maps over

    _ROLES = frozenset({"attn", "mlp", "head"})

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"unknown DotEngine mode {self.mode!r}; registered: "
                f"{', '.join(sorted(_MODES))}")
        if self.tiling not in (None, "auto"):
            raise ValueError(
                f"unknown DotEngine tiling {self.tiling!r}; expected "
                "None (static knobs / kernel defaults) or 'auto'")
        if self.shard not in (None, "m", "n", "k"):
            raise ValueError(
                f"unknown DotEngine shard {self.shard!r}; expected None "
                "or one of 'm', 'n', 'k'")
        if self.layer_modes is not None:
            pairs = tuple(sorted(dict(self.layer_modes).items()))
            if bad := {r for r, _ in pairs} - self._ROLES:
                raise ValueError(
                    f"unknown layer_modes roles {sorted(bad)}; expected "
                    f"a subset of {sorted(self._ROLES)}")
            if bad := {m for _, m in pairs if m not in _MODES}:
                raise ValueError(
                    f"layer_modes names unregistered modes {sorted(bad)}; "
                    f"registered: {', '.join(sorted(_MODES))}")
            object.__setattr__(self, "layer_modes", pairs or None)

    def for_role(self, role: str) -> "DotEngine":
        """The engine a GEMM of this role ("attn" / "mlp" / "head") runs
        under: self, unless layer_modes overrides the role."""
        if role not in self._ROLES:
            raise ValueError(f"unknown GEMM role {role!r}; expected one "
                             f"of {sorted(self._ROLES)}")
        if not self.layer_modes:
            return self
        mode = dict(self.layer_modes).get(role)
        if mode is None or mode == self.mode:
            return self
        return dataclasses.replace(self, mode=mode, layer_modes=None)

    @staticmethod
    def modes() -> Tuple[str, ...]:
        """Names of all registered modes."""
        return tuple(sorted(_MODES))

    def spec(self) -> "EngineSpec":
        """This engine as an EngineSpec: every field pinned, so
        ``resolve_engine(eng.spec()) == eng`` (round-trip contract)."""
        return EngineSpec(
            mode=self.mode, k_tile=self.k_tile, block_m=self.block_m,
            block_n=self.block_n, tiling=self.tiling,
            layer_modes=self.layer_modes, mesh=self.mesh, shard=self.shard,
            shard_axis=self.shard_axis)

    def dot(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N) -> (..., N), in this engine's numerics."""
        return _MODES[self.mode].fn(self, x, w)


class _Unset:
    """Sentinel distinguishing "leave this field to the base engine"
    from an explicit None/value in EngineSpec (e.g. k_tile=None means
    CLEAR the pin back to the kernel default; k_tile=_UNSET means
    inherit whatever the base engine had)."""
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<unset>"


_UNSET = _Unset()


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One declarative description of a numerics engine (port of
    `repro.core.numerics.EngineSpec`).

    ``resolve_engine(spec)`` turns it into a concrete DotEngine. Name the
    mode either directly (``mode="olm32t16"``) or structurally
    (``n_bits=32, trunc=16``), never both. Every other field defaults to
    the _UNSET sentinel, meaning "inherit from the base engine" when
    resolving against one (``resolve_engine(spec, base=model.eng)``); an
    explicit None overrides the base (clears a pin). The serving-only
    fields (quality_tiers, degrade_ladder) ride the spec unchanged and are
    consumed by ServeEngine, not by resolve_engine.

    Frozen and hashable: dict-valued fields are normalized to sorted
    tuples at construction, as DotEngine.layer_modes is. The reference's
    TPU deployment knobs (interpret, use_pallas) have no counterpart: the
    port dispatches on the operands' device.
    """
    mode: Optional[str] = None
    n_bits: Optional[int] = None
    trunc: Optional[int] = None
    k_tile: Any = _UNSET
    block_m: Any = _UNSET
    block_n: Any = _UNSET
    tiling: Any = _UNSET
    layer_modes: Any = _UNSET
    # Distributed front-end (DotEngine.mesh/shard/shard_axis).
    mesh: Any = _UNSET
    shard: Any = _UNSET
    shard_axis: Any = _UNSET
    # Serving-only: per-request quality tiers {tier: mode} and the degrade
    # ladder (see serving/engine.py). None = unset.
    quality_tiers: Any = None
    degrade_ladder: Any = None

    def __post_init__(self):
        if self.mode is not None and self.n_bits is not None:
            raise ValueError(
                "EngineSpec: give mode= or n_bits= (structural), not both")
        if self.trunc is not None and self.n_bits is None:
            raise ValueError(
                "EngineSpec: trunc= requires n_bits= (structural naming)")
        if isinstance(self.layer_modes, Mapping):
            object.__setattr__(self, "layer_modes",
                               tuple(sorted(self.layer_modes.items())))
        if isinstance(self.quality_tiers, Mapping):
            object.__setattr__(self, "quality_tiers",
                               tuple(sorted(self.quality_tiers.items())))
        if isinstance(self.degrade_ladder, list):
            object.__setattr__(self, "degrade_ladder",
                               tuple(self.degrade_ladder))


# DotEngine fields an EngineSpec can override (same names on both).
_SPEC_ENGINE_FIELDS = ("k_tile", "block_m", "block_n", "tiling",
                       "layer_modes", "mesh", "shard", "shard_axis")


def resolve_engine(spec: EngineSpec, base: Optional[DotEngine] = None,
                   mesh=None) -> DotEngine:
    """Resolve an EngineSpec into a concrete DotEngine.

    Field resolution order: explicit spec field > ``mesh=`` argument
    (mesh only) > ``base`` engine field > DotEngine default. The mode
    comes from ``spec.mode``, or is derived from ``spec.n_bits`` /
    ``spec.trunc`` (``olm{n}`` / ``olm{n}t{p}``) and validated against
    the registry; with neither set, the base engine's mode (or the
    DotEngine default) stands.
    """
    if base is not None and not isinstance(base, DotEngine):
        raise TypeError(f"base must be a DotEngine, got {type(base).__name__}")
    kw = ({} if base is None else
          {f.name: getattr(base, f.name) for f in dataclasses.fields(DotEngine)})
    if spec.mode is not None:
        kw["mode"] = spec.mode
    elif spec.n_bits is not None:
        name = (f"olm{spec.n_bits}t{spec.trunc}" if spec.trunc is not None
                else f"olm{spec.n_bits}")
        if name not in _MODES:
            raise ValueError(
                f"EngineSpec(n_bits={spec.n_bits}, trunc={spec.trunc}) "
                f"resolves to unregistered mode {name!r}; registered: "
                f"{', '.join(sorted(_MODES))}")
        kw["mode"] = name
    if mesh is not None:
        kw["mesh"] = mesh
    for name in _SPEC_ENGINE_FIELDS:
        v = getattr(spec, name)
        if v is not _UNSET:
            kw[name] = v
    return DotEngine(**kw)
