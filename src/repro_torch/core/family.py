"""The variational-family protocol (mirrors ``repro.core.family``).

Families are frozen dataclasses deriving from :class:`VariationalFamily`.
Capability flags replace type probes:

  * ``conditional`` — the family parameterizes q(Z_L | Z_G); its
    ``sample``/``log_prob`` take ``(params, z_G, mu_G, eps)`` /
    ``(params, z_L, z_G, mu_G)``;
  * ``eps_shape`` — the shape of the N(0, I) draw ``sample`` consumes;
  * ``has_moments`` + ``moment_form`` — whether the Gaussian moment
    bridge (``to_moments``/``from_moments``) exists, and its form.

Parameters are plain dicts of tensors with the reference's key names.

The registry (``register_family``/``get_family``/``family_names``) and
the declarative :class:`FamilySpec` + :func:`build_family` mirror
``repro/core/family.py:191-288``: ``FamilySpec("cholesky")`` swaps any
model's family for a registered one, with ``dim``/``global_dim`` filled
from the model.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional, Tuple, Type

import torch

from repro_torch.core.flatten import VectorSpec

Params = Dict[str, torch.Tensor]


class VariationalFamily:
    """Protocol base class for variational families (see module docstring)."""

    conditional: ClassVar[bool] = False
    has_moments: ClassVar[bool] = False
    moment_form: ClassVar[Optional[str]] = None  # "diag" | "full" | None

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Name -> shape of every parameter leaf (defines the pack layout)."""
        raise NotImplementedError

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return ()

    @property
    def eps_shape(self) -> Tuple[int, ...]:
        return self.batch_shape + (self.dim,)  # type: ignore[attr-defined]

    @property
    def num_params(self) -> int:
        return self.vector_spec.dim

    @property
    def vector_spec(self) -> VectorSpec:
        return VectorSpec.create(self.param_shapes())

    def pack(self, params: Params) -> torch.Tensor:
        return self.vector_spec.pack(params)

    def unpack(self, vec: torch.Tensor) -> Params:
        return self.vector_spec.unpack(vec)

    def init(self, gen: torch.Generator, **kwargs) -> Params:
        raise NotImplementedError

    def sample(self, params: Params, *args) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, params: Params, *args) -> torch.Tensor:
        raise NotImplementedError

    def entropy(self, params: Params) -> torch.Tensor:
        raise NotImplementedError

    def mean(self, params: Params) -> torch.Tensor:
        """The (unconditional) mean — the μ the C-coupling centers on."""
        return params["mu"]

    def to_moments(self, params: Params):
        raise NotImplementedError(
            f"{type(self).__name__} exposes no Gaussian moments")

    def from_moments(self, mean, second) -> Params:
        raise NotImplementedError(
            f"{type(self).__name__} exposes no Gaussian moments")


def eps_shape(family: Any) -> Tuple[int, ...]:
    """Shape of the N(0, I) draw ``family.sample`` consumes."""
    return tuple(family.eps_shape)


def is_conditional(family: Any) -> bool:
    """True when ``family`` parameterizes q(Z_L | Z_G) (the C-coupling)."""
    return bool(getattr(family, "conditional", False))


def supports_moments(family: Any) -> bool:
    """True when ``family`` exposes the to_moments/from_moments bridge."""
    return bool(getattr(family, "has_moments", False))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


FAMILIES: Dict[str, Type[VariationalFamily]] = {}


def register_family(name: str):
    """Class decorator: register a family under ``name`` in ``FAMILIES``."""

    def deco(cls: Type[VariationalFamily]) -> Type[VariationalFamily]:
        if name in FAMILIES:
            raise ValueError(f"family {name!r} registered twice")
        FAMILIES[name] = cls
        return cls

    return deco


def _ensure_registered() -> None:
    # The concrete families live in repro_torch.core.families, which
    # imports this module for the base class; importing it here, lazily,
    # fills the registry without a circular import.
    if not FAMILIES:
        import repro_torch.core.families  # noqa: F401


def get_family(name: str) -> Type[VariationalFamily]:
    """Resolve a registered family class; raises with the available names."""
    _ensure_registered()
    try:
        return FAMILIES[name]
    except KeyError:
        raise KeyError(
            f"unknown family {name!r}; registered families: "
            + ", ".join(sorted(FAMILIES))) from None


def family_names() -> Tuple[str, ...]:
    """Sorted registered names (CLI choices)."""
    _ensure_registered()
    return tuple(sorted(FAMILIES))


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """Declarative reference to a registered family: ``(name, kwargs)``.

    ``kwargs`` are JSON-native; the structural dimensions the model owns
    (``dim``, ``global_dim``) are filled by :func:`build_family`.
    """

    name: str
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> FamilySpec:
        return cls(name=d["name"], kwargs=dict(d.get("kwargs", {})))

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "kwargs": dict(self.kwargs)}


def build_family(spec: FamilySpec, dim: Optional[int] = None,
                 global_dim: Optional[int] = None) -> VariationalFamily:
    """Instantiate ``spec``; ``dim``/``global_dim`` fill the matching
    constructor fields unless the spec's kwargs pin them."""
    cls = get_family(spec.name)
    kwargs = dict(spec.kwargs)
    fields = dataclasses.fields(cls)
    if dim is not None and any(f.name == "dim" for f in fields):
        kwargs.setdefault("dim", dim)
    if global_dim is not None and any(f.name == "global_dim" for f in fields):
        kwargs.setdefault("global_dim", global_dim)
    missing = [
        f.name for f in fields
        if f.name not in kwargs
        and f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING
    ]
    if missing:
        raise ValueError(
            f"family {spec.name!r} needs explicit kwargs for {missing}: only "
            f"dim/global_dim are derivable from the model; pass them in "
            f"FamilySpec.kwargs (got {sorted(kwargs)})")
    return cls(**kwargs)
