"""Named variable specifications.

JAX replacement for the reference's symbolic ``Container``/``Vector`` machinery
(reference: hilo_mpc/modules/base.py:373,591): instead of named CasADi symbol vectors we
keep a lightweight ordered name spec with metadata (units/labels/descriptions) and scaling,
and the actual values are plain JAX arrays indexed positionally. Name-based access maps to
indices once at setup time, so nothing stringly-typed survives into the jitted compute path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


def _as_name_list(names: Union[int, str, Sequence[str], None], prefix: str) -> List[str]:
    """Normalize a variable declaration to a list of names.

    Accepts: an int (``3`` -> ``[prefix_0, prefix_1, prefix_2]``), a single name, or a
    sequence of names.
    """
    if names is None:
        return []
    if isinstance(names, (int, np.integer)):
        n = int(names)
        if n < 0:
            raise ValueError(f"number of {prefix!r} variables must be >= 0, got {n}")
        if n == 1:
            return [prefix]
        return [f"{prefix}_{i}" for i in range(n)]
    if isinstance(names, str):
        return [names]
    out = list(names)
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate variable names in {out}")
    return out


@dataclasses.dataclass
class VarSpec:
    """Ordered set of named scalar variables with metadata and scaling."""

    names: List[str] = dataclasses.field(default_factory=list)
    units: Dict[str, str] = dataclasses.field(default_factory=dict)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    descriptions: Dict[str, str] = dataclasses.field(default_factory=dict)
    scaling: Optional[np.ndarray] = None  # per-variable positive scale factors

    @property
    def n(self) -> int:
        return len(self.names)

    def __len__(self) -> int:
        return len(self.names)

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def __iter__(self):
        return iter(self.names)

    def index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"unknown variable {name!r}; have {self.names}") from None

    def indices(self, names: Union[str, Sequence[str]]) -> List[int]:
        if isinstance(names, str):
            names = [names]
        return [self.index(nm) for nm in names]

    def add(self, names: Union[int, str, Sequence[str]], prefix: str = "v") -> List[str]:
        new = _as_name_list(names, prefix)
        for nm in new:
            if nm in self.names:
                raise ValueError(f"variable {nm!r} already declared")
        self.names.extend(new)
        return new

    def remove(self, names: Union[str, Sequence[str]]) -> None:
        if isinstance(names, str):
            names = [names]
        for nm in names:
            self.names.remove(nm)
            self.units.pop(nm, None)
            self.labels.pop(nm, None)
            self.descriptions.pop(nm, None)

    def set_meta(self, name: str, *, unit: str = None, label: str = None,
                 description: str = None) -> None:
        if name not in self.names:
            raise KeyError(f"unknown variable {name!r}")
        if unit is not None:
            self.units[name] = unit
        if label is not None:
            self.labels[name] = label
        if description is not None:
            self.descriptions[name] = description

    def get_scaling(self) -> np.ndarray:
        if self.scaling is None:
            return np.ones(self.n)
        return np.asarray(self.scaling, dtype=float)

    def set_scaling(self, scaling) -> None:
        if isinstance(scaling, dict):
            vec = self.get_scaling()
            for k, v in scaling.items():
                vec[self.index(k)] = float(v)
            self.scaling = vec
        else:
            vec = np.atleast_1d(np.asarray(scaling, dtype=float))
            if vec.size == 1:
                vec = np.full(self.n, vec.item())
            if vec.size != self.n:
                raise ValueError(f"scaling has {vec.size} entries, expected {self.n}")
            self.scaling = vec
        if np.any(self.get_scaling() <= 0):
            raise ValueError("scaling factors must be positive")

    def copy(self) -> "VarSpec":
        return VarSpec(
            names=list(self.names),
            units=dict(self.units),
            labels=dict(self.labels),
            descriptions=dict(self.descriptions),
            scaling=None if self.scaling is None else np.array(self.scaling),
        )
