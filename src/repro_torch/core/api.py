"""Optimizer factory: build an optimizer by its CLI name (counterpart of
``repro.core.api``).  The low-rank zoo is ported; the dense baselines
``adamw`` and ``badam`` raise "not yet ported"."""

from __future__ import annotations

from typing import Any

from repro_torch.core import subtrack

_REGISTRY = {
    "subtrack": subtrack.subtrack,
    "subtrack_fast": subtrack.subtrack_fast,
    "grassmann_only": subtrack.grassmann_only,
    "galore": subtrack.galore,
    "fira": subtrack.fira,
    "golore": subtrack.golore,
    "osd": subtrack.osd,
    "apollo": subtrack.apollo,
}
_NOT_PORTED = ("adamw", "badam")


def optimizer_names() -> list[str]:
    return sorted(list(_REGISTRY) + list(_NOT_PORTED))


def get_optimizer(name: str, **overrides: Any) -> subtrack.GradientTransform:
    """Build an optimizer by name; ``overrides`` go to the variant's
    constructor (unknown keys raise)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(f"optimizer {name!r} is not yet ported to "
                                  "repro_torch")
    try:
        ctor = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; options: "
                         f"{optimizer_names()}") from None
    return ctor(**overrides)
