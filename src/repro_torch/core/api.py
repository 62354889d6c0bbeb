"""Optimizer factory: build an optimizer by its CLI name (counterpart of
``repro.core.api``)."""

from __future__ import annotations

from typing import Any

from repro_torch.core import baselines, subtrack

_REGISTRY = {
    # the paper's method and its ablations
    "subtrack": subtrack.subtrack,
    "subtrack_fast": subtrack.subtrack_fast,
    "grassmann_only": subtrack.grassmann_only,
    # baselines the paper compares against
    "adamw": baselines.adamw,
    "galore": subtrack.galore,
    "fira": subtrack.fira,
    "golore": subtrack.golore,
    "osd": subtrack.osd,
    "apollo": subtrack.apollo,
    "badam": baselines.badam,
}


def optimizer_names() -> list[str]:
    return sorted(_REGISTRY)


def get_optimizer(name: str, **overrides: Any) -> subtrack.GradientTransform:
    """Build an optimizer by name; ``overrides`` go to the variant's
    constructor (unknown keys raise)."""
    try:
        ctor = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; options: "
                         f"{optimizer_names()}") from None
    return ctor(**overrides)
