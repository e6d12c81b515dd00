"""Backend plugin registry (paper §4, Table 1).

Backends register which subset of the five manager roles they implement.
``capability_table()`` reproduces the paper's Table 1 for our backends, and
``build()`` instantiates a manager role by backend name — the mechanism that
lets a HiCR application switch technologies without source changes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Sequence

ROLES = ("topology", "instance", "communication", "memory", "compute")


@dataclasses.dataclass(frozen=True)
class BackendInfo:
    name: str
    #: role -> factory producing a manager instance for that role.
    factories: Mapping[str, Callable[..., object]]
    description: str = ""

    @property
    def roles(self) -> Sequence[str]:
        return tuple(r for r in ROLES if r in self.factories)


_REGISTRY: Dict[str, BackendInfo] = {}


def register_backend(name: str, factories: Mapping[str, Callable[..., object]], description: str = "") -> None:
    for role in factories:
        if role not in ROLES:
            raise ValueError(f"unknown manager role {role!r}; valid: {ROLES}")
    _REGISTRY[name] = BackendInfo(name=name, factories=dict(factories), description=description)


def available_backends() -> Sequence[str]:
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))


def get_backend(name: str) -> BackendInfo:
    _ensure_builtin()
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def build(backend: str, role: str, **kwargs):
    """Instantiate `role` manager from `backend` (the paper's Fig. 4 pattern,
    minus the C++)."""
    info = get_backend(backend)
    if role not in info.factories:
        raise KeyError(
            f"backend {backend!r} does not implement role {role!r} "
            f"(implements {info.roles})"
        )
    return info.factories[role](**kwargs)


def capability_table() -> Dict[str, Dict[str, bool]]:
    """Our analogue of the paper's Table 1: backend -> role -> supported."""
    _ensure_builtin()
    return {
        name: {role: (role in info.factories) for role in ROLES}
        for name, info in sorted(_REGISTRY.items())
    }


_BUILTIN_LOADED = False


def _ensure_builtin():
    """Lazily import built-in backends so importing `repro_torch.core` stays cheap
    and never touches jax device state."""
    global _BUILTIN_LOADED
    if _BUILTIN_LOADED:
        return
    _BUILTIN_LOADED = True
    from repro_torch import backends  # noqa: F401  (registers on import)
