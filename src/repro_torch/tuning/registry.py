"""Process-level table of active tuned kernel configs.

The counterpart of ``repro.tuning.registry``: kernel wrappers whose launch
choices are left at ``None`` consult it after the ``tuned`` bundle
(``GNNConfig.tuned``) and before the default (``resolve``). Keys are
geometry keys (``space.*Geometry.key()``, kernel name included); platform
scoping happens at activation time — ``activate(cache)`` only loads cache
entries recorded for the current platform.
"""
from __future__ import annotations

_ACTIVE: dict = {}


def register(key: tuple, config) -> None:
    _ACTIVE[tuple(key)] = config


def lookup(key: tuple):
    return _ACTIVE.get(tuple(key))


def clear() -> None:
    _ACTIVE.clear()


def active() -> dict:
    return dict(_ACTIVE)


def activate(cache, platform: str | None = None, device="cuda") -> int:
    """Bulk-register a ``TuneCache``'s entries for one platform (default:
    the platform of ``device``). Returns the number of configs
    activated."""
    from .autotune import current_platform
    platform = platform or current_platform(device)
    n = 0
    for key, config in cache.configs_for(platform):
        register(key, config)
        n += 1
    return n


def resolve(geom, explicit=None, tuned=None):
    """The launch choice of one kernel launch: ``explicit`` (the caller's)
    if given, else the ``tuned`` bundle's entry for ``geom``, else this
    registry's, else the kernel's default (``space.default_config``)."""
    if explicit is not None:
        return explicit
    config = tuned.lookup(geom.key()) if tuned is not None else None
    if config is None:
        config = lookup(geom.key())
    if config is None:
        from .space import default_config
        config = default_config(geom)
    return config
