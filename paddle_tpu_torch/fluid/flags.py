"""Global flags: the subset of ``paddle_tpu/fluid/flags.py`` the decode
serving lane reads.

Any ``FLAGS_<name>`` environment variable seen at import time seeds the
flag, as in the JAX package; a malformed value warns and keeps the
default.
"""

from __future__ import annotations

import os
import warnings

__all__ = ["flag"]

# name -> (default, parser)
_DEFS = {
    # graph-optimization pass selection (passes/framework.py grammar)
    "FLAGS_graph_passes": ("default", str),
    # serving admission: queue limit and per-tenant live-request quota
    # (0 = unlimited)
    "FLAGS_serving_max_queue": (256, int),
    "FLAGS_serving_tenant_quota": (0, int),
}

_VALUES = {}


def _bootstrap():
    for name, (default, parser) in _DEFS.items():
        _VALUES[name] = default
        env = os.environ.get(name)
        if env is None:
            continue
        try:
            _VALUES[name] = parser(env)
        except (ValueError, TypeError):
            warnings.warn(f"ignoring malformed env {name}={env!r}; using "
                          f"default {default!r}")


def _norm(name):
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def flag(name):
    """A flag's value; ``name`` with or without the ``FLAGS_`` prefix."""
    return _VALUES[_norm(name)]


_bootstrap()
