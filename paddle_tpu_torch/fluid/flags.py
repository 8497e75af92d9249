"""Global flags: the subset of ``paddle_tpu/fluid/flags.py`` the port's
serving lanes and graph passes read.

Any ``FLAGS_<name>`` environment variable seen at import time seeds the
flag, as in the JAX package; a malformed value warns and keeps the
default.  ``set_flags`` / ``get_flags`` change and read them at run
time (an entry point reads its flags when it is built, not at import).
"""

from __future__ import annotations

import os
import warnings

__all__ = ["flag", "get_flags", "set_flags"]

_FALSY = ("0", "false", "off", "no", "")


def _parse_bool(v):
    return str(v).strip().lower() not in _FALSY


# name -> (default, parser)
_DEFS = {
    # graph-optimization pass selection (passes/framework.py grammar)
    "FLAGS_graph_passes": ("default", str),
    # serving: row buckets; optional sequence buckets for feeds whose
    # dim 1 is dynamic ("" disables sequence padding, e.g. "32,64,128");
    # the continuous batcher's max wait; the admission queue limit; the
    # per-request deadline (0 = none); the decode lane's per-tenant
    # live-request quota (0 = unlimited)
    "FLAGS_serving_batch_buckets": ("1,2,4,8,16", str),
    "FLAGS_serving_seq_buckets": ("", str),
    "FLAGS_serving_batch_timeout_ms": (5, int),
    "FLAGS_serving_max_queue": (256, int),
    "FLAGS_serving_deadline_ms": (0, int),
    "FLAGS_serving_tenant_quota": (0, int),
    # serving.Engine.load_model(ragged=None): pad every dynamic dim-1
    # feed to ONE length (the largest sequence bucket) so mixed-length
    # traffic batches together; the model masks the tail itself
    # (layers.ragged_attention)
    "FLAGS_ragged_attention": (False, _parse_bool),
    # DecodeEngine(pool_dtype=None) resolves to the dual-int8 KV pool
    "FLAGS_int8_kv_cache": (False, _parse_bool),
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


def _known(name):
    key = _norm(name)
    if key not in _DEFS:
        raise KeyError(f"unknown flag {name!r}; known: {sorted(_DEFS)}")
    return key


def flag(name):
    """A flag's value; ``name`` with or without the ``FLAGS_`` prefix."""
    return _VALUES[_norm(name)]


def get_flags(names):
    """{name: value} for a name or a list of names."""
    if isinstance(names, str):
        names = [names]
    return {n: _VALUES[_known(n)] for n in names}


def set_flags(flags):
    """Set flags from a dict; a string value goes through the flag's
    parser, as an environment value does."""
    for n, v in flags.items():
        key = _known(n)
        _VALUES[key] = _DEFS[key][1](v) if isinstance(v, str) else v


_bootstrap()
