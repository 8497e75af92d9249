"""The warm-start cache (FLAGS_aot_cache_dir): what the executor derives
from a program before it captures, kept across a restart (counterpart of
``paddle_tpu/fluid/aot_cache.py``).

The JAX package serializes each compiled XLA executable, and a restarted
process deserializes it and runs it with no trace and no compile.  A
CUDA graph cannot be serialized: its nodes hold this process's device
pointers and its kernels' handles.  What the port can keep is what the
executor builds from a program before the capture:

- the pass-rewritten program (``io.program_to_dict``), with its
  ``_pass_report``: the graph passes (FLAGS_graph_passes) do not run
  again;
- the plan (``executor._Plan``): the pruned op list (positions in the
  block), the names it reads from the scope and writes back, and after
  each step the names it frees, so the plan's pruning and liveness
  analysis does not run again (its lowerings are bound again by name);
- the names of the kernel libraries the run loaded, whose builds
  ``kernels/_build.py`` keeps on disk (content-hashed), checked to be
  there.

An entry is keyed by :func:`entry_key`: the program's fingerprint (op
types, their wiring, their process-independent attrs and the var specs,
over every block, with the program's dtype policy), the feeds' names,
shapes and dtypes, the fetch list, FLAGS_graph_passes, the card's name,
the torch and CUDA versions and a hash of the port's sources that make
an entry (its passes, executor, registry, io and framework).

On a hit the restarted process books
``pt_compile_cache_total{result="aot_hit"}``, and no ``phase="passes"``
and no ``phase="trace"`` seconds; it still warms up and captures
(``phase="capture"``).  The cache's own cost is booked on a hit and a
miss alike: ``phase="aot_load"`` (the lookup, and a hit's plan) and
``phase="aot_save"`` (a miss's entry written).  A stale, corrupt or
cross-version entry warns once, is deleted and is built again: the
fallback is the cache's, never a kernel's (the kernels are launched
either way).

Scope: a program's first signature (the one its passes run for) on the
single-device executor, ``run`` and ``run_steps``; a later signature of
the same program builds its plan as before.  The cache directory is
for one machine's card and toolchain (the key holds them).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import warnings

import torch

__all__ = ["enabled", "cache_dir", "entry_key", "load", "save",
           "program_fingerprint", "FORMAT"]

FORMAT = "PTAOT1"
_SUFFIX = ".aot.json"
_warned = set()
_warn_lock = threading.Lock()


def _warn_once(tag, msg):
    with _warn_lock:
        if tag in _warned:
            return
        _warned.add(tag)
    warnings.warn(msg)


def cache_dir():
    from . import flags as _flags

    return _flags.flag("aot_cache_dir") or None


def enabled():
    return bool(cache_dir())


def _stable(v):
    """Attr values whose repr is the same in every process join the
    fingerprint (a Variable's or a block's repr can hold an address)."""
    if isinstance(v, (bool, int, float, str, bytes, type(None))):
        return True
    if isinstance(v, (list, tuple)):
        return all(_stable(x) for x in v)
    return False


def program_fingerprint(program):
    """A restart-stable hash of a program: op types, each slot's wiring
    and stable attrs, and the var specs, over every block, and the
    program's dtype policy and test mode.  The wiring counts: two
    programs with the same op sequence, attrs and vars but swapped
    operands must not share an entry."""
    h = hashlib.sha1()
    h.update(repr((getattr(program, "_dtype_policy", None),
                   bool(getattr(program, "_is_test", False)))).encode())
    for b in program.blocks:
        for op in b.ops:
            h.update(str(op.type).encode())
            h.update(b"\x00")
            for slot in sorted(op.inputs):
                h.update(f"i:{slot}={op.inputs[slot]!r}".encode())
                h.update(b"\x00")
            for slot in sorted(op.outputs):
                h.update(f"o:{slot}={op.outputs[slot]!r}".encode())
                h.update(b"\x00")
            for k in sorted(op.attrs):
                v = op.attrs[k]
                if _stable(v):
                    h.update(f"{k}={v!r}".encode())
                    h.update(b"\x00")
        for name in sorted(b.vars):
            v = b.vars[name]
            h.update(repr((name, tuple(v.shape or ()), v.dtype,
                           bool(v.persistable))).encode())
            h.update(b"\x00")
    return h.hexdigest()


_CODE = []


def code_tag():
    """A hash of the port's sources that make an entry (the passes, the
    executor, the registry, the io layer): an entry made by other code
    is another key."""
    if not _CODE:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        h = hashlib.sha1()
        files = [os.path.join(root, "fluid", n) for n in (
            "executor.py", "registry.py", "io.py", "framework.py")]
        passes = os.path.join(root, "passes")
        files += sorted(os.path.join(passes, n) for n in os.listdir(passes)
                        if n.endswith(".py"))
        for path in files:
            with open(path, "rb") as f:
                h.update(f.read())
        _CODE.append(h.hexdigest()[:16])
    return _CODE[0]


def platform_tag(device):
    """The card (or the CPU), torch's and CUDA's versions, and the
    port's own code (:func:`code_tag`)."""
    device = torch.device(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return f"{device.type}|{kind}|torch{torch.__version__}|" \
           f"cuda{torch.version.cuda}|port{code_tag()}"


def entry_key(program, feeds, fetch_names, device):
    """The on-disk key of a signature (module docstring); ``feeds`` maps
    each feed name to a tensor (or anything with ``shape`` and
    ``dtype``)."""
    from . import flags as _flags

    h = hashlib.sha1()
    h.update(program_fingerprint(program).encode())
    for name in sorted(feeds):
        v = feeds[name]
        h.update(repr((name, tuple(v.shape), str(v.dtype))).encode())
        h.update(b"\x00")
    h.update(repr(tuple(fetch_names)).encode())
    h.update(repr(_flags.flag("graph_passes")).encode())
    h.update(platform_tag(device).encode())
    return h.hexdigest()


def _path(key):
    return os.path.join(cache_dir(), key + _SUFFIX)


def _drop(path):
    try:
        os.unlink(path)
    except OSError:
        pass


def load(key):
    """The entry saved under ``key`` (a dict), or None when absent or
    unreadable; an unreadable one warns once and is deleted, so the
    next save replaces it."""
    if not enabled():
        return None
    path = _path(key)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            entry = json.load(f)
        if entry.get("format") != FORMAT or entry.get("key") != key:
            raise ValueError(f"not a {FORMAT} entry of this key")
        return entry
    except (OSError, ValueError, TypeError, AttributeError) as e:
        stale(key, f"failed to load ({e!r})", "load")
        return None


def stale(key, why, kind="stale"):
    """Warn once (a ``kind`` of fault an entry) that ``key``'s entry
    cannot be used, and delete it."""
    if not enabled():
        return
    path = _path(key)
    _warn_once(f"{kind}:{key}",
               f"warm-start cache entry {path} {why}; building the "
               f"program's passes and plan again and replacing it")
    _drop(path)


def save(key, entry):
    """Write ``entry`` under ``key`` (temp + rename: a crashed save never
    truncates a good entry).  A failure warns once; the run goes on."""
    if not enabled():
        return False
    try:
        d = cache_dir()
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{key}.{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            json.dump(dict(entry, format=FORMAT, key=key), f)
        os.replace(tmp, _path(key))
        return True
    except (OSError, TypeError, ValueError) as e:
        _warn_once("save:" + key,
                   f"warm-start cache save failed ({e!r}); the run goes "
                   f"on uncached")
        return False


def cache_bytes():
    """Bytes of every entry in the cache directory."""
    d = cache_dir()
    if not d or not os.path.isdir(d):
        return 0
    return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d)
               if n.endswith(_SUFFIX))
