"""The warm-start cache of the PyTorch port (``fluid/aot_cache.py``,
FLAGS_aot_cache_dir), held to the contract of the JAX package's
(tests/test_aot_warmstart.py).

A CUDA graph cannot be serialized, so the port keeps what the executor
derives from a program before it captures (the pass-rewritten program,
its pass report and its plan): a restarted process books
``pt_compile_cache_total{result="aot_hit"}`` and runs neither the graph
passes nor the plan's analysis (no ``phase="passes"`` and no
``phase="trace"`` seconds).

- The key is stable across program rebuilds and across processes, and
  changes with each keyed field: a feed's shape, the fetch list, the
  op wiring, the dtype policy, FLAGS_graph_passes, the device.
- A corrupt entry warns once, is deleted and rebuilt; a stale one (its
  program differs) as well; the run's results do not change.
- A restarted ``DecodeEngine`` (cold in this process, warm in a fresh
  one, each asked for the CPU): the warm one books aot_hit for every
  program with no miss, no passes and no trace seconds, and serves the
  same tokens (tests/test_aot_warmstart.py:111's assertions).
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fluid import aot_cache


def _build(size=3):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.data("x", [-1, 4], False, dtype="float32")
        h = fluid.layers.fc(x, size=8, act="gelu")
        loss = fluid.layers.mean(fluid.layers.fc(h, size=size))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    startup.random_seed = 5
    return main, startup, loss


def _build_sub(swap):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        a = fluid.data("fpa", [2, 3], False, dtype="float32")
        b = fluid.data("fpb", [2, 3], False, dtype="float32")
        fluid.layers.elementwise_sub(*((b, a) if swap else (a, b)))
    return main


def _spec(*shape):
    return {"x": torch.zeros(*shape)}


CPU = torch.device("cpu")
KEY_CHILD = """
import json, torch
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import aot_cache
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup), fluid.unique_name.guard():
    x = fluid.data("x", [-1, 4], False, dtype="float32")
    h = fluid.layers.fc(x, size=8, act="gelu")
    loss = fluid.layers.mean(fluid.layers.fc(h, size=3))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
print("KEY " + aot_cache.entry_key(main, {"x": torch.zeros(2, 4)},
                                   [loss.name], torch.device("cpu")))
"""


def test_key_is_stable_and_changes_with_each_keyed_field():
    main, _, loss = _build()
    k1 = aot_cache.entry_key(main, _spec(2, 4), [loss.name], CPU)
    assert aot_cache.entry_key(_build()[0], _spec(2, 4), [loss.name],
                               CPU) == k1
    assert aot_cache.entry_key(main, _spec(3, 4), [loss.name], CPU) != k1
    assert aot_cache.entry_key(main, _spec(2, 4), ["other"], CPU) != k1
    assert aot_cache.entry_key(_build(size=4)[0], _spec(2, 4),
                               [loss.name], CPU) != k1
    assert aot_cache.entry_key(main, _spec(2, 4), [loss.name],
                               torch.device("meta")) != k1
    prior = fluid.get_flags("FLAGS_graph_passes")
    fluid.set_flags({"FLAGS_graph_passes": "none"})
    try:
        assert aot_cache.entry_key(main, _spec(2, 4), [loss.name],
                                   CPU) != k1
    finally:
        fluid.set_flags(prior)
    bf16 = _build()[0]
    bf16._dtype_policy = "bf16"
    assert aot_cache.entry_key(bf16, _spec(2, 4), [loss.name], CPU) != k1
    # the wiring counts: swapped operands of one op sequence differ
    assert aot_cache.program_fingerprint(_build_sub(False)) == \
        aot_cache.program_fingerprint(_build_sub(False))
    assert aot_cache.program_fingerprint(_build_sub(False)) != \
        aot_cache.program_fingerprint(_build_sub(True))


def _counts():
    snap = obs.snapshot()
    cache = snap.get("pt_compile_cache_total", {}).get("samples", {})
    secs = snap.get("pt_compile_seconds_total", {}).get("samples", {})
    return ({k[1]: v for k, v in cache.items() if k[0] == "single"},
            {k[1]: v for k, v in secs.items() if k[0] == "single"})


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(before) | set(after)
            if after.get(k, 0) != before.get(k, 0)}


def _train(n=3):
    main, startup, loss = _build()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(0).rand(2, 4).astype("float32")
    losses = [float(exe.run(main, feed={"x": xv}, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(n)]
    return losses, main


@pytest.fixture
def cache_dir(tmp_path):
    prior = fluid.get_flags("FLAGS_aot_cache_dir")
    fluid.set_flags({"FLAGS_aot_cache_dir": str(tmp_path)})
    yield str(tmp_path)
    fluid.set_flags(prior)


def test_warm_start_in_process_and_corrupt_or_stale_entries(cache_dir):
    """Cold: a miss a program, its passes and plan built, an entry each
    saved.  Warm (fresh programs, as a restart builds them): aot_hit a
    program, no miss, no passes, no trace seconds, the same losses and
    the pass-rewritten program.  A corrupt entry, then a stale one,
    warn once, are rebuilt, and the losses stay the same."""
    c0, s0 = _counts()
    cold, cold_main = _train()
    c1, s1 = _counts()
    assert _delta(c0, c1) == {"miss": 2, "hit": 2}
    assert {"trace", "passes", "aot_load", "aot_save"} <= set(
        _delta(s0, s1))  # the misses' lookups and saves
    files = sorted(os.listdir(cache_dir))
    assert len(files) == 2 and all(f.endswith(".aot.json") for f in files)
    warm, warm_main = _train()
    c2, s2 = _counts()
    assert _delta(c1, c2) == {"aot_hit": 2, "hit": 2}
    assert set(_delta(s1, s2)) == {"aot_load", "first_run"}  # no passes
    assert warm == cold
    assert [op.type for op in warm_main.global_block().ops] == \
        [op.type for op in cold_main.global_block().ops]
    assert warm_main._graph_passes_done == cold_main._graph_passes_done
    for name in files:  # corrupt every entry
        with open(os.path.join(cache_dir, name), "w") as f:
            f.write("{not json")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        again, _ = _train()
    msgs = [str(w.message) for w in rec if "warm-start cache" in str(w.message)]
    assert len(msgs) == 2 and all("failed to load" in m for m in msgs)
    assert again == cold
    c3, _ = _counts()
    assert _delta(c2, c3) == {"miss": 2, "hit": 2}
    assert sorted(os.listdir(cache_dir)) == files  # rebuilt
    # stale: an entry whose plan no longer matches its program
    main_file = max(files, key=lambda n: os.path.getsize(
        os.path.join(cache_dir, n)))
    path = os.path.join(cache_dir, main_file)
    entry = json.load(open(path))
    entry["plan"]["fingerprint"] = "0" * 40
    json.dump(entry, open(path, "w"))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        stale, _ = _train()
    assert [str(w.message) for w in rec
            if "is stale" in str(w.message)]
    assert stale == cold
    assert json.load(open(path))["plan"]["fingerprint"] != "0" * 40


DECODE = """
import json
import numpy as np
from paddle_tpu_torch import fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fluid import aot_cache
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import DecodeEngine


def counts():
    snap = obs.snapshot()
    c = snap.get("pt_compile_cache_total", {}).get("samples", {})
    s = snap.get("pt_compile_seconds_total", {}).get("samples", {})
    return ({k[1]: v for k, v in c.items() if k[0] == "single"},
            {k[1]: v for k, v in s.items() if k[0] == "single"})


def serve():
    \"\"\"A DecodeEngine over a seeded 1-layer GPT: warm-up, then one
    request of 3 new tokens; the cache and compile counts after each.\"\"\"
    cfg = gpt.GPTConfig.tiny(num_layers=1, vocab_size=64, hidden_size=32,
                             num_heads=4, intermediate_size=64,
                             max_position=16)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_lm(cfg)
    startup.random_seed = 3
    scope = fluid.Scope()
    before = counts()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    eng = DecodeEngine(cfg, scope=scope, place=fluid.CPUPlace(),
                       pool_slots=2, page_size=4, prefill_chunk=4,
                       max_len=8, name="aot", auto_start=False)
    eng.warmup()
    after_warmup = counts()
    eng.start()
    toks = eng.generate([[3, 5, 7]], max_new_tokens=3, timeout=120)[0]
    after_traffic = counts()
    eng.close()
    return {"before": before, "warmup": after_warmup,
            "traffic": after_traffic, "tokens": toks,
            "cache_bytes": aot_cache.cache_bytes()}
"""


def _warm_child(cache):
    """``serve()`` in a fresh process over the cache directory, and the
    key that process computes for ``_build()``'s program."""
    repo = Path(__file__).resolve().parent.parent
    script = DECODE + 'print("AOT " + json.dumps(serve()))\n' + KEY_CHILD
    r = subprocess.run([sys.executable, "-c", script],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(repo),
                                FLAGS_aot_cache_dir=cache))
    assert r.returncode == 0, r.stderr[-3000:]
    out = {}
    for line in r.stdout.splitlines():
        if line.startswith("AOT "):
            out.update(json.loads(line[4:]))
        elif line.startswith("KEY "):
            out["key"] = line[4:]
    return out


def _since(run, when):
    """(cache counts, compile seconds) ``run`` booked up to ``when``."""
    return tuple(_delta(b, a) for b, a in zip(run["before"], run[when]))


def test_restarted_decode_engine_books_aot_hit_and_runs_no_passes(
        cache_dir):
    """The cold engine runs in this process, the restarted one in a
    fresh process over the same cache directory."""
    ns = {}
    exec(DECODE, ns)
    run1 = ns["serve"]()
    c1, s1 = _since(run1, "warmup")
    c2, _ = _since(run1, "traffic")
    assert c1.get("miss", 0) >= 2 and c1.get("aot_hit", 0) == 0
    assert s1.get("trace", 0) > 0
    files = [f for f in os.listdir(cache_dir) if f.endswith(".aot.json")]
    assert len(files) >= 2 and run1["cache_bytes"] > 0
    run2 = _warm_child(cache_dir)
    # the key a fresh process computes is this process's
    main, _, loss = _build()
    assert run2["key"] == aot_cache.entry_key(
        main, {"x": torch.zeros(2, 4)}, [loss.name], CPU)
    c1, s1 = _since(run2, "warmup")
    c2, s2 = _since(run2, "traffic")
    # the restart: every program from the cache, no miss, no passes, no
    # plan analysis, and the first request adds nothing
    assert c1.get("miss", 0) == 0 and c1.get("aot_hit", 0) >= 2
    assert s1.get("trace", 0) == 0 and s1.get("passes", 0) == 0
    assert s1.get("aot_load", 0) > 0
    assert c2.get("miss", 0) == 0
    assert c2.get("aot_hit", 0) == c1.get("aot_hit", 0)
    assert sorted(os.listdir(cache_dir)) == sorted(files)
    assert run2["tokens"] == run1["tokens"]
