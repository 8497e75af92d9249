"""Preemption checkpoints and the durable rollback window in the PyTorch
port (``fluid/incubate/checkpoint``, ``health/persist.py``, the
sentinel's ``export_state`` / ``restore_state``), against the JAX
package.

Counterparts of tests/test_auto_checkpoint.py's six tests and of
tests/test_health_persist.py's nine.  Each scenario runs in both
packages on the same program (fc(4 -> 1) under SGD 0.05, the JAX tests'
program) and the same seeded feeds, from the same start (the JAX
package's startup values copied into the port's scope), and the
resumed losses and weights of the port are held within 1e-6 of the JAX
package's.  One more test shows that a resume after the first run
copies into the scope's own tensors, which a captured graph reads
(tests/test_torch_port_cuda.py replays one on the card).
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.distributed import fault_injection as jfault
from paddle_tpu.fluid.incubate.checkpoint import AutoCheckpoint as JCkpt
from paddle_tpu.health import persist as jpersist

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.distributed import fault_injection as tfault
from paddle_tpu_torch.fluid.incubate.checkpoint import AutoCheckpoint as TCkpt
from paddle_tpu_torch.health import persist as tpersist
from paddle_tpu_torch.health.transpile import LOSS_SCALE_VAR

PKGS = {"jax": (jfluid, jfault, JCkpt, jpersist),
        "port": (tfluid, tfault, TCkpt, tpersist)}
TOL = 1e-6
HEALTH_FLAGS = ["FLAGS_health_sentinel", "FLAGS_health_action",
                "FLAGS_health_rollback_keep", "FLAGS_health_loss_scaling",
                "FLAGS_health_loss_scale_init",
                "FLAGS_health_scale_growth_steps",
                "FLAGS_rollback_persist_interval_s"]


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@pytest.fixture
def health():
    """arm(**flags): the health sentinel on (rollback by default) in
    both packages; restored after the test."""
    prior = {pkg: PKGS[pkg][0].get_flags(HEALTH_FLAGS) for pkg in PKGS}

    def arm(**kw):
        for pkg in PKGS:
            PKGS[pkg][0].set_flags({"FLAGS_health_sentinel": True,
                                    "FLAGS_health_action": "rollback",
                                    **kw})

    yield arm
    for pkg in PKGS:
        PKGS[pkg][0].set_flags(prior[pkg])
        PKGS[pkg][1].uninstall()


def _build(pkg):
    fluid = PKGS[pkg][0]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.uniform(-1, 1, (4, 1)).astype("float32")
    out = []
    for _ in range(n):
        xb = rng.uniform(-1, 1, (8, 4)).astype("float32")
        out.append({"x": xb, "y": xb @ w})
    return out


_START = {}


def _start(main, startup):
    """The JAX package's startup values (made once), by name."""
    if not _START:
        jmain, jstart, _ = _build("jax")
        scope = jfluid.Scope()
        jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=scope)
        for v in jmain.global_block().vars.values():
            if v.persistable and scope.get(v.name) is not None:
                _START[v.name] = _np(scope.get(v.name)).copy()
    return _START


class _Run:
    """One package's trainer: program, scope, executor, sentinel."""

    def __init__(self, pkg, sentinel=False):
        fluid = PKGS[pkg][0]
        self.pkg = pkg
        self.main, startup, self.loss = _build(pkg)
        self.scope = fluid.Scope()
        self.exe = fluid.Executor(fluid.CPUPlace())
        self.exe.run(startup, scope=self.scope)
        for n, v in _start(self.main, startup).items():
            self.scope.set(n, torch.from_numpy(v.copy()) if pkg == "port"
                           else v.copy())
        self.sent = (self.exe.health_sentinel(self.main) if sentinel
                     else None)
        if sentinel:
            assert self.sent is not None
        self.losses = []

    def ckpt(self, d, **kw):
        kw.setdefault("install_signal_handler", False)
        return PKGS[self.pkg][2](d, self.exe, self.main, scope=self.scope,
                                 **kw)

    def step(self, feed):
        fluid = PKGS[self.pkg][0]
        with fluid.scope_guard(self.scope):
            (lv,) = self.exe.run(self.main, feed=feed,
                                 fetch_list=[self.loss.name],
                                 scope=self.scope)
        self.losses.append(float(np.asarray(lv).reshape(-1)[0]))

    def w(self):
        return _np(self.scope.get("fc_0.w_0")).copy()

    def get(self, name):
        return _np(self.scope.get(name)).copy()


def _both(fn):
    """fn(pkg, tmp subdir) for each package; the two results."""
    return {pkg: fn(pkg) for pkg in PKGS}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# tests/test_auto_checkpoint.py's six
# ---------------------------------------------------------------------------


def test_save_resume_roundtrip(tmp_path):
    batches = _batches(16)

    def go(pkg):
        d = tmp_path / pkg
        r = _Run(pkg)
        ck = r.ckpt(d, save_interval=5, keep_max=2)
        assert ck.resume() == 0
        for step in range(1, 13):
            r.step(batches[step - 1])
            ck.step(step)
        w12 = r.w()
        ck.save(12)
        dirs = sorted(x for x in os.listdir(d) if x.startswith("ckpt_"))
        assert len(dirs) == 2 and dirs[-1].endswith("12")
        r2 = _Run(pkg)
        ck2 = r2.ckpt(d)
        assert ck2.resume() == 13
        np.testing.assert_array_equal(r2.w(), w12)
        for b in batches[12:]:  # resumed steps
            r2.step(b)
        return r.losses, r2.losses, r2.w()

    out = _both(go)
    for a, b in zip(out["port"], out["jax"]):
        _close(a, b)


def test_torn_checkpoint_ignored(tmp_path):
    def go(pkg):
        r = _Run(pkg)
        ck = r.ckpt(tmp_path / pkg)
        ck._last_step = 0
        r.step(_batches(1)[0])
        ck.save(3)
        os.makedirs(tmp_path / pkg / "ckpt_000000000099")  # no meta
        r2 = _Run(pkg)
        assert r2.ckpt(tmp_path / pkg).resume() == 4
        return r2.w()

    out = _both(go)
    _close(out["port"], out["jax"])


def test_sigterm_snapshots(tmp_path):
    """A child trains on the card's entry point asked for the CPU, is
    sent SIGTERM after its third step, and leaves a checkpoint of that
    step, which the JAX package loads (``save_persistables``' layout)
    and resumes from to the port's own weights."""
    script = f'''
import numpy as np
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid.incubate.checkpoint import AutoCheckpoint
rng = np.random.RandomState(0)
xd = rng.uniform(-1, 1, (8, 4)).astype("float32"); yd = xd[:, :1]
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup), fluid.unique_name.guard():
    x = fluid.data("x", [-1, 4], False, dtype="float32")
    y = fluid.data("y", [-1, 1], False, dtype="float32")
    loss = fluid.layers.mean(fluid.layers.square_error_cost(
        fluid.layers.fc(x, size=1), y))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
scope = fluid.Scope()
exe = fluid.Executor(fluid.CPUPlace())
exe.run(startup, scope=scope)
ck = AutoCheckpoint({str(tmp_path / "ck")!r}, exe, main, scope=scope,
                    save_interval=10**9)  # only the signal path saves
step = 0
while True:
    step += 1
    exe.run(main, feed={{"x": xd, "y": yd}}, fetch_list=[loss.name],
            scope=scope)
    ck.step(step)
    if step <= 3:
        w = scope.get("fc_0.w_0").numpy().ravel().tolist()
        print("STEPPED", step, w, flush=True)
    if step == 3:
        import time; time.sleep(60)
'''
    repo = Path(__file__).resolve().parent.parent
    p = subprocess.Popen([sys.executable, "-c", script],
                         stdout=subprocess.PIPE, text=True,
                         env=dict(os.environ, PYTHONPATH=str(repo),
                                  JAX_PLATFORMS="cpu"))
    lines = [p.stdout.readline().split(" ", 2) for _ in range(3)]
    assert [ln[:2] for ln in lines] == [["STEPPED", str(i)]
                                        for i in (1, 2, 3)]
    p.send_signal(signal.SIGTERM)
    assert p.wait(timeout=60) == -signal.SIGTERM  # the default action
    d = tmp_path / "ck" / "ckpt_000000000003"
    meta = json.load(open(d / "checkpoint_meta.json"))
    assert meta["complete"] and meta["step"] == 3
    assert meta["executor_step"] == 1 + 3  # the startup run, steps 1-3
    w3 = np.array(json.loads(lines[2][2]), np.float32).reshape(4, 1)
    main, startup, _ = _build("jax")
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    assert JCkpt(tmp_path / "ck", exe, main, scope=scope,
                 install_signal_handler=False).resume() == 4
    np.testing.assert_array_equal(np.asarray(scope.get("fc_0.w_0")), w3)


def test_crash_mid_save_leftover_tmp_ignored_on_resume(tmp_path):
    def go(pkg):
        d = tmp_path / pkg
        r = _Run(pkg)
        ck = r.ckpt(d)
        ck._last_step = 0
        r.step(_batches(1)[0])
        ck.save(7)
        orphan = d / ".ckpt_tmp_crashed"
        os.makedirs(orphan)
        json.dump({"step": 99, "complete": True},
                  open(orphan / "checkpoint_meta.json", "w"))
        os.makedirs(d / "ckpt_000000000098")
        assert ck.resume() == 8
        ck.save(9)
        assert not orphan.exists()
        return r.w()

    out = _both(go)
    _close(out["port"], out["jax"])


def test_signal_handler_chains_and_uninstalls(tmp_path):
    seen = []

    def prior(signum, frame):
        seen.append(signum)

    old = signal.signal(signal.SIGTERM, prior)
    try:
        r = _Run("port")
        ck = r.ckpt(tmp_path / "ck", save_interval=10 ** 9,
                    install_signal_handler=True)
        ck._last_step = 3
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]  # chained after the snapshot
        assert any(d.startswith("ckpt_")
                   for d in os.listdir(tmp_path / "ck"))
        os.kill(os.getpid(), signal.SIGTERM)  # the hook stays
        assert seen == [signal.SIGTERM, signal.SIGTERM]
        ck.uninstall()
        assert signal.getsignal(signal.SIGTERM) is prior
        ck.uninstall()  # idempotent
    finally:
        signal.signal(signal.SIGTERM, old)


def test_orphan_tmp_dirs_swept(tmp_path):
    r = _Run("port")
    ck = r.ckpt(tmp_path / "ck")
    os.makedirs(tmp_path / "ck" / ".ckpt_tmp_orphan")
    ck.save(1)
    assert not (tmp_path / "ck" / ".ckpt_tmp_orphan").exists()
    # the layout is the JAX package's: it resumes from it
    main, startup, _ = _build("jax")
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    assert JCkpt(tmp_path / "ck", exe, main, scope=scope,
                 install_signal_handler=False).resume() == 2
    _close(np.asarray(scope.get("fc_0.w_0")), r.w())


def test_resume_after_first_run_copies_into_the_scope_tensors(tmp_path):
    """A resume after the program has run leaves every persistable the
    same tensor object (a captured CUDA graph reads that storage) and
    gives it the checkpoint's values; the executor's step counter comes
    back with them, so the next step is the uninterrupted one's."""
    batches = _batches(6)
    ref = _Run("port")
    for b in batches:
        ref.step(b)
    r = _Run("port")
    ck = r.ckpt(tmp_path / "ck")
    for i, b in enumerate(batches[:3]):
        r.step(b)
        ck.step(i)
    ck.save(2)
    for b in batches[3:5]:  # steps the resume takes back
        r.step(b)
    before = {n: r.scope.get(n) for n in ("fc_0.w_0", "fc_0.b_0")}
    assert ck.resume() == 3
    assert r.exe._step == 1 + 3  # the startup run and steps 0-2
    for n, t in before.items():
        assert r.scope.get(n) is t
    for b in batches[3:]:
        r.step(b)
    assert r.losses[-3:] == ref.losses[-3:]
    np.testing.assert_array_equal(r.w(), ref.w())


# ---------------------------------------------------------------------------
# tests/test_health_persist.py's nine
# ---------------------------------------------------------------------------


def _train(pkg, n, ckpt_dir=None, plan=None, per_step=None, **ck_kw):
    """n steps with the sentinel armed (AutoCheckpoint(sentinel=) pumping
    the ring every step when ``ckpt_dir``); the run and its
    AutoCheckpoint."""
    fault = PKGS[pkg][1]
    fault.install(plan) if plan else fault.uninstall()
    r = _Run(pkg, sentinel=True)
    ck = None
    if ckpt_dir is not None:
        ck = r.ckpt(ckpt_dir, save_interval=ck_kw.pop("save_interval",
                                                      10 ** 9),
                    sentinel=r.sent, window_interval_s=1e-6, **ck_kw)
    for i, b in enumerate(_batches(n)):
        if per_step is not None:
            per_step.append(r.w())
        r.step(b)
        if ck is not None:
            ck.step(i)
    if ck is not None:
        ck.flush_window(wait=True)
    fault.uninstall()
    return r, ck


def test_window_save_load_roundtrip_bit_exact(tmp_path, health):
    health(FLAGS_health_rollback_keep=3)

    def go(pkg):
        r, _ = _train(pkg, 5)
        state = r.sent.export_state(r.scope)
        d = str(tmp_path / pkg)
        m = PKGS[pkg][3].save_window(d, state, step=4)
        assert m["format"] == "PTHWIN1" and m["step"] == 4
        assert len(m["entries"]) == 3
        loaded, m2 = PKGS[pkg][3].load_window(d)
        assert m2["step"] == 4
        for live, back in zip(state["window"], loaded["window"]):
            assert sorted(live) == sorted(back)
            for n in live:
                np.testing.assert_array_equal(_np(live[n]), _np(back[n]))
        for k in ("ema", "emvar", "good_samples", "bad_total_seen",
                  "steps_seen"):
            assert loaded[k] == pytest.approx(state[k])
        mp = os.path.join(d, "window_manifest.json")
        doc = json.load(open(mp))
        doc["format"] = "PTHWIN9"
        json.dump(doc, open(mp, "w"))
        assert PKGS[pkg][3].load_window(d) == (None, None)
        assert PKGS[pkg][3].manifest_step(d) is None
        return [_np(v) for snap in loaded["window"]
                for _, v in sorted(snap.items())], loaded["ema"]

    out = _both(go)
    for a, b in zip(out["port"][0], out["jax"][0]):
        _close(a, b)
    assert out["port"][1] == pytest.approx(out["jax"][1], abs=TOL)


def test_torn_payload_reads_as_absent(tmp_path, health):
    health()
    r, _ = _train("port", 4)
    d = str(tmp_path / "ring")
    m = tpersist.save_window(d, r.sent.export_state(r.scope), step=3)
    with open(os.path.join(d, m["payload"]), "wb") as f:
        f.write(b"torn")
    assert tpersist.load_window(d) == (None, None)


def test_kill_between_payload_and_manifest_keeps_old_pair(tmp_path,
                                                          health):
    health(FLAGS_health_rollback_keep=2)
    r, _ = _train("port", 5)
    d = str(tmp_path / "ring")
    m1 = tpersist.save_window(d, r.sent.export_state(r.scope), step=3)
    state1, _ = tpersist.load_window(d)
    with open(os.path.join(d, "window-000000000099.npz"), "wb") as f:
        f.write(b"newer payload, uncommitted")
    state2, m2 = tpersist.load_window(d)
    assert m2["step"] == m1["step"] and m2["payload"] == m1["payload"]
    assert torch.equal(state2["window"][-1]["fc_0.w_0"],
                       state1["window"][-1]["fc_0.w_0"])
    tpersist.save_window(d, r.sent.export_state(r.scope), step=4)
    payloads = {n for n in os.listdir(d) if n.startswith("window-")}
    assert payloads == {tpersist._read_manifest(d)["payload"]}


def test_resume_prefers_newer_window_and_rearms_rollback(tmp_path, health):
    health(FLAGS_health_rollback_keep=3)

    def go(pkg):
        d = str(tmp_path / pkg)
        per_step = []
        _train(pkg, 5, ckpt_dir=d, per_step=per_step)
        r2 = _Run(pkg, sentinel=True)
        ck2 = r2.ckpt(d, save_interval=10 ** 9, sentinel=r2.sent)
        assert ck2.resume() == 4  # the newest entry: pre-step-4
        np.testing.assert_array_equal(r2.w(), per_step[4])
        if pkg == "port":  # the startup run, then steps 0-3
            assert r2.exe._step == 1 + 4
        assert len(r2.sent._window) == 2
        ws = []
        for k in (3, 2):
            assert r2.sent.restore(r2.scope) is True
            np.testing.assert_array_equal(r2.w(), per_step[k])
            ws.append(r2.w())
        assert r2.sent.restore(r2.scope) is False
        return per_step

    out = _both(go)
    for a, b in zip(out["port"], out["jax"]):
        _close(a, b)


def test_loss_scale_state_rearms_bit_exact(tmp_path, health):
    health(FLAGS_health_loss_scaling=True,
           FLAGS_health_loss_scale_init=1024.0,
           FLAGS_health_scale_growth_steps=10 ** 6)

    def go(pkg):
        d = str(tmp_path / pkg)
        r1, _ = _train(pkg, 5, ckpt_dir=d, plan="nan:grad:step:2")
        live = r1.get(LOSS_SCALE_VAR)
        assert float(live[0]) == 512.0
        r2 = _Run(pkg, sentinel=True)
        r2.ckpt(d, save_interval=10 ** 9, sentinel=r2.sent).resume()
        np.testing.assert_array_equal(r2.get(LOSS_SCALE_VAR), live)
        assert r2.sent._good_samples == r1.sent._good_samples
        assert r2.sent._ema == r1.sent._ema
        return r1.losses, r2.sent._ema

    out = _both(go)
    _close(out["port"][0][:2], out["jax"][0][:2])
    assert np.isnan(out["port"][0][2]) == np.isnan(out["jax"][0][2])
    _close(out["port"][0][3:], out["jax"][0][3:])
    assert out["port"][1] == pytest.approx(out["jax"][1], abs=TOL)


def test_window_older_than_checkpoint_rearms_ring_only(tmp_path, health):
    health(FLAGS_health_rollback_keep=2)

    def go(pkg):
        d = str(tmp_path / pkg)
        r = _Run(pkg, sentinel=True)
        ck = r.ckpt(d, save_interval=10 ** 9, sentinel=r.sent)
        for i, b in enumerate(_batches(4)):
            r.step(b)
            ck.step(i)
        ck.flush_window(wait=True)   # ring at step 3
        ck.save(7)                   # a checkpoint stamped ahead
        w = r.w()
        r2 = _Run(pkg, sentinel=True)
        ck2 = r2.ckpt(d, save_interval=10 ** 9, sentinel=r2.sent)
        assert ck2.resume() == 8
        np.testing.assert_array_equal(r2.w(), w)
        assert len(r2.sent._window) == 2
        return w

    out = _both(go)
    _close(out["port"], out["jax"])


def test_persister_offload_is_async_and_latest_wins(tmp_path, health):
    health()
    r, _ = _train("port", 4)
    d = str(tmp_path / "ring")
    p = tpersist.WindowPersister(d, r.sent, interval_s=0.0)
    assert p.due() is False
    try:
        for step in (1, 2, 3):
            p.offload(r.scope, step)
        p.offload(r.scope, 9, wait=True)
        assert tpersist.manifest_step(d) == 9
    finally:
        p.close()


def test_no_sentinel_means_no_persister(tmp_path):
    r = _Run("port")
    ck = r.ckpt(str(tmp_path / "ck"))
    ck.step(1)
    assert ck.flush_window() is False
    assert not os.path.exists(str(tmp_path / "ck" / "health_window"))


def test_skip_action_empty_ring_never_advances_resume(tmp_path, health):
    from paddle_tpu_torch import observability as obs

    health(FLAGS_health_action="skip", FLAGS_health_loss_scaling=True,
           FLAGS_health_loss_scale_init=1024.0,
           FLAGS_health_scale_growth_steps=10 ** 6)

    def restores():
        return obs.snapshot().get("pt_rollback_window_restores_total",
                                  {}).get("samples", {}).get((), 0)

    def go(pkg):
        d = str(tmp_path / pkg)
        r1, _ = _train(pkg, 5, ckpt_dir=d, plan="nan:grad:step:2")
        live = r1.get(LOSS_SCALE_VAR)
        before = restores()
        r2 = _Run(pkg, sentinel=True)
        start = r2.ckpt(d, save_interval=10 ** 9,
                        sentinel=r2.sent).resume()
        assert start == 0
        np.testing.assert_array_equal(r2.get(LOSS_SCALE_VAR), live)
        assert restores() == before
        return r1.w(), r2.w()

    out = _both(go)
    for a, b in zip(out["port"], out["jax"]):
        _close(a, b)


# ---------------------------------------------------------------------------
# convert.py: checkpoint directories carried between the packages
# ---------------------------------------------------------------------------


def _adam_net(pkg):
    fluid = PKGS[pkg][0]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=8, act="tanh")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(h, size=1), y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    startup.random_seed = 4
    return main, startup, loss


@pytest.mark.parametrize("filename", [None, "combined"])
@pytest.mark.parametrize("reference_format", [False, True])
def test_convert_carries_checkpoints_both_ways(tmp_path, reference_format,
                                               filename):
    """A JAX-package checkpoint (save_persistables, after 2 Adam steps)
    loads into the port's scope through ``convert.load_checkpoint``, and
    one step after it equals the JAX package's own next step (loss and
    every persistable within 1e-6); and the reverse:
    ``convert.save_checkpoint`` of the port's scope, loaded by the JAX
    package's ``load_persistables``."""
    from paddle_tpu_torch import convert

    b = _batches(3, seed=7)
    if filename and not reference_format:
        filename = "combined.npz"
    runs = {}
    for pkg in PKGS:
        fluid = PKGS[pkg][0]
        main, startup, loss = _adam_net(pkg)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        runs[pkg] = (fluid, main, startup, loss, scope, exe)
    # the JAX package's start in both, then 2 steps each
    jf, jmain, _, jloss, jscope, jexe = runs["jax"]
    start = {v.name: _np(jscope.get(v.name)).copy()
             for v in jmain.list_vars()
             if v.persistable and jscope.get(v.name) is not None}
    tf, tmain, _, tloss, tscope, texe = runs["port"]
    convert.load_params(tscope, start, tf.CPUPlace())

    def step(pkg, scope, feed):
        fluid, main, _, loss, _, exe = runs[pkg]
        return float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope)[0]).reshape(-1)[0])

    for f in b[:2]:
        step("jax", jscope, f)
        step("port", tscope, f)
    for saver in PKGS:
        d = str(tmp_path / saver)
        if saver == "jax":
            jf.io.save_persistables(jexe, d, jmain, filename=filename,
                                    scope=jscope,
                                    reference_format=reference_format)
            dst = tf.Scope()
            names = convert.load_checkpoint(dst, d, tmain, tf.CPUPlace(),
                                            filename=filename)
            assert len(names) >= 8
            src_loss, dst_loss = step("jax", jscope, b[2]), \
                step("port", dst, b[2])
            pairs = [(jscope.get(n), dst.get(n)) for n in names]
        else:
            convert.save_checkpoint(tscope, d, tmain, filename=filename,
                                    reference_format=reference_format)
            dst = jf.Scope()
            names = jf.io.load_persistables(
                jexe, d, jmain, filename=filename, scope=dst,
                reference_format=reference_format)
            src_loss, dst_loss = step("port", tscope, b[2]), \
                step("jax", dst, b[2])
            pairs = [(tscope.get(n), dst.get(n)) for n in names]
        assert abs(src_loss - dst_loss) <= TOL
        for a, c in pairs:
            _close(_np(a), _np(c))
