"""JAX oracle for tests/test_torch_port_nmt.py, run in a child process.

Builds Transformer NMT at ``TransformerConfig.tiny(dropout=0.0)`` in
the JAX package, under ``unique_name.guard``, runs the startup
program, and writes to one npz file, by ``route``:

- ``flash`` or ``composed``: the program with Adam(1e-4), trained on one
  padded ragged batch (``batch()``: source pads and ``label_weight``
  zeros past each sentence's length) on the CPU with the graph passes
  of the route (``flash``: the default passes, which rewrite the
  self-attentions to ``flash_attention``; ``composed``:
  FLAGS_graph_passes "none", the composed attention with its pad bias
  and ``softmax_mask_fuse_upper_triangle``):

    init:<name>      every parameter after the startup program
    feed:<name>      the batch
    loss             STEPS per-step losses in fp32
    final:<name>     every parameter after those steps
    bf16_loss        BF16_STEPS per-step losses under the bf16 dtype
                     policy, from the same initial parameters

- ``decode``: build_greedy_decode(decode_config(), MAX_OUT_LEN):

    init:<name>      its parameters after its own startup program
    feed:src_ids     the batch's sources
    greedy           its ids over them

    python tests/torch_port_nmt_oracle.py OUT.npz {flash|composed|decode}
"""

import os
import sys

import numpy as np

STEPS, BF16_STEPS = 10, 5
LR = 1e-4
BATCH, SRC_LEN = 4, 12
# each sentence's length: the pads past it carry the -1e9 key bias and
# a zero label weight
LENGTHS = (12, 7, 9, 3)
MAX_OUT_LEN = 4
# the greedy decode's init std: at tiny()'s 0.02 every source decodes to
# the same ids, so the check would not see the encoder or the pad bias
DECODE_INIT_STD = 1.0


def config(t, dropout=0.0):
    """TransformerConfig.tiny of the models module ``t`` (either
    package's)."""
    return t.TransformerConfig.tiny(dropout=dropout)


def decode_config(t):
    return t.TransformerConfig.tiny(dropout=0.0,
                                    init_std=DECODE_INIT_STD)


def batch(t, cfg):
    """make_fake_batch padded as bench.py's ragged_batch pads it: the
    source's tail past each length is pad id 0, and label_weight is 1
    on a sentence's first length - 1 targets only."""
    data = t.make_fake_batch(cfg, batch=BATCH, src_len=SRC_LEN,
                             trg_len=SRC_LEN - 1, seed=int(LENGTHS[0]))
    w = np.zeros_like(data["label_weight"])
    for i, ln in enumerate(LENGTHS):
        data["src_ids"][i, ln:] = 0
        w[i, :ln - 1] = 1.0
    data["label_weight"] = w
    return data


def build(fl, t, cfg):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        _, cost, _ = t.build_transformer_nmt(cfg)
        fl.optimizer.Adam(learning_rate=LR).minimize(cost)
    return main, startup, cost


def build_decode(fl, t, cfg):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        _, out = t.build_greedy_decode(cfg, max_out_len=MAX_OUT_LEN)
    return main, startup, out


def train(fl, t, cfg, feed, state, params, steps, bf16):
    """``steps`` steps from ``state`` (every variable the startup
    program made, so no startup run is compiled again); returns the
    losses and ``params`` after them."""
    from paddle_tpu.fluid.contrib.mixed_precision import enable_bf16_policy

    main, _, cost = build(fl, t, cfg)
    if bf16:
        enable_bf16_policy(main)
    scope = fl.Scope()
    for n, a in state.items():
        scope.set(n, np.array(a))
    exe = fl.Executor(fl.CPUPlace())
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[cost],
                                       scope=scope)[0]).reshape(()))
              for _ in range(steps)]
    return np.asarray(losses, np.float32), {
        n: np.asarray(scope.get(n), np.float32) for n in params}


def main(out_path, route):
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import cpu_mesh  # noqa: F401  (must precede any jax-using import)

    os.environ.setdefault("FLAGS_compile_cache_dir", "")
    sys.path.insert(0, os.path.dirname(here))
    from paddle_tpu import fluid as fl
    from paddle_tpu.models import transformer as t

    fl.set_flags({"FLAGS_graph_passes": "none" if route == "composed"
                  else "default"})
    feed = batch(t, config(t))
    if route == "decode":
        dec, dstart, out = build_decode(fl, t, decode_config(t))
        scope = fl.Scope()
        exe = fl.Executor(fl.CPUPlace())
        exe.run(dstart, scope=scope)
        res = {f"init:{p.name}": np.asarray(scope.get(p.name), np.float32)
               for p in dec.all_parameters()}
        res["feed:src_ids"] = feed["src_ids"]
        res["greedy"] = np.asarray(exe.run(
            dec, feed={"src_ids": feed["src_ids"]}, fetch_list=[out],
            scope=scope)[0])
        np.savez(out_path, **res)
        print("TORCH_PORT_NMT_ORACLE_OK")
        return
    cfg = config(t)
    main_prog, startup, _ = build(fl, t, cfg)
    scope = fl.Scope()
    fl.Executor(fl.CPUPlace()).run(startup, scope=scope)
    state = {n: np.asarray(scope.get(n)) for op in startup.global_block().ops
             for n in op.output_arg_names}
    params = [p.name for p in main_prog.all_parameters()]
    res = {f"init:{n}": state[n].astype(np.float32) for n in params}
    res.update({f"feed:{k}": v for k, v in feed.items()})
    res["loss"], final = train(fl, t, cfg, feed, state, params, STEPS,
                               bf16=False)
    res.update({f"final:{n}": a for n, a in final.items()})
    res["bf16_loss"], _ = train(fl, t, cfg, feed, state, params, BF16_STEPS,
                                bf16=True)
    np.savez(out_path, **res)
    print("TORCH_PORT_NMT_ORACLE_OK")


if __name__ == "__main__":
    main(*sys.argv[1:3])
