"""JAX oracle for tests/test_torch_port_gpt.py, run in a child process.

Builds GPT-tiny causal-LM training (2 layers, dropout 0) in the JAX
package, under ``unique_name.guard``, with one of two attention builds
(``flash``: flash_attention in the program; ``unfused``: the composed
matmul / softmax_mask_fuse_upper_triangle / matmul chain that the
default passes rewrite) and one of two optimizers (``adam``:
Adam(1e-4); ``adamw_clip``: AdamW(1e-4, beta2 0.95, weight decay 0.1)
with GradientClipByGlobalNorm(CLIP_NORM)), runs the startup program,
then trains on one fixed batch on the CPU, and writes to one npz file:

  ops           the training program's op list after the graph passes
                (JSON: type, input and output slots, attrs)
  init:<name>   every parameter after the startup program
  feed:<name>   the batch (make_fake_lm_batch(cfg, BATCH, SEQ, seed=0))
  loss          STEPS per-step losses in fp32
  gnorm         the clip's global norm at each of those steps
                (adamw_clip only)
  final:<name>  every parameter after those steps
  bf16_loss     BF16_STEPS per-step losses of the same program under the
                bf16 dtype policy, from the same initial parameters
  bf16_final:<name>  every parameter after those steps

    python tests/torch_port_gpt_oracle.py OUT.npz {flash|unfused} \
        {adam|adamw_clip}
"""

import json
import os
import sys

import numpy as np

STEPS, BF16_STEPS = 10, 5
BATCH, SEQ = 4, 32
LR = 1e-4
# below GPT-tiny's global gradient norm on this batch, so the clip
# scales every step's gradients
CLIP_NORM = 0.5


def config(g, build):
    """GPT-tiny of the models package ``g`` (either package's)."""
    return g.GPTConfig.tiny(num_layers=2, hidden_dropout=0.0,
                            use_flash_attention=build == "flash")


def optimizer(fl, opt):
    """The optimizer of ``opt`` from the fluid package ``fl`` (either
    package: the test builds the port's with the same call)."""
    if opt == "adam":
        return fl.optimizer.Adam(learning_rate=LR)
    return fl.optimizer.AdamW(
        learning_rate=LR, beta2=0.95, weight_decay=0.1,
        grad_clip=fl.clip.GradientClipByGlobalNorm(CLIP_NORM))


def build(fl, g, build_name, opt):
    cfg = config(g, build_name)
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        _, loss = g.build_gpt_lm(cfg)
        optimizer(fl, opt).minimize(loss)
    return cfg, main, startup, loss


def global_norm_name(program):
    """The clip's global norm: the output of its ``sqrt`` op."""
    (name,) = [op.outputs["Out"][0] for op in program.global_block().ops
               if op.type == "sqrt"]
    return name


def op_list(program):
    def attr(v):
        if isinstance(v, (np.generic,)):
            return v.item()
        if isinstance(v, tuple):
            return list(v)
        return v

    return json.dumps([
        [op.type, op.inputs, op.outputs,
         {k: attr(v) for k, v in sorted(op.attrs.items())}]
        for op in program.global_block().ops], default=str)


def train(fl, g, build_name, opt, feed, params, steps, bf16):
    from paddle_tpu.fluid.contrib.mixed_precision import enable_bf16_policy

    _, main, startup, loss = build(fl, g, build_name, opt)
    if bf16:
        enable_bf16_policy(main)
    scope = fl.Scope()
    exe = fl.Executor(fl.CPUPlace())
    exe.run(startup, scope=scope)
    for n, a in params.items():
        scope.set(n, np.array(a))
    fetch = [loss] + ([global_norm_name(main)] if opt != "adam" else [])
    losses, norms = [], []
    for _ in range(steps):
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(())))
        norms += [float(np.asarray(v).reshape(())) for v in out[1:]]
    return main, np.asarray(losses, np.float32), np.asarray(
        norms, np.float32), {n: np.asarray(scope.get(n), np.float32)
                             for n in params}


def main(out_path, build_name, opt):
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import cpu_mesh  # noqa: F401  (must precede any jax-using import)

    os.environ.setdefault("FLAGS_compile_cache_dir", "")
    sys.path.insert(0, os.path.dirname(here))
    from paddle_tpu import fluid as fl
    from paddle_tpu.models import gpt as g

    cfg, main_prog, startup, _ = build(fl, g, build_name, opt)
    scope = fl.Scope()
    fl.Executor(fl.CPUPlace()).run(startup, scope=scope)
    names = [p.name for p in main_prog.all_parameters()]
    init = {n: np.asarray(scope.get(n), np.float32) for n in names}
    feed = g.make_fake_lm_batch(cfg, BATCH, SEQ, seed=0)

    res = {f"init:{n}": a for n, a in init.items()}
    res.update({f"feed:{k}": v for k, v in feed.items()})
    ran, losses, norms, final = train(fl, g, build_name, opt, feed, init,
                                      STEPS, bf16=False)
    res["ops"] = np.asarray(op_list(ran))
    res["loss"], res["gnorm"] = losses, norms
    res.update({f"final:{n}": a for n, a in final.items()})
    _, losses, _, final = train(fl, g, build_name, opt, feed, init,
                                BF16_STEPS, bf16=True)
    res["bf16_loss"] = losses
    res.update({f"bf16_final:{n}": a for n, a in final.items()})
    np.savez(out_path, **res)
    print("TORCH_PORT_GPT_ORACLE_OK")


if __name__ == "__main__":
    main(*sys.argv[1:4])
