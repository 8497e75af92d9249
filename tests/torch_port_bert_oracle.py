"""JAX oracle for tests/test_torch_port_bert.py, run in a child process.

Builds BERT-tiny pretraining with flash attention (attention and hidden
dropout 0) and Adam(1e-4) in the JAX package, under
``unique_name.guard``, runs the startup program, then trains on one
fixed batch on the CPU, and writes to one npz file:

  ops           the training program's op list after the graph passes
                (JSON: type, input and output slots, attrs)
  init:<name>   every parameter after the startup program
  feed:<name>   the batch (make_fake_batch(cfg, 4, 32, seed=0))
  loss          20 per-step losses in fp32
  final:<name>  every parameter after those 20 steps
  bf16_loss     5 per-step losses of the same program under the bf16
                dtype policy, from the same initial parameters
  bf16_final:<name>  every parameter after those 5 steps

A child process, as tests/torch_port_jax_oracle.py is: it keeps the JAX
runtime out of the pytest process's allocator history.

    python tests/torch_port_bert_oracle.py OUT.npz
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import cpu_mesh  # noqa: F401,E402  (must precede any jax-using import)

os.environ.setdefault("FLAGS_compile_cache_dir", "")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from paddle_tpu import fluid  # noqa: E402
from paddle_tpu.fluid.contrib.mixed_precision import (  # noqa: E402
    enable_bf16_policy)
from paddle_tpu.models import bert  # noqa: E402

STEPS, BF16_STEPS = 20, 5
BATCH, SEQ = 4, 32


def config():
    return bert.BertConfig.tiny(use_flash_attention=True, attn_dropout=0.0,
                                hidden_dropout=0.0)


def build():
    cfg = config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return cfg, main, startup, loss


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


def train(main, loss, feed, params, steps):
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    _, _, startup, _ = build()  # accumulators: a fresh startup run
    exe.run(startup, scope=scope)
    for n, a in params.items():
        scope.set(n, np.array(a))
    losses = []
    for _ in range(steps):
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(lv).reshape(())))
    return np.asarray(losses, np.float32), {
        n: np.asarray(scope.get(n), np.float32) for n in params}


def main(out_path):
    cfg, main_prog, startup, loss = build()
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    names = [p.name for p in main_prog.all_parameters()]
    init = {n: np.asarray(scope.get(n), np.float32) for n in names}
    feed = bert.make_fake_batch(cfg, BATCH, SEQ, seed=0)

    res = {f"init:{n}": a for n, a in init.items()}
    res.update({f"feed:{k}": v for k, v in feed.items()})
    losses, final = train(main_prog, loss, feed, init, STEPS)
    res["ops"] = np.asarray(op_list(main_prog))
    res["loss"] = losses
    res.update({f"final:{n}": a for n, a in final.items()})

    _, bf_prog, _, bf_loss = build()
    enable_bf16_policy(bf_prog)
    losses, final = train(bf_prog, bf_loss, feed, init, BF16_STEPS)
    res["bf16_loss"] = losses
    res.update({f"bf16_final:{n}": a for n, a in final.items()})
    np.savez(out_path, **res)
    print("TORCH_PORT_BERT_ORACLE_OK")


if __name__ == "__main__":
    main(sys.argv[1])
