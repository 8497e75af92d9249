"""JAX oracle for tests/test_torch_port_promote.py, run in a child
process: the JAX package's ``promotion_drill`` clean and regress over
its tiny 2-replica GPT group, printed as one ``PROMOTE_ORACLE <json>``
line ({mode: {"keys", "report" (without replicas), "replicas",
"replica_ok"}}).

A child because the JAX decode lane runs in a fresh process with the
persistent compile cache off (decode_e2e_checks.py explains the jaxlib
heap-corruption workaround).

    python tests/torch_port_promote_oracle.py
"""

import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]
import cpu_mesh  # noqa: E402,F401  (must precede any jax import)

from paddle_tpu import fluid  # noqa: E402
from paddle_tpu.serving import drill  # noqa: E402


def main():
    fluid.set_flags({"FLAGS_compile_cache_dir": ""})
    out = {}
    for mode in ("clean", "regress"):
        rep = drill.promotion_drill(regress=mode == "regress")
        out[mode] = {
            "keys": sorted(rep),
            "report": {k: v for k, v in rep.items() if k != "replicas"},
            "replicas": [r["replica"] for r in rep["replicas"]],
            "replica_ok": [r["ok"] for r in rep["replicas"]]}
    print("PROMOTE_ORACLE " + json.dumps(out, default=str), flush=True)


if __name__ == "__main__":
    main()
