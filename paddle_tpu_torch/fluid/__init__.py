"""paddle_tpu_torch.fluid — the Fluid front end on PyTorch.

The same programming model as ``paddle_tpu.fluid``: build a Program with
``fluid.layers.*`` and run it with ``fluid.Executor(place)``.  The
executor runs each op's lowering on a torch device: on the card it
captures each fixed-shape program once as a CUDA graph and replays it,
on the CPU (or with FLAGS_cuda_graph_capture off) it runs them
eagerly;
``Executor()`` with no place runs on CUDAPlace(0).  ``append_backward``
and ``optimizer.Adam(...).minimize(loss)`` build a training program
(with ``regularizer`` and ``clip``);
``CompiledProgram(...).with_data_parallel(...)`` runs it over several
replicas (parallel/data_parallel.py).
"""

# ops must register before any program is built or run
import paddle_tpu_torch.ops  # noqa: F401

from . import framework  # noqa: F401
from .framework import (  # noqa: F401
    CPUPlace, CUDAPlace, Program, TPUPlace, Variable,
    default_main_program, default_startup_program, program_guard,
    unique_name,
)
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from . import flags, initializer, layers  # noqa: F401
from . import (average, backward, clip, compiler, contrib,  # noqa: F401
               evaluator, io, ir, metrics, nets, optimizer, regularizer)
from . import aot_cache, incubate, proto_compat  # noqa: F401
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .backward import append_backward, gradients  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
from .layers.io import data  # noqa: F401
