"""One torch thread a test process, imported first by every
``tests/test_torch_*.py`` file.

pytest runs the suite in several processes at once (``-n 6`` on 8
cores), and the port's CPU runs are many small ops: with torch's
default of one intra-op thread a core, each process's threads and the
JAX runtime's contend for the same cores, and a BERT-tiny step runs
several times slower than on one thread.  ``OMP_NUM_THREADS`` is set
too, so a child process a test starts runs one thread as well.
"""

import os

import torch

os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)
