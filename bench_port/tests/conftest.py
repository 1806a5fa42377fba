"""CPU tests of the benchmark's harness: ``python -m pytest bench_port/tests -q``
from the checkout's root.  The harness's directory and the checkout's root
go on the import path, as bench_port/run.py puts them."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(1, os.path.dirname(os.path.dirname(HERE)))

import torch  # noqa: E402

torch.set_num_threads(2)
