"""The PyTorch port's constant tables and import hygiene.

The port copies the JAX package's NumPy-only modules instead of importing
them (importing anything under fpga_mpeg2_encoder_tpu imports jax); these
tests hold every copied table, and the tables written into the CUDA sources,
to the reference, and check that the port imports without jax.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from fpga_mpeg2_encoder_tpu.core import _vlc_data as ref_data
from fpga_mpeg2_encoder_tpu.core import tables as ref_tables
from fpga_mpeg2_encoder_tpu.ops import entropy as ref_entropy
from fpga_mpeg2_encoder_tpu_torch.core import _vlc_data as port_data
from fpga_mpeg2_encoder_tpu_torch.core import tables as port_tables
from fpga_mpeg2_encoder_tpu_torch.ops import entropy as port_entropy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "fpga_mpeg2_encoder_tpu_torch", "csrc")


def _public_arrays(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and isinstance(v, (np.ndarray, list, int))}


@pytest.mark.parametrize("ref,port", [(ref_tables, port_tables),
                                      (ref_data, port_data)],
                         ids=["tables", "vlc_data"])
def test_copied_tables_equal_reference(ref, port):
    want, got = _public_arrays(ref), _public_arrays(port)
    assert sorted(want) == sorted(got)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_entropy_tables_equal_reference():
    assert np.array_equal(port_entropy.AC_TABLE, ref_entropy._AC_TABLE)
    for k in ("_MV_TAB", "_CBP_TAB", "_DCY_TAB", "_DCUV_TAB"):
        assert np.array_equal(getattr(port_entropy, k), getattr(ref_entropy, k)), k
    assert port_entropy.SLOTS_PER_MB == ref_entropy.SLOTS_PER_MB
    assert port_entropy.SLOT_LEN_SHIFT == ref_entropy.SLOT_LEN_SHIFT
    for nbx, nby in ((4, 4), (26, 4), (120, 72)):
        assert port_entropy.slice_words_bound(nbx) == ref_entropy.slice_words_bound(nbx)
        assert (port_entropy.frame_words_bound(nbx, nby)
                == ref_entropy.frame_words_bound(nbx, nby))


def _c_array(path, name):
    src = open(os.path.join(CSRC, path)).read()
    m = re.search(name + r"\[\d+\]\s*=\s*\{([^}]*)\}", src)
    assert m, name
    return np.array([int(x) for x in m.group(1).replace("\n", " ").split(",")
                     if x.strip()], np.int64)


@pytest.mark.parametrize("path,name,want", [
    ("transform.cu", "c_dctm", ref_tables.DCTM.reshape(-1)),
    ("transform.cu", "c_intra_q", ref_tables.INTRA_Q.reshape(-1)),
    ("transform.cu", "c_zigzag", ref_tables.ZIGZAG.reshape(-1)),
    ("acsym.cu", "c_ac_table", ref_entropy._AC_TABLE),
])
def test_kernel_source_tables_equal_reference(path, name, want):
    """The CUDA kernels carry their tables as constant-memory literals; they
    must be the reference's tables entry for entry."""
    assert np.array_equal(_c_array(path, name), np.asarray(want, np.int64))


def test_port_imports_without_jax():
    """Every module of the port (entry.py and the tools included) imports
    without jax or the JAX package, so it runs on a machine without them."""
    code = (
        "import pkgutil, sys\n"
        "import fpga_mpeg2_encoder_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    __import__(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fpga_mpeg2_encoder_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    names = {os.path.relpath(os.path.join(d, f), ROOT)
             for d, _, fs in os.walk(os.path.join(ROOT, "fpga_mpeg2_encoder_tpu_torch"))
             for f in fs if f.endswith(".py")}
    assert int(r.stdout.split()[-1]) == len(names) - 1      # all but the top __init__
    assert "fpga_mpeg2_encoder_tpu_torch/entry.py" in names
    assert "fpga_mpeg2_encoder_tpu_torch/tools/bench_configs.py" in names


def test_encoder_refuses_missing_cuda():
    """device='cuda' never falls back to the CPU."""
    from fpga_mpeg2_encoder_tpu_torch import Encoder
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        Encoder(device="meta")
