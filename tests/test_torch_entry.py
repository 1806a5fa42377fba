"""The port's entry points (fpga_mpeg2_encoder_tpu_torch/entry.py) against
the JAX package's __graft_entry__: ``entry`` gives the same example inputs
and, on the CPU, the same outputs; ``dryrun_multichip`` runs on 4 spawned
gloo ranks (the stream mesh, the sharded SAD volume, the slice-sharded frame
encoder and the 2 x 2 stream x slice encoder, each checked on every rank);
both refuse to run on a missing card."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from fpga_mpeg2_encoder_tpu_torch import entry as E

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_equals_jax_graft_entry():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    jfn, jargs = ge.entry()
    fn, args = E.entry(device="cpu")
    assert len(args) == len(jargs) == 8
    for a, b in zip(args[:6], jargs[:6]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert args[6:] == tuple(int(x) for x in jargs[6:])
    got = fn(*args)
    want = jax.jit(jfn)(*jargs)
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    nbits = int(want[4])
    assert int(got[4]) == nbits and not bool(got[5]) and not bool(want[5])
    nw = (nbits + 31) // 32
    assert np.array_equal(got[3][:nw].numpy(), np.asarray(want[3])[:nw].astype(np.int64))


def test_dryrun_multichip_on_four_gloo_ranks():
    E.dryrun_ranks(4, device="cpu", timeout=240.0)


def test_dryrun_needs_its_process_group():
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        E.dryrun_multichip(2, device="cpu")


def test_entry_points_refuse_missing_cuda():
    """device='cuda' never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        E.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        E.dryrun_ranks(1)
