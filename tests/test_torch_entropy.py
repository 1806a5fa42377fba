"""The port's symbolisation (ops/entropy.py, with ac_slot_grid as the plain
version of the acsym kernel) against the JAX package's symbolize_frame on
both its XLA path and its Pallas acsym kernel in interpret mode.  Slot grids
are compared masked by length: a zero-length slot may carry a dead code.  The
port's grid is int32 holding the uint32 pattern; it is compared read as
uint32, on grids that hold slots of length >= 16 (negative as int32)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from fpga_mpeg2_encoder_tpu.ops import entropy as jentropy
from fpga_mpeg2_encoder_tpu.ops.pallas import acsym as k_acsym
from fpga_mpeg2_encoder_tpu_torch.ops import entropy
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import acsym as port_kernel


@pytest.fixture
def acsym_impl():
    saved = (k_acsym._INTERPRET, jentropy._ACSYM_IMPL)
    k_acsym._INTERPRET = True
    yield
    k_acsym._INTERPRET, jentropy._ACSYM_IMPL = saved


def _symbols(nby, nbx, seed):
    rng = np.random.default_rng(seed)
    zig = np.zeros((nby, nbx, 6, 64), np.int32)
    mask = rng.random(zig.shape) < 0.15
    zig[mask] = rng.integers(-60, 61, mask.sum())
    zig[0, 0, 0, 5] = 2047                     # escape-coded levels
    zig[-1, -1, 3, 63] = -2047
    zig[0, 1, 2, 0] = 0                        # inter DC of zero: counts as run
    inter = rng.random((nby, nbx)) < 0.6
    mvx = rng.integers(-12, 13, (nby, nbx)).astype(np.int32)
    mvy = rng.integers(-12, 13, (nby, nbx)).astype(np.int32)
    return zig, inter, mvx, mvy


def _masked(slots):
    """uint32 slots -> int64, zero where the length is zero."""
    slots = np.asarray(slots)
    assert slots.dtype == np.uint32
    slots = slots.astype(np.int64)
    return np.where((slots >> 27) > 0, slots, 0)


def _port_grid(grid: torch.Tensor) -> np.ndarray:
    """The port's int32 slot grid read as the uint32 it holds."""
    assert grid.dtype == torch.int32
    return grid.numpy().view(np.uint32)


@pytest.mark.parametrize("nbx", [4, 26])
@pytest.mark.parametrize("i_frame,frame_no", [(0, 0), (3, 1500)])
def test_symbolize_matches_jax(acsym_impl, nbx, i_frame, frame_no):
    """nbx 26 (416 px) is where the JAX kernel's routing barrel once
    corrupted slots; frame 1500 exercises a non-trivial timecode."""
    zig, inter, mvx, mvy = _symbols(3, nbx, nbx + i_frame)
    got = entropy.symbolize_frame(torch.from_numpy(zig), torch.from_numpy(inter),
                                  torch.from_numpy(mvx), torch.from_numpy(mvy),
                                  i_frame, frame_no, 2)
    got = _port_grid(got)
    assert ((got >> 27) >= 16).any() and (got >= 1 << 31).any()
    for impl in ("xla", "pallas"):
        jentropy._ACSYM_IMPL = impl
        # a fresh function per implementation: jit must not reuse a trace
        # made under the other _ACSYM_IMPL
        want = jax.jit(lambda *a: jentropy.symbolize_frame(*a, 2).slots)(
            jnp.asarray(zig), jnp.asarray(inter), jnp.asarray(mvx), jnp.asarray(mvy),
            jnp.int32(i_frame), jnp.int32(frame_no))
        assert got.shape == want.shape
        assert np.array_equal(_masked(got), _masked(want)), impl


@pytest.mark.parametrize("i_frame,first_row,include_headers", [(0, 0, True), (3, 0, True),
                                                                 (3, 5, False)])
def test_symbolize_rows_are_the_grid_apart(i_frame, first_row, include_headers):
    """symbolize_rows gives symbolize_frame's grid in two tensors: the two
    header rows (none without include_headers) and the slice rows."""
    args = [torch.from_numpy(a) for a in _symbols(3, 5, 7 + i_frame)]
    kw = dict(first_row=first_row, include_headers=include_headers)
    hdr, rows = entropy.symbolize_rows(*args, i_frame, 1500, 2, **kw)
    grid = entropy.symbolize_frame(*args, i_frame, 1500, 2, **kw)
    assert (hdr is None) is not include_headers
    parts = [rows] if hdr is None else [hdr, rows]
    assert [tuple(p.shape) for p in parts] == [(2, grid.shape[1])] * (hdr is not None) \
        + [(3, grid.shape[1])]
    assert torch.equal(torch.cat(parts), grid)


def test_ac_slot_grid_zero_slots_and_wrapper_on_cpu():
    """The plain acsym writes zero at every zero coefficient's AC slot, keeps
    the non-AC slots of `small` as they are, and the wrapper runs it on CPU
    tensors without a launch."""
    zig, inter, mvx, mvy = _symbols(2, 5, 1)
    zmod, small = entropy.ac_inputs(torch.from_numpy(zig), torch.from_numpy(inter),
                                    torch.from_numpy(mvx), torch.from_numpy(mvy), 1, 2)
    before = dict(_build.LAUNCHES)
    out = port_kernel.ac_slot_grid(zmod, small)
    assert _build.LAUNCHES == before
    assert torch.equal(out, entropy.ac_slot_grid(zmod, small))
    ac = out[:, 3:].reshape(2, 5, 394)[:, :, 4:].reshape(2, 5, 6, 65)[..., 1:64]
    assert torch.equal(ac == 0, torch.from_numpy(zig[..., 1:] == 0))
    non_ac = torch.ones_like(out, dtype=torch.bool)
    non_ac[:, 3:].view(2, 5, 394)[:, :, 4:].view(2, 5, 6, 65)[..., 1:64] = False
    assert torch.equal(out[non_ac], small[non_ac])


@pytest.mark.parametrize("i_frame", [0, 1])
def test_ac_slot_grid_int32_matches_jax_kernel(acsym_impl, i_frame):
    """The plain acsym on its own operands against the JAX package's Pallas
    acsym kernel (interpret mode) on the same operands as uint32: escapes
    (length 24) and B.14 codes of length >= 16 must not sign-extend."""
    zig, inter, mvx, mvy = _symbols(2, 4, 20 + i_frame)
    zig[1, 2, 5, 1:] = np.arange(1, 64)              # long codes, then escapes
    zmod, small = entropy.ac_inputs(torch.from_numpy(zig), torch.from_numpy(inter),
                                    torch.from_numpy(mvx), torch.from_numpy(mvy), i_frame, 2)
    assert zmod.dtype == small.dtype == torch.int32
    got = _port_grid(entropy.ac_slot_grid(zmod, small))
    want = np.asarray(k_acsym.ac_slot_grid_pallas(jnp.asarray(zmod.numpy()),
                                                  jnp.asarray(small.numpy().view(np.uint32))))
    assert ((got >> 27) >= 16).any()
    assert np.array_equal(_masked(got), _masked(want))
