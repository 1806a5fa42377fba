"""The check of the check: a whole run of each cell, driven here at 64x64
on the CPU past run.py's look for a card, is correct with the port, and
not correct with the control (the reference at the next coarser quantiser
in the port's place) or with a fault planted in the port: a step that
returns its state unchanged, an answer altered where it is produced.  The
cells run on one stream and one chip, so they can have no batch left half
out and no exchange between chips left out."""
import pytest
import torch

import harness
import programs
from fpga_mpeg2_encoder_tpu_torch.models.encoder import bound_caps

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
SMALL = dict(zip(("width", "height"), (64, 64)),
             **dict(zip(("row_cap", "frame_cap"), bound_caps(64, 64))))


def run(cell, program):
    # three units: a chunk or a frame whose prediction crosses a unit's
    # boundary is then among those that can be drawn
    return harness.run_cell(cell, 2 ** 31 + 3, 0.0, False, "cpu", program, 0.0,
                            overrides=SMALL, log=lambda msg: None, min_units=3)


@pytest.mark.parametrize("cell", CELLS)
def test_port_is_correct(cell):
    res = run(cell, programs.port())
    assert res["correct"], res["checks"]
    assert res["window"]["frames_checked"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = run(cell, programs.control())
    assert not res["correct"]
    assert res["checks"]["mismatches"]["value"] > 0
    assert res["window"]["frames_differing"] == res["window"]["frames_checked"]


@pytest.mark.parametrize("fault", ["stale_state", "altered_answer"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    res = run(cell, programs.fault(fault))
    assert not res["correct"], res["checks"]
