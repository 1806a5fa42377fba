"""Debug-mode invariant check of the encoder's reconstruction chain.

The reference's only read/write hazard is intentional: motion estimation must
see the PREVIOUS frame's reconstruction, guaranteed in hardware by the
one-slice write-delay memory (RTL/mpeg2encoder.v:2364-2424).  Here the
invariant holds by construction - the frame step takes the previous recon as
an explicit input - but a debug run can still prove it: re-encode every
checked frame from a checkpoint and require identical bytes and recon.

Usage:
    report = verify_recon_chain(config, seq, frames444, device="cuda")   # raises on violation
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import EncoderConfig, SequenceConfig
from ..models.encoder import Encoder


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def verify_recon_chain(
    config: EncoderConfig,
    seq: SequenceConfig,
    frames444: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    recheck_every: int = 1,
    device="cuda",
) -> dict:
    """Encode a sequence twice on ``device`` - streaming, and frame by frame
    re-launched from checkpoints - and require the payload bytes and the
    reconstruction state to agree at every checkpointed frame.  Any hidden
    state or stale-reference read (the analog of the RTL's mem_delay ordering
    hazard) would diverge here."""
    ref = Encoder(config, device=device)
    ref.start_sequence(seq)
    chk = Encoder(config, device=device)
    chk.start_sequence(seq)
    checked = 0
    for i, f in enumerate(frames444):
        ref.push_frame(*f)
        if i % recheck_every == 0:
            fresh = Encoder(config, device=device)
            fresh.set_state(chk.get_state())
            fresh.push_frame(*f)
            chk.push_frame(*f)
            a, b = fresh.get_state(), chk.get_state()
            _require(a.payload == b.payload, f"payload divergence at frame {i}")
            _require(all((x == y).all() for x, y in zip(
                (a.recon_y, a.recon_u, a.recon_v), (b.recon_y, b.recon_u, b.recon_v))),
                f"recon divergence at frame {i}")
            _require(ref.get_state().payload == b.payload,
                     f"streaming divergence at frame {i}")
            checked += 1
        else:
            chk.push_frame(*f)
    _require(ref.finish() == chk.finish(), "the finished streams differ")
    return {"frames": len(frames444), "checkpoints_verified": checked}
