"""Tracing for the port: spans and counters where the host does the work,
on torch.profiler's clock, and the Chrome-trace exporter.

Tracing is on while a ``torch.profiler`` records (``trace_to`` below, or any
profiler a caller starts); there is no other switch.

* ``span(name, arg)`` is a context manager.  While a profiler records it is
  ``torch.profiler.record_function(name, arg)``: its start, end and parent
  (by nesting) land in the profiler's trace beside the kernels, and its
  host seconds and calls go into the tally under ``name``.  Otherwise it is
  one shared null context, after a single check of the profiler's state:
  on the per-frame path a span costs that check and two empty calls.
* ``count(name, n)`` adds ``n`` to the process totals ``COUNTS`` and, while
  a profiler records, to the tally.
* ``traced()`` is the tally since the last ``reset()``; once the profiler
  stops, nothing more goes into it.

Neither a span nor a counter reads the device, and neither may go inside a
function that a CUDA graph captures: it would run at the capture only.

The spans (``arg``: the sequence number of the call's first frame):

* ``push_chunk`` (``Encoder.push_chunk``), its children ``.stack`` and
  ``.upload``, ``.program`` (``encode_gop_scan``, an overflow retry
  included), ``.sync`` (the overflow flag, the bit count, the frames' bits
  and types, the GOP state), ``.download`` (the payload, its conversion to
  bytes included) and ``.carry`` (the recon clones, the stats).  On a card
  ``.stack`` is a frame's host copy into a page-locked slot, once a frame,
  and ``.upload``, twice a frame, the wait for that slot (where its last
  copy to the device has not ended) before it, and the enqueue of the
  slot's copy to the device after it; on the CPU ``.stack`` is the planes'
  ``np.stack`` and ``.upload`` their conversion to tensors, once a chunk;
* ``push_frame``, with ``.upload``, ``.program``, ``.sync``, ``.download``
  and ``.carry`` defined the same way;
* ``gop.start``, ``gop.feed`` (a frame's replay) and
  ``gop.result`` (``encode_gop_scan``'s program), ``frame.feed``
  (``encode_frame_device``'s); the batch program's ``gop.start`` (every
  stream's carry set) and ``gop.feed`` (one replay: a frame of every
  stream);
* ``replay.<kind>`` and ``capture.<kind>`` (``runtime/graphs.Step``; the
  kind is the program cache key's first element: ``gop``, ``gop_batch``,
  ``frame``, ``shard_local``, ``shard_tail``);
* ``batch.gop`` (``parallel/dp.encode_gops_batched``, the whole call), its
  children: with the batch program ``gop.start``, a ``gop.feed`` a
  frame-step, ``batch.collect`` (the result's operations: the streams'
  overflow flags) and ``batch.sync`` (the blocking reads of the GOP state
  and the frames' types); with a ``program`` given, ``batch.stream`` (a
  stream's call of it; ``arg``: the stream's index) and ``batch.collect``
  (the copies of that stream's outputs into the batch's stacks; ``arg`` the
  same) a stream, then ``batch.sync``; ``batch.stream`` and
  ``batch.collect`` also in ``encode_frames_batched``.

The counters: ``host_syncs`` (each blocking device read of ``push_chunk``,
``push_frame`` and ``encode_gops_batched``), ``host_launches`` (each
host-side enqueue of the gop, batch and frame programs: copies, uploads and
fills into their tensors, the result's ops, the graph's replay; and each
copy of a stream's outputs into the batch's stacks), ``batch_streams``
(each stream that a batch call encodes), ``overflow_retries`` (each
re-encode at ``models/encoder.bound_caps``: an ``Encoder``'s frame or chunk,
or a ``BatchEncoder``'s whole batch), ``graph_captures``,
``staged_frames`` (each frame ``push_chunk`` copies up through a page-locked
slot), ``staging_waits`` (each time the host waits for a slot's copy to
the device to end before writing the slot again), ``frames_in_place``
(each frame the gop or batch program's step reads from the caller's stacks
where they lie) and ``stack_copies`` (each plane of a chunk's stacks that the gop
program copies first, since its step cannot read it in place).

The benchmark's per-layer metrics read the tally (``bench_port/metrics``);
the command line's ``--stats`` prints ``COUNTS``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

COUNTS: Dict[str, int] = {}          # process totals, whether or not a profiler records
_spans: Dict[str, Tuple[int, float]] = {}     # the tally
_counts: Dict[str, int] = {}


class _NullSpan:
    """The span while no profiler records: a null context with no state
    (shared by every caller; cheaper to enter than contextlib's)."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL = _NullSpan()


class _Span:
    """record_function(name, arg) that adds its host seconds to the tally."""

    __slots__ = ("_name", "_record", "_t0")

    def __init__(self, name: str, arg) -> None:
        self._name = name
        self._record = torch.profiler.record_function(name, None if arg is None else str(arg))

    def __enter__(self) -> None:
        self._record.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        self._record.__exit__(*exc)
        if _autograd_profiler._is_profiler_enabled:
            calls, seconds = _spans.get(self._name, (0, 0.0))
            _spans[self._name] = (calls + 1, seconds + dt)


def span(name: str, arg: Optional[int] = None):
    """A span ``name`` around the enclosed host work (see the module's
    docstring); the shared null context while no profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, arg)


def count(name: str, n: int = 1) -> None:
    """``n`` more events ``name``: into ``COUNTS``, and into the tally while
    a profiler records."""
    COUNTS[name] = COUNTS.get(name, 0) + n
    if _autograd_profiler._is_profiler_enabled:
        _counts[name] = _counts.get(name, 0) + n


def traced() -> Tuple[Dict[str, Tuple[int, float]], Dict[str, int]]:
    """What was recorded while a profiler recorded, since the last
    ``reset()``: ({span: (calls, host seconds)}, {counter: n})."""
    return dict(_spans), dict(_counts)


def reset() -> None:
    """Clear the tally (not ``COUNTS``)."""
    _spans.clear()
    _counts.clear()


@contextlib.contextmanager
def trace_to(path: str):
    """Context manager: trace the enclosed work with torch.profiler (the
    CUDA activity too when torch sees a card) and write it to ``path`` as a
    Chrome trace, viewable in Perfetto; the spans above are in it as
    ``user_annotation`` events.  Yields the profiler, whose
    ``key_averages()`` sum the time by kernel and span."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
