"""Captured CUDA graphs: the port's counterpart of the JAX package's jax.jit.

A step is a function of no arguments that reads its inputs from tensors it
closes over and writes what it carries into tensors it owns.  ``Step`` runs
it once eagerly (the warm-up: it builds the kernels, uploads the VLC tables
and allocates pack_slots' look-back buffer, none of which a capture may
do), then captures it on a side stream into a CUDA graph with a memory pool
of its own.  Each call then replays the graph: one launch from the host for
the whole step, whatever the number of kernels in it.

A replay overwrites what the previous replay left in the graph's tensors and
in the step's own: callers copy out what they keep before the next call.
Replays go to the caller's current stream, one after another.

The kernels' launches are counted into a tally while the graph is captured
(``ops/kernels/_build.tally_into``); each replay adds the tally to
``_build.LAUNCHES``.  The warm-up's launches are not counted.  The
capture is the span ``capture.<kind>`` (``utils/profiling``) and counts one
``graph_captures``; a replay is the span ``replay.<kind>``, one host launch
that the program calling it counts with its own.  The kind names the
program: its cache key's first element.

A step may also be a list of functions that share no tensor: the branches
of one graph (parallel/dp.py's batch, one branch a channel).  Each branch
runs on a stream of its own, forked from the side stream by one event and
joined back to it before the capture ends, so a replay runs the branches
concurrently on the card.  The warm-up forks and joins the same way, so each
branch's pack_slots call allocates its look-back buffer on its own stream
(ops/kernels/pack.py keys the buffers by device and stream): branches that
shared one would race.  What each function returns stays referenced until
the join and after it (the step's ``outputs``), and the allocator hands a
block freed on one stream only to that stream, so no branch's temporaries
reuse another's memory in the graph's pool.

On the CPU there is nothing to capture: each call runs the step eagerly, a
list's functions one after another.
A capture that fails raises; nothing falls back to the eager step on a card.
An operation that waits for the device inside the step (``bool()``,
``.item()``, an upload from pageable memory, a mask with a data-dependent
size) makes the capture fail.
"""
from __future__ import annotations

import gc
from collections import OrderedDict
from typing import Callable, Dict, Hashable, List, Sequence, Union

import torch

from ..ops.kernels import _build
from ..utils.profiling import count, span

MAX_PROGRAMS = 16        # programs kept per process; the least recently used goes

_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_branches: Dict[torch.device, List["torch.cuda.Stream"]] = {}
_programs: "OrderedDict[Hashable, object]" = OrderedDict()


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream every warm-up and capture on ``device`` runs on.  Its
    pack_slots look-back buffer is sized by the warm-ups: one that needs
    more tiles than any before it gets a larger buffer, and the graphs
    captured with the old one keep replaying with it, since pack.py never
    frees a look-back buffer."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _branch_streams(device: torch.device, n: int) -> List["torch.cuda.Stream"]:
    """Streams for the n branches of a graph on ``device``, kept for the
    process like the side stream (a graph's look-back buffers are keyed by
    them).  torch hands out the streams of its pool in turn, so these differ
    from each other and from the side stream up to the pool's size (32 a
    device); past it branch b takes stream b modulo what there is, and
    branches that share a stream run one after another, as captured."""
    have = _branches.setdefault(device, [])
    seen = {_side_stream(device).cuda_stream} | {s.cuda_stream for s in have}
    for _ in range(64):
        if len(have) >= n:
            break
        stream = torch.cuda.Stream(device)
        if stream.cuda_stream not in seen:
            have.append(stream)
            seen.add(stream.cuda_stream)
    return [have[b % len(have)] for b in range(n)]


class Step:
    """``fn`` on ``device``: replayed from a CUDA graph captured after one
    eager warm-up, or, on the CPU, called as it is.  ``fn`` may be a list
    of functions, the branches of one graph (see the module's docstring).
    ``launches`` is the capture's tally of kernel launches, added to
    ``_build.LAUNCHES`` at each replay; ``outputs`` is what ``fn`` returned
    when it was captured (the graph's tensors, rewritten by each replay),
    for a list the list of what each returned.  ``kind`` names the spans
    of the capture and the replays; ``launches_a_call`` is what a call
    enqueues from the host: 1 (the replay) on a card, 0 on the CPU."""

    def __init__(self, fn: Union[Callable[[], object], Sequence[Callable[[], object]]],
                 device, kind: str = "step"):
        self.device = torch.device(device)
        self._fn = fn
        self._branches = None
        self._capture_span, self._replay_span = f"capture.{kind}", f"replay.{kind}"
        self._graph = None
        self.launches: Dict[str, int] = {}
        self.outputs = None
        self.launches_a_call = 0
        if self.device.type == "cuda":
            if not callable(fn):
                self._branches = _branch_streams(self.device, len(fn))
            self._capture()
            self.launches_a_call = 1

    def _run(self, stream: "torch.cuda.Stream"):
        """The step on ``stream``, the current stream: ``fn()``, or each
        branch on its own stream, forked from ``stream`` by one event and
        joined back to it, its outputs held past the join."""
        if self._branches is None:
            return self._fn()
        fork, outputs = stream.record_event(), []
        for fn, branch in zip(self._fn, self._branches):
            branch.wait_event(fork)
            with torch.cuda.stream(branch):
                outputs.append(fn())
        for branch in self._branches:
            stream.wait_stream(branch)
        return outputs

    def _capture(self) -> None:
        count("graph_captures")
        with span(self._capture_span), torch.cuda.device(self.device):
            stream = _side_stream(self.device)
            current = torch.cuda.current_stream(self.device)
            stream.wait_stream(current)
            try:
                with torch.cuda.stream(stream), _build.tally_into({}):
                    self._run(stream)
                graph, tally = torch.cuda.CUDAGraph(), {}
                # No collection during the capture: a graph that the
                # collector frees (a program dropped in a reference cycle)
                # resets, and a reset's frees invalidate a capture.  The
                # garbage there is goes first: torch.cuda.graph collects
                # only under torch.compiler.config.force_cudagraph_gc, off
                # by default (torch 2.11, torch/cuda/graphs.py,
                # graph.__enter__).
                gc.collect()
                collecting = gc.isenabled()
                gc.disable()
                try:
                    # thread_local: what this thread does is checked as
                    # strictly, but another thread (NCCL's watchdog querying
                    # its events) does not invalidate the capture
                    with _build.tally_into(tally):
                        with torch.cuda.graph(graph, stream=stream,
                                              capture_error_mode="thread_local"):
                            outputs = self._run(stream)
                finally:
                    if collecting:
                        gc.enable()
            finally:
                # a failed capture can leave the side stream current
                torch.cuda.set_stream(current)
            current.wait_stream(stream)
        self._graph, self.launches, self.outputs = graph, tally, outputs

    def __call__(self):
        if self._graph is None:
            self.outputs = self._fn() if callable(self._fn) else [fn() for fn in self._fn]
        else:
            with span(self._replay_span):
                self._graph.replay()
            _build.add_launches(self.launches)
        return self.outputs


def cached(key: Hashable, make: Callable[[], object]):
    """The program cached under ``key``, made by ``make()`` at first use.
    At most MAX_PROGRAMS are kept; the least recently used is dropped (its
    graph's memory is freed once no tensor of it is held)."""
    prog = _programs.get(key)
    if prog is None:
        prog = make()
        _programs[key] = prog
        while len(_programs) > MAX_PROGRAMS:
            _programs.popitem(last=False)
    else:
        _programs.move_to_end(key)
    return prog


def clear() -> None:
    """Drop every cached program."""
    _programs.clear()
