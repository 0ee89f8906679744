"""CUDA graphs of the port's training steps and forwards: the counterpart
of the single dispatch that ``jax.jit`` gives every JAX step and forward,
and of ``lax.scan`` over K steps (``Trainer(scan_steps=K)``,
adnm_tpu/train/loop.py:94-102).

A ``GraphSet`` holds the graphs of one owner (a ``Trainer``, or the caller
of ``cli.predict.forecast`` for a model it serves, which passes it to every
call): one memory pool that all its graphs share,
a side stream for warm-ups, one capture stream, and the graphs by key.
``GraphSet.run(key, fn, inputs, ...)``:

* The first call of a key runs ``warmup()`` (by default ``fn(*inputs)``)
  eagerly on the side stream, and its result is the call's: the warm-up is
  real work (a Trainer's K eager steps, or the served forward), it makes
  what a capture cannot (optimizer state, cuBLAS workspaces, cached
  constants) and it launches the hand kernels that their counters count.
  Then ``fn`` is captured over static copies of ``inputs``; the capture
  launches nothing. The kernels' wrappers count their launches in Python
  (``ops/rms_norm.py``, ``ops/ssd.py``), so each counter gains during the
  capture what one run of ``fn`` launches: the counters are set back, and
  those gains are kept as the graph's launches. The capture's seconds and
  the device memory it reserved for the pool are printed.
* Every later call copies ``inputs`` into the static buffers, replays the
  graph, adds its launches to the counters and returns copies of the static
  outputs, so that a result outlives the next replay.

A graph reads the tensors it was captured with at their addresses. The
caller's ``binding()`` lists the state it reads (parameters, buffers,
optimizer state), once, at the capture; a call that finds one of them
moved to another address (``.to()``, a ``.data`` assignment) drops the
graph and captures anew, so a replay never reads a moved tensor. An owner
that replaces such tensors by new ones (``Trainer.load``: the optimizer's
``load_state_dict``) clears its graphs. Graphs that
share a pool may reuse each other's intermediate memory: a graph's result
is valid until the next replay of any graph of the set, which is why
``run`` returns copies.

Random draws: a capture cannot seed a generator on the host, and one seed
per replay would not do for K steps with a mask each. The caller registers
generator states (``torch.Generator.clone_state``) with ``states``, sets
them in the captured function (``graphsafe_set_state``) and seeds each one
on the host before a replay (``manual_seed``): the replay then reads the
seed and starts at offset 0, as an eager draw after ``manual_seed`` does.

A capture or a replay that fails raises; nothing falls back to eager.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Hashable, Optional, Sequence

import torch

from adnm_tpu_torch.ops import rms_norm as _k1
from adnm_tpu_torch.ops import ssd as _k2

# The wrappers whose ``launches`` count their kernels' launches.
COUNTED = (_k1.rms_norm, _k1.rms_norm_backward, _k1.gated_rms_norm,
           _k1.gated_rms_norm_backward, _k2.ssd_chunked_scan, _k2.ssd_chunked_scan_backward)


def launch_counts() -> tuple:
    return tuple(f.launches for f in COUNTED)


@dataclasses.dataclass
class CapturedGraph:
    graph: torch.cuda.CUDAGraph
    inputs: tuple  # static input buffers
    outputs: tuple  # static outputs
    single: bool  # ``fn`` returned one tensor, not a tuple
    launches: tuple  # each counter's launches per replay (``COUNTED``' order)
    bound: tuple  # the state the graph reads in place
    addresses: tuple  # their addresses at the capture
    capture_s: float
    pool_bytes: int  # device memory the capture reserved

    def current(self) -> bool:
        """Whether every tensor the graph reads is where it was captured."""
        return self.addresses == tuple(t.data_ptr() for t in self.bound)

    def replay(self, inputs: Sequence[torch.Tensor]):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        for f, n in zip(COUNTED, self.launches):
            f.launches += n
        outs = tuple(o.clone() for o in self.outputs)
        return outs[0] if self.single else outs


class GraphSet:
    """The CUDA graphs of one owner on ``device``, over one memory pool."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.graphs: dict = {}
        self._pool = None
        self._streams = None

    def clear(self) -> None:
        """Drop every graph (their pool's memory goes when the last one does)."""
        self.graphs.clear()
        self._pool = None

    def streams(self):
        """(side stream of the warm-ups, capture stream), made once: cuBLAS
        keeps a workspace for every stream it runs on."""
        if self._streams is None:
            self._streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device))
        return self._streams

    def run(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor],
            warmup: Optional[Callable] = None, binding: Callable[[], list] = list,
            states: Sequence[torch.Generator] = (), label: str = ""):
        """``fn(*inputs)``: the graph of ``key`` replayed, or, at the first
        call (or when a tensor of ``binding()`` has moved), ``warmup()`` run
        eagerly and ``fn`` captured. ``states`` are the generator states
        ``fn`` sets."""
        captured = self.graphs.get(key)
        if captured is not None and captured.current():
            return captured.replay(inputs)
        self.graphs.pop(key, None)
        side, _ = self.streams()
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            result = warmup() if warmup is not None else fn(*inputs)
        current.wait_stream(side)
        self.graphs[key] = self._capture(fn, inputs, binding(), states, label or str(key))
        return result

    def _capture(self, fn, inputs, bound, states, label) -> CapturedGraph:
        _, stream = self.streams()
        static = tuple(x.clone() for x in inputs)
        graph = torch.cuda.CUDAGraph()
        for state in states:
            graph.register_generator_state(state)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                outputs = fn(*static)
        finally:
            during = launch_counts()
            for f, n in zip(COUNTED, before):  # the capture launched nothing
                f.launches = n
        seconds = time.perf_counter() - t0
        single = isinstance(outputs, torch.Tensor)
        outputs = (outputs,) if single else tuple(outputs)
        launches = tuple(b - a for a, b in zip(before, during))
        pool = torch.cuda.memory_reserved(self.device) - reserved
        kernels = {f.__name__: n for f, n in zip(COUNTED, launches) if n}
        print(f"graph {label}: captured in {seconds:.3f} s, pool {pool / 2**20:.1f} MiB, "
              f"hand-kernel launches a replay {kernels}")
        bound = tuple(bound)
        return CapturedGraph(graph, static, outputs, single, launches, bound,
                             tuple(t.data_ptr() for t in bound), seconds, pool)
