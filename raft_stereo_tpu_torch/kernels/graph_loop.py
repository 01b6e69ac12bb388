"""The early-exit loop's predicate and the one-graph WHILE loop
(``csrc/graph_loop.cu``).

The JAX model's convergence-gated loop (``nn.while_loop``) goes on while
``it < min_iters or (it < limit and delta >= threshold)``, where delta is
the worst batch member's mean |delta disparity| of the last iteration
(fp32) and starts at infinity.  ``exit_continues`` is that predicate on
the host: the plain version, which the eager loop uses.
``exit_predicate`` is the kernel: it counts the iteration in a device
``it`` and sets a CUDA graph WHILE node's condition, so a replay runs the
loop with no host synchronisation.  For CPU tensors it runs the plain
version and returns the decision.

``WhileGraph`` joins three graphs that PyTorch captured with
``keep_graph=True`` (prologue, one iteration ending in ``exit_predicate``,
epilogue) into one: prologue -> WHILE(iteration) -> epilogue, each as a
child-graph node.  The iteration is captured by PyTorch, not by
``cudaStreamBeginCaptureToGraph`` into the body, so that its allocations
come from the runner's graph pool as every other capture's do.
"""

from __future__ import annotations

import ctypes

import torch

from raft_stereo_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)


def f32(x: float) -> float:
    """``x`` rounded to fp32: the threshold the JAX loop compares with."""
    return float(torch.tensor(x, dtype=torch.float32))


def exit_continues(it: int, delta: float, min_iters: int, limit: int,
                   threshold: float) -> bool:
    """Plain version of the predicate: whether iteration ``it + 1`` runs,
    ``delta`` being iteration ``it``'s fp32 value and ``threshold`` fp32
    (``f32``); NaN compares false."""
    return it < min_iters or (it < limit and delta >= threshold)


def exit_predicate(handle: int, it: torch.Tensor, delta: torch.Tensor,
                   min_iters: int, limit: int, threshold: float):
    """``it += 1``, then the loop's condition from ``it``, ``delta`` and
    the bounds: on CUDA tensors the kernel, which sets the WHILE node
    ``handle``'s condition (it runs inside that node's body), counted in
    ``exit_predicate.launches``; on CPU tensors the plain version, which
    returns the decision.  ``it`` is a 0-d int32 tensor, ``delta`` 0-d
    fp32."""
    if it.dtype != torch.int32 or delta.dtype != torch.float32 or it.dim() \
            or delta.dim() or it.device != delta.device:
        raise ValueError("exit_predicate takes a 0-d int32 count and a 0-d "
                         "fp32 delta on one device")
    if it.device.type == "cpu":
        it += 1
        return exit_continues(int(it), float(delta), min_iters, limit,
                              threshold)
    fn = _build.entry("graph_loop", "raft_exit_predicate",
                      (ctypes.c_ulonglong, _P, _P, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, _P))
    _build.check(fn(handle, it.data_ptr(), delta.data_ptr(), min_iters,
                    limit, threshold,
                    torch.cuda.current_stream(it.device).cuda_stream),
                 "exit_predicate")
    exit_predicate.launches += 1
    return None


exit_predicate.launches = 0


def _call(symbol: str, argtypes, *args) -> None:
    _build.check(_build.entry("graph_loop", symbol, argtypes)(*args),
                 f"graph_loop.{symbol}")


class WhileGraph:
    """One executable graph: prologue -> WHILE(body) -> epilogue.

    Create it before capturing the body, whose last launch must be
    ``exit_predicate(graph.handle, ...)``; then ``build`` from the three
    PyTorch graphs (captured with ``keep_graph=True``, never replayed
    themselves: they keep their memory pool's blocks alive, and ``build``
    holds them until ``close``), ``launch`` on a stream, ``close`` once."""

    def __init__(self):
        _call("raft_graph_prepare", ())
        self._graph, self._exec = _P(), _P()
        _call("raft_graph_create", (_PP,), ctypes.byref(self._graph))
        h = ctypes.c_ulonglong()
        _call("raft_graph_while_handle", (_P, ctypes.POINTER(
            ctypes.c_ulonglong)), self._graph, ctypes.byref(h))
        self.handle = h.value

    def _child(self, graph, deps, child: torch.cuda.CUDAGraph):
        node = _P()
        arr = (_P * max(len(deps), 1))(*deps)
        _call("raft_graph_add_child", (_P, _PP, ctypes.c_int, _P, _PP),
              graph, ctypes.cast(arr, _PP), len(deps),
              _P(child.raw_cuda_graph()), ctypes.byref(node))
        return node

    def build(self, prologue: torch.cuda.CUDAGraph,
              body: torch.cuda.CUDAGraph,
              epilogue: torch.cuda.CUDAGraph) -> None:
        first = self._child(self._graph, [], prologue)
        node, inner = _P(), _P()
        arr = (_P * 1)(first)
        _call("raft_graph_add_while",
              (_P, _PP, ctypes.c_int, ctypes.c_ulonglong, _PP, _PP),
              self._graph, ctypes.cast(arr, _PP), 1, self.handle,
              ctypes.byref(node), ctypes.byref(inner))
        self._child(inner, [], body)
        self._child(self._graph, [node], epilogue)
        _call("raft_graph_instantiate", (_P, _PP), self._graph,
              ctypes.byref(self._exec))
        # the child nodes are copies, but what they read and write are the
        # torch graphs' allocations, which live as long as those graphs
        self._parts = (prologue, body, epilogue)

    def launch(self, stream: torch.cuda.Stream) -> None:
        _call("raft_graph_launch", (_P, _P), self._exec,
              _P(stream.cuda_stream))

    def close(self) -> None:
        if self._graph:
            _call("raft_graph_destroy", (_P, _P), self._graph, self._exec)
            self._graph, self._exec = _P(), _P()
            self._parts = ()

    def __del__(self):
        if getattr(self, "_graph", None):
            try:
                self.close()
            except Exception:   # no raise under garbage collection, at exit
                pass
