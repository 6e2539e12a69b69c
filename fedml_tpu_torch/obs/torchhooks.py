"""Process-wide hub of the port's runtime events (the counterpart of
``fedml_tpu.obs.jaxhooks``).

The JAX package observes XLA compiles through jax's monitoring listener
and explicit transfers by wrapping ``jax.device_put``/``device_get``.  The
port has neither: its "compiles" are the round-function builds and the
CUDA-graph captures of a fused block, and its explicit host↔device copies
happen at a few points of its own (``FedAvgAPI._to_device``,
``_block_to_device`` and the module's ``_host``).  Those points call
:func:`note_build`, :func:`note_capture`, :func:`note_put` and
:func:`note_get`, which fan the event out to the subscribers: the tracer
(:func:`install_tracer_hooks`, installed by ``obs.configure``) and
``analysis.runtime.TorchRuntimeAudit``.  With no subscriber each call is
one list check.  A hook reads only host metadata (byte counts, host
clocks): it never adds a transfer, a sync or a capture.
"""

from __future__ import annotations

import threading
from typing import Callable, List

from .tracer import tree_nbytes

#: the event kinds a subscriber ``fn(kind, value, name)`` receives
BUILD = "build"          # a round function built (value 0)
CAPTURE = "capture"      # a CUDA graph captured (value: host seconds)
PUT = "device_put"       # an explicit host→device copy (value: bytes)
GET = "device_get"       # an explicit device→host copy (value: bytes)

_subscribers: List[Callable] = []
_lock = threading.Lock()


def subscribe(fn: Callable[[str, float, str], None]) -> None:
    with _lock:
        if fn not in _subscribers:
            _subscribers.append(fn)


def unsubscribe(fn: Callable) -> None:
    with _lock:
        if fn in _subscribers:
            _subscribers.remove(fn)


def _emit(kind: str, value: float, name: str) -> None:
    for fn in list(_subscribers):
        try:
            fn(kind, value, name)
        except Exception:   # a broken subscriber must not break a round
            pass


def note_build(name: str) -> None:
    """A round function (round, block, bucket or async program) built."""
    if _subscribers:
        _emit(BUILD, 0.0, name)


def note_capture(seconds: float, name: str = "block_round") -> None:
    """A CUDA graph captured, ``seconds`` of host time (warm-up
    included)."""
    if _subscribers:
        _emit(CAPTURE, float(seconds), name)


def note_put(arrays) -> None:
    """One explicit host→device copy of ``arrays`` (any nesting)."""
    if _subscribers:
        _emit(PUT, float(tree_nbytes(arrays)), "")


def note_get(arrays) -> None:
    """One explicit device→host copy of ``arrays``."""
    if _subscribers:
        _emit(GET, float(tree_nbytes(arrays)), "")


def install_tracer_hooks(tracer) -> Callable[[], None]:
    """Subscribe ``tracer``: each capture becomes a retroactive
    ``cuda_graph_capture`` event (``cat="compile"``, the lane the JAX
    tracer gives ``xla_compile``) and each copy a ``device_put_bytes`` /
    ``device_get_bytes`` byte counter.  Returns the uninstall callable."""
    def on_event(kind: str, value: float, name: str):
        if kind == CAPTURE:
            tracer.complete("cuda_graph_capture", value, cat="compile",
                            fn=name)
        elif kind == PUT:
            tracer.add_bytes("device_put_bytes", int(value))
        elif kind == GET:
            tracer.add_bytes("device_get_bytes", int(value))

    subscribe(on_event)
    return lambda: unsubscribe(on_event)
