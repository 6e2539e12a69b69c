"""In-memory communication backend — the hermetic test fake the reference
never had (SURVEY §4: "no mock comm backend exists; we should invert this").

A process-global registry keyed by run_id holds one queue per rank; threads
playing server/clients exchange Message objects through it with the exact
`BaseCommunicationManager` semantics of the WAN backends, so the full
cross-silo FSM (reference ``mpi/com_manager.py`` daemon-thread + queue
pattern) is exercised in a single pytest process.

Port of the JAX module: the same code, but the byte count of a traced
send comes from the port's ``obs.tree_nbytes`` (``obs/jaxhooks.py`` in
the JAX package, which needs jax).  Messages pass by reference: a tensor
sent here reaches the receiver on the device it was sent from.
"""

from __future__ import annotations

import queue
import threading
from collections import defaultdict
from typing import Dict, List

from .....obs import context as obs_context
from .....obs import get_tracer
from ..base_com_manager import BaseCommunicationManager, Observer
from ..message import Message

_REGISTRY: Dict[str, Dict[int, "queue.Queue[Message]"]] = defaultdict(dict)
_REGISTRY_LOCK = threading.Lock()


def reset_run(run_id: str):
    with _REGISTRY_LOCK:
        _REGISTRY.pop(str(run_id), None)


class LocalCommManager(BaseCommunicationManager):
    def __init__(self, run_id: str, rank: int, size: int):
        self.run_id = str(run_id)
        self.rank = int(rank)
        self.size = int(size)
        self._observers: List[Observer] = []
        self._running = False
        with _REGISTRY_LOCK:
            self._q = _REGISTRY[self.run_id].setdefault(self.rank, queue.Queue())

    def send_message(self, msg: Message):
        receiver = msg.get_receiver_id()
        tracer = get_tracer()
        tier = obs_context.comm_tier(msg.get_sender_id(), receiver)
        # in-memory transport never serializes; price the payload from the
        # array leaves so the per-tier byte counters stay comparable with
        # the wire backends (only computed when tracing is on)
        nbytes = None
        if tracer.enabled:
            from .....obs import tree_nbytes
            nbytes = tree_nbytes(list(msg.get_params().values()))
        span = tracer.span("comm.send", cat="comm", backend="local",
                           dst=receiver, tier=tier, nbytes=nbytes,
                           msg_type=str(msg.get_type()),
                           msg_id=msg.get(obs_context.KEY_MSG_ID),
                           round=msg.get("round_idx"))
        with span:
            obs_context.inject(msg.get_params(), tracer)
            with _REGISTRY_LOCK:
                q = _REGISTRY[self.run_id].setdefault(receiver,
                                                      queue.Queue())
            q.put(msg)
        if nbytes:
            tracer.add_bytes(f"comm.bytes.{tier}", nbytes)
        if span.duration_s is not None:
            tracer.counter(f"comm.rtt.{tier}", span.duration_s)

    def add_observer(self, observer: Observer):
        self._observers.append(observer)

    def remove_observer(self, observer: Observer):
        if observer in self._observers:
            self._observers.remove(observer)

    def handle_receive_message(self):
        self._running = True
        # announce readiness to self (reference comm managers emit
        # CONNECTION_IS_READY on startup)
        ready = Message(Message.MSG_TYPE_CONNECTION_IS_READY, self.rank, self.rank)
        self._dispatch(ready)
        while self._running:
            try:
                msg = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if msg is None:
                break
            self._dispatch(msg)

    def _dispatch(self, msg: Message):
        for obs in list(self._observers):
            obs.receive_message(msg.get_type(), msg)

    def stop_receive_message(self):
        self._running = False
        self._q.put(None)
