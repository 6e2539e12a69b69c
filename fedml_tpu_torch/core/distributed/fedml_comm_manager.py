"""FedMLCommManager — the actor-style message-loop runtime (reference
``python/fedml/core/distributed/fedml_comm_manager.py:11``).

Surface parity: ``register_message_receive_handler(msg_type, fn)`` (ref
``:63``), ``send_message``, ``run()``, ``finish()``; backend selection in
``_init_manager`` (ref ``:131``) now covers the TPU-era backend set:
``local`` (in-memory, tests), ``GRPC`` (cross-host), ``filestore``
(broker-less WAN), ``MQTT_S3`` (broker, requires paho-mqtt).  The ICI data
plane never goes through this layer — only WAN federation does (SURVEY §5).

Port of the JAX module.  What differs: the raw backends are ``local``,
``filestore`` and ``MQTT_S3`` (paho when installed, else the in-repo
``mini_mqtt``); ``GRPC`` (needs ``grpcio``), ``TRPC`` and the storage-split
backends (``MQTT_WEB3``, ``MQTT_THETA``, ``MQTT_S3_MNN``, ``CASTORE``) raise
``NotImplementedError`` by name, and an unknown name ``ValueError`` as
before.  The filestore's default root is under the system temporary
directory (``tempfile``) rather than a fixed ``/tmp`` path, and a traced
receive prices its payload with the port's ``obs.tree_nbytes``.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Callable, Dict

from ...obs import context as obs_context
from ...obs import get_tracer, tree_nbytes
from .communication.base_com_manager import BaseCommunicationManager, Observer
from .communication.message import Message

log = logging.getLogger(__name__)

#: message-params key every round-scoped protocol uses for its round index
#: (cross_silo ``MyMessage.MSG_ARG_KEY_ROUND_IDX`` and the hierarchy
#: driver agree on it) — the recv span tags rounds with it so merged
#: timelines group cross-process work per round
MSG_KEY_ROUND_IDX = "round_idx"


def _norm_msg_key(msg_type):
    """FSM msg types are ints; the Flow DSL keys messages by flow-name
    strings (reference ``fedml_flow.py:199`` sends ``Message(flow_name, ...)``)."""
    try:
        return int(msg_type)
    except (TypeError, ValueError):
        return str(msg_type)


class FedMLCommManager(Observer):
    def __init__(self, args, comm=None, rank: int = 0, size: int = 0,
                 backend: str = "local"):
        self.args = args
        self.size = int(size)
        self.rank = int(rank)
        self.backend = backend
        self.comm = comm
        self.com_manager: BaseCommunicationManager = None
        self.message_handler_dict: Dict[int, Callable] = {}
        self._init_manager()

    def register_comm_manager(self, comm_manager: BaseCommunicationManager):
        self.com_manager = comm_manager

    def run(self):
        self.register_message_receive_handlers()
        self.com_manager.handle_receive_message()
        log.debug("rank %d comm loop done", self.rank)

    def get_sender_id(self) -> int:
        return self.rank

    def receive_message(self, msg_type, msg_params) -> None:
        handler = self.message_handler_dict.get(_norm_msg_key(msg_type))
        if handler is None:
            if _norm_msg_key(msg_type) != Message.MSG_TYPE_CONNECTION_IS_READY:
                log.warning("rank %d: no handler for msg_type %s",
                            self.rank, msg_type)
            return
        tracer = get_tracer()
        if not tracer.enabled:
            handler(msg_params)
            return
        # fedscope (docs/OBSERVABILITY.md): the receiver half of the
        # cross-process span link — the sender's comm.send span id rides
        # the message (obs.context.inject) and lands here as parent_span,
        # which `fedtrace critical-path` walks across process boundaries
        ctx = obs_context.extract(msg_params)
        try:
            src = msg_params.get_sender_id()
            dst = msg_params.get_receiver_id()
        except (KeyError, TypeError, ValueError):
            src = dst = None
        tier = obs_context.comm_tier(src, dst)
        kw = {"backend": self.backend, "src": src, "tier": tier,
              "msg_type": str(msg_type),
              "msg_id": msg_params.get(obs_context.KEY_MSG_ID),
              "round": msg_params.get(MSG_KEY_ROUND_IDX)}
        if ctx is not None:
            kw.update(parent_span=ctx["span_id"],
                      remote_trace=ctx["trace_id"],
                      remote_host=ctx["host"], remote_pid=ctx["pid"])
        with tracer.span("comm.recv", cat="comm", **kw):
            handler(msg_params)
        tracer.add_bytes(f"comm.bytes_recv.{tier}",
                         tree_nbytes(list(msg_params.get_params().values())))

    def send_message(self, message: Message):
        tracer = get_tracer()
        if tracer.enabled and \
                obs_context.KEY_MSG_ID not in message.get_params():
            # stamped ABOVE the backend (and above chaos fault injection)
            # so duplicated deliveries of one logical send share the id —
            # fedproto check-trace's duplicate/loss matching key
            message.add_params(obs_context.KEY_MSG_ID,
                               obs_context.new_span_id())
        self.com_manager.send_message(message)

    def register_message_receive_handler(self, msg_type,
                                         handler_callback_func: Callable):
        self.message_handler_dict[_norm_msg_key(msg_type)] = handler_callback_func

    def register_message_receive_handlers(self):
        """Subclasses register their FSM handlers here."""

    def finish(self):
        log.debug("rank %d finishing comm", self.rank)
        self.com_manager.stop_receive_message()

    # -- backend selection (reference _init_manager :131) ------------------
    def _init_manager(self):
        self.com_manager = create_comm_backend(
            self.args, self.rank, self.size, self.backend)
        self.com_manager.add_observer(self)


def create_comm_backend(args, rank: int, size: int,
                        backend: str = "local") -> BaseCommunicationManager:
    """Construct a bare communication backend (no observer attached) — used
    by the FSM above and by the scheduler plane's message centers.
    ``chaos_*`` args decorate the result with seeded fault injection
    (``communication/fault_injection.py``); ``reliable_delivery`` adds
    the fedguard ack/retransmit + heartbeat-lease layer OUTSIDE chaos —
    ``Reliable(Chaos(Raw))`` — so retransmissions traverse the injected
    faults (``reliability.py``, docs/FAULT_TOLERANCE.md);
    ``wire_chunk_bytes`` adds fedwire chunked framing OUTERMOST —
    ``Chunking(Reliable(Chaos(Raw)))`` — so every bounded frame is its
    own reliable message (``chunking.py``, docs/WIRE.md)."""
    from .chunking import maybe_wrap_chunking
    from .communication.fault_injection import maybe_wrap_with_chaos
    from .reliability import maybe_wrap_reliable
    return maybe_wrap_chunking(
        maybe_wrap_reliable(
            maybe_wrap_with_chaos(
                _create_raw_backend(args, rank, size, backend), args, rank),
            args, rank, size),
        args, rank)


#: backends of the JAX package the port refuses, and why
UNPORTED_BACKENDS = {
    "GRPC": "it needs grpcio, which the card's machine does not have",
    "TRPC": "the tensor-direct backend is not ported",
    "MQTT_WEB3": "the storage-split backends (distributed_storage/) are "
                 "not ported",
    "MQTT_THETA": "the storage-split backends (distributed_storage/) are "
                  "not ported",
    "MQTT_S3_MNN": "the edge-bundle payloads (native/) are not ported",
    "CASTORE": "the storage-split backends (distributed_storage/) are "
               "not ported",
}


def _create_raw_backend(args, rank: int, size: int,
                        backend: str = "local") -> BaseCommunicationManager:
    backend = str(backend)
    run_id = str(getattr(args, "run_id", "0"))
    if backend in ("local", "LOCAL"):
        from .communication.local.local_comm_manager import LocalCommManager
        return LocalCommManager(run_id, rank, size)
    if backend in ("filestore", "FILESTORE"):
        from .communication.filestore.filestore_comm_manager import (
            FileStoreCommManager)
        root = str(getattr(args, "filestore_dir", None) or os.path.join(
            tempfile.gettempdir(), "fedml_tpu_fs"))
        return FileStoreCommManager(root, run_id, rank)
    if backend == "MQTT_S3":
        from .communication.mqtt.mqtt_s3_comm_manager import (
            MqttS3CommManager)
        return MqttS3CommManager(args, rank, size)
    if backend in UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"comm backend {backend!r} is not ported: "
            f"{UNPORTED_BACKENDS[backend]}")
    raise ValueError(f"unknown comm backend {backend!r}")
