"""MQTT+object-store communication backend (reference
``core/distributed/communication/mqtt_s3/mqtt_s3_multi_clients_comm_manager.py:20``).

Split transport exactly as the reference: the broker carries small control
JSON on topic ``fedml_{run_id}_{sender}_{receiver}`` (qos=2, last-will
OFFLINE), bulk tensors go to an object store and the message carries the key.
Broker/store endpoints are plain config (``mqtt_config`` / ``store_dir``) —
NOT fetched from a vendor backend (SURVEY §7 hard-parts: decouple from the
TensorOpera cloud).

Client library: ``paho-mqtt`` when installed, else the vendored MQTT 3.1.1
wire-protocol client (:mod:`.mini_mqtt`) — same API slice, real sockets —
so this backend works against any real broker (mosquitto, EMQX, or the
in-process :class:`.mini_broker.MiniMqttBroker`) in-image.

Port of the JAX module.  What differs: the blob store's default
directory is under the system temporary directory (``tempfile``, which
honours ``TMPDIR``) rather than a fixed ``/tmp`` path, and the mobile-edge
variant ``MqttS3MnnCommManager`` (edge bundles, ``native/``) is not ported:
``create_comm_backend`` refuses ``MQTT_S3_MNN`` by name.  Added:
:func:`preregister_session`, which opens a rank's persistent session on
the broker before its process starts, so that processes launched together
lose no early message.  And a manager closes its connection only after
its in-flight QoS 2 publishes have completed (``PUBLISH_DRAIN_S``): the
JAX module disconnects right after the server's last sends (from inside
the network loop's own handler), and a socket closed with unread
acknowledgements in its buffer is reset, which can drop the FINISH
messages before the broker reads them, so the silos never stop.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import uuid
from typing import List

from .....obs import context as obs_context
from .....obs import get_tracer
from ..base_com_manager import BaseCommunicationManager, Observer
from ..message import Message, encode_tree, decode_tree, MSG_ARG_KEY_MODEL_PARAMS


#: seconds a closing manager waits for its in-flight publishes
PUBLISH_DRAIN_S = 10.0


class MqttS3CommManager(BaseCommunicationManager):
    def __init__(self, args, rank: int, size: int):
        try:
            import paho.mqtt.client as mqtt
        except ImportError:
            from . import mini_mqtt as mqtt

        def make_client(**kw):
            # paho >= 2.0 requires a leading CallbackAPIVersion argument
            api_ver = getattr(mqtt, "CallbackAPIVersion", None)
            if api_ver is not None:
                return mqtt.Client(api_ver.VERSION1, **kw)
            return mqtt.Client(**kw)

        cfg = getattr(args, "mqtt_config", {}) or {}
        self.rank = int(rank)
        self.size = int(size)
        self.run_id = str(getattr(args, "run_id", "0"))
        self.store_dir = str(getattr(args, "store_dir", None) or os.path.join(
            tempfile.gettempdir(), "fedml_tpu_store"))
        os.makedirs(self.store_dir, exist_ok=True)
        self._observers: List[Observer] = []
        self._running = False
        self._looping = False
        self._closed = False
        self._pending = []   # MessageInfo of publishes not yet completed
        self._pending_lock = threading.Lock()

        # STABLE client id: a persistent (clean_session=False) session is
        # only useful if a reconnect can resume it; a random suffix would
        # strand dead sessions (and their queued QoS traffic) on the broker
        self._client = make_client(
            client_id=f"fedml_{self.run_id}_{self.rank}",
            clean_session=False)
        if cfg.get("user"):
            self._client.username_pw_set(cfg["user"], cfg.get("password", ""))
        # last-will OFFLINE (reference mqtt_manager.py:68-74)
        self._client.will_set(self._status_topic(self.rank),
                              json.dumps({"status": "OFFLINE", "rank": self.rank}),
                              qos=2, retain=True)
        self._client.on_message = self._on_message
        self._client.connect(cfg.get("host", "127.0.0.1"),
                             int(cfg.get("port", 1883)), keepalive=60)
        # one explicit subscription per peer (reference
        # mqtt_s3_multi_clients_comm_manager subscribes per sender): the
        # underscore topic scheme has no '/' levels, so an MQTT '+' wildcard
        # cannot match inside it
        for sender in range(self.size):
            if sender != self.rank:
                self._client.subscribe(self._topic(sender, self.rank), qos=2)

    def _topic(self, sender, receiver) -> str:
        return f"fedml_{self.run_id}_{sender}_{receiver}"

    def _status_topic(self, rank) -> str:
        return f"fedml_{self.run_id}/status/{rank}"

    # -- S3-equivalent blob store -----------------------------------------
    def _put_blob(self, payload) -> str:
        key = f"{self.run_id}_{uuid.uuid4().hex}.bin"
        with open(os.path.join(self.store_dir, key), "wb") as f:
            f.write(encode_tree(payload))
        return key

    def _get_blob(self, key: str):
        with open(os.path.join(self.store_dir, key), "rb") as f:
            return decode_tree(f.read())

    # -- BaseCommunicationManager -----------------------------------------
    def send_message(self, msg: Message):
        tracer = get_tracer()
        tier = obs_context.comm_tier(msg.get_sender_id(),
                                     msg.get_receiver_id())
        # fedtrace span covers the blob store write + broker publish (the
        # two wire legs of the reference's split transport); the injected
        # context rides the control JSON, so the receiver's handler span
        # links back here even though the tensor payload detours via blobs
        span = tracer.span("comm.send", cat="comm", backend="mqtt",
                           dst=msg.get_receiver_id(), tier=tier,
                           msg_type=str(msg.get_type()),
                           msg_id=msg.get(obs_context.KEY_MSG_ID),
                           round=msg.get("round_idx"))
        nbytes = 0
        with span:
            params = dict(msg.get_params())
            obs_context.inject(params, tracer)
            model = params.pop(MSG_ARG_KEY_MODEL_PARAMS, None)
            if model is not None:
                key = self._put_blob(model)
                params["model_params_key"] = key
                if tracer.enabled:
                    try:
                        nbytes += os.path.getsize(
                            os.path.join(self.store_dir, key))
                    except OSError:
                        pass
            control = json.dumps(params, default=float)
            nbytes += len(control)
            info = self._client.publish(
                self._topic(msg.get_sender_id(), msg.get_receiver_id()),
                control, qos=2)
            with self._pending_lock:
                self._pending = [i for i in self._pending
                                 if not i.is_published()] + [info]
        if tracer.enabled:
            tracer.add_bytes(f"comm.bytes.{tier}", nbytes)
            if span.duration_s is not None:
                tracer.counter(f"comm.rtt.{tier}", span.duration_s)

    def _on_message(self, client, userdata, mqtt_msg):
        params = json.loads(mqtt_msg.payload)
        key = params.pop("model_params_key", None)
        if key is not None:
            params[MSG_ARG_KEY_MODEL_PARAMS] = self._get_blob(key)
        msg = Message()
        msg.init(params)
        for obs in list(self._observers):
            obs.receive_message(msg.get_type(), msg)

    def add_observer(self, observer: Observer):
        self._observers.append(observer)

    def remove_observer(self, observer: Observer):
        if observer in self._observers:
            self._observers.remove(observer)

    def handle_receive_message(self):
        self._running = True
        self._looping = True
        ready = Message(Message.MSG_TYPE_CONNECTION_IS_READY, self.rank, self.rank)
        for obs in list(self._observers):
            obs.receive_message(ready.get_type(), ready)
        self._client.loop_start()
        while self._running:
            time.sleep(0.1)
        # the network loop still runs: the last sends complete their QoS 2
        # handshakes before the connection closes
        self._close()

    def stop_receive_message(self):
        """Stop the receive loop; the connection closes once this rank's
        in-flight publishes have completed (at most ``PUBLISH_DRAIN_S``).
        Called from a message handler — the network loop's own thread —
        it only flags the loop, whose thread then drains and closes."""
        self._running = False
        if not self._looping:
            self._close()

    def _close(self):
        with self._pending_lock:
            if self._closed:
                return
            self._closed = True
            pending = list(self._pending)
        try:
            info = self._client.publish(self._status_topic(self.rank),
                                        json.dumps({"status": "FINISHED"}),
                                        qos=2)
            deadline = time.monotonic() + PUBLISH_DRAIN_S
            for i in pending + [info]:
                while not i.is_published() and time.monotonic() < deadline:
                    time.sleep(0.01)
            self._client.disconnect()
        except Exception:
            pass
        self._client.loop_stop()


def preregister_session(args, rank: int, size: int) -> None:
    """Open ``rank``'s persistent session on the broker in ``args.
    mqtt_config`` — the client id and per-peer subscriptions its
    :class:`MqttS3CommManager` will use — then disconnect cleanly.  A
    broker holds a ``clean_session=False`` session's subscriptions and
    queues its QoS>0 traffic while it is offline, so messages published
    to ``rank`` before its process connects (a silo's ONLINE status racing
    the server's start-up) are delivered when it does, instead of being
    dropped for want of a subscriber.  Run it for the server before its
    processes are launched."""
    from . import mini_mqtt

    cfg = getattr(args, "mqtt_config", {}) or {}
    run_id = str(getattr(args, "run_id", "0"))
    client = mini_mqtt.Client(client_id=f"fedml_{run_id}_{int(rank)}",
                              clean_session=False)
    if cfg.get("user"):
        client.username_pw_set(cfg["user"], cfg.get("password", ""))
    client.connect(cfg.get("host", "127.0.0.1"), int(cfg.get("port", 1883)),
                   keepalive=60)
    client.loop_start()
    for sender in range(int(size)):
        if sender != int(rank):
            client.subscribe(f"fedml_{run_id}_{sender}_{int(rank)}", qos=2)
    # the broker handles one connection's packets in order: once a
    # message published to our own probe topic comes back, every
    # subscription above is in place
    got = threading.Event()
    probe = f"fedml_{run_id}/probe/{int(rank)}"
    client.on_message = lambda c, u, m: got.set()
    client.subscribe(probe, qos=1)
    client.publish(probe, b"1", qos=1)
    ok = got.wait(10.0)
    client.disconnect()
    if not ok:
        raise TimeoutError(f"MQTT broker at {cfg.get('host', '127.0.0.1')}:"
                           f"{cfg.get('port', 1883)} did not echo the "
                           "session probe within 10 s")
