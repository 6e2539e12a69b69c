"""Vendored MQTT 3.1.1 client — real wire protocol over real sockets.

The reference runs ``paho-mqtt`` against live brokers
(``core/distributed/communication/mqtt/mqtt_manager.py:14,50,68`` —
connect/reconnect, last-will, qos) but this image does not ship paho, so
round 2's MQTT tests only exercised an in-memory stand-in.  This module is
an original, from-scratch implementation of the MQTT 3.1.1 protocol
(OASIS spec, public) sufficient for the framework's broker traffic:

- CONNECT/CONNACK with clean-session, username/password, last-will;
- PUBLISH at QoS 0/1/2 with the full PUBACK / PUBREC-PUBREL-PUBCOMP
  handshakes (inbound QoS2 deduplicated by packet id);
- SUBSCRIBE/SUBACK, UNSUBSCRIBE/UNSUBACK, PINGREQ/PINGRESP, DISCONNECT.

The public surface mirrors the slice of ``paho.mqtt.client.Client`` the
comm managers use, so ``MqttS3CommManager`` runs unchanged against either
paho (if installed) or this client — and therefore against ANY real MQTT
broker, not just the in-process one in ``mini_broker.py``.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import uuid
from typing import Callable, Dict, Optional, Tuple

CONNECT, CONNACK, PUBLISH, PUBACK, PUBREC, PUBREL, PUBCOMP = range(1, 8)
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK, PINGREQ, PINGRESP, DISCONNECT = \
    range(8, 15)


# -- primitive encoders ------------------------------------------------------
def enc_varint(n: int) -> bytes:
    """Remaining-length varint (7 bits per byte, MSB = continuation)."""
    if not 0 <= n < 268_435_456:
        raise ValueError(f"remaining length out of range: {n}")
    out = bytearray()
    while True:
        n, digit = divmod(n, 128)
        out.append(digit | (0x80 if n else 0))
        if not n:
            return bytes(out)


def enc_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


class PacketReader:
    """Incremental packet framing over a byte stream."""

    def __init__(self, recv: Callable[[int], bytes]):
        self._recv = recv

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._recv(n - len(buf))
            if not chunk:
                raise ConnectionError("stream closed mid-packet")
            buf.extend(chunk)
        return bytes(buf)

    def read_packet(self) -> Tuple[int, int, bytes]:
        """Returns (packet_type, flags, body) or raises ConnectionError."""
        head = self._recv(1)
        if not head:
            raise ConnectionError("stream closed")
        ptype, flags = head[0] >> 4, head[0] & 0x0F
        length, shift = 0, 0
        for _ in range(4):
            b = self._read_exact(1)[0]
            length |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        else:
            raise ConnectionError("malformed remaining length")
        body = self._read_exact(length) if length else b""
        return ptype, flags, body


def parse_str(body: bytes, off: int) -> Tuple[str, int]:
    n, = struct.unpack_from(">H", body, off)
    off += 2
    return body[off:off + n].decode("utf-8"), off + n


def make_packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + enc_varint(len(body)) + body


def make_connect(client_id: str, clean_session: bool, keepalive: int,
                 will: Optional[Tuple[str, bytes, int, bool]] = None,
                 username: Optional[str] = None,
                 password: Optional[str] = None) -> bytes:
    flags = 0x02 if clean_session else 0
    payload = enc_str(client_id)
    if will is not None:
        topic, msg, qos, retain = will
        flags |= 0x04 | (qos << 3) | (0x20 if retain else 0)
        payload += enc_str(topic) + struct.pack(">H", len(msg)) + msg
    if username is not None:
        flags |= 0x80
        payload += enc_str(username)
        if password is not None:
            flags |= 0x40
            payload += enc_str(password)
    body = (enc_str("MQTT") + bytes([4, flags])
            + struct.pack(">H", keepalive) + payload)
    return make_packet(CONNECT, 0, body)


def make_publish(topic: str, payload: bytes, qos: int, retain: bool,
                 pid: Optional[int] = None, dup: bool = False) -> bytes:
    flags = (0x08 if dup else 0) | (qos << 1) | (1 if retain else 0)
    body = enc_str(topic)
    if qos > 0:
        body += struct.pack(">H", pid)
    return make_packet(PUBLISH, flags, body + payload)


def make_pid_packet(ptype: int, pid: int) -> bytes:
    flags = 0x02 if ptype in (PUBREL, SUBSCRIBE, UNSUBSCRIBE) else 0
    return make_packet(ptype, flags, struct.pack(">H", pid))


def make_subscribe(pid: int, filters) -> bytes:
    body = struct.pack(">H", pid)
    for topic, qos in filters:
        body += enc_str(topic) + bytes([qos])
    return make_packet(SUBSCRIBE, 0x02, body)


def parse_publish(flags: int, body: bytes):
    """→ (topic, payload, qos, retain, dup, pid)."""
    qos = (flags >> 1) & 0x03
    topic, off = parse_str(body, 0)
    pid = None
    if qos > 0:
        pid, = struct.unpack_from(">H", body, off)
        off += 2
    return topic, body[off:], qos, bool(flags & 1), bool(flags & 8), pid


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT filter match incl. ``+`` (one level) and ``#`` (tail)."""
    pp, tp = pattern.split("/"), topic.split("/")
    for i, p in enumerate(pp):
        if p == "#":
            return True
        if i >= len(tp) or (p != "+" and p != tp[i]):
            return False
    return len(pp) == len(tp)


class MqttMessage:
    """Inbound message, paho-shaped (``.topic`` / ``.payload`` / ``.qos``)."""

    def __init__(self, topic: str, payload: bytes, qos: int,
                 retain: bool = False):
        self.topic = topic
        self.payload = payload
        self.qos = qos
        self.retain = retain


class MessageInfo:
    """Return of :meth:`Client.publish`, paho-shaped."""

    def __init__(self):
        self.rc = 0
        self._done = threading.Event()

    def wait_for_publish(self, timeout: Optional[float] = None) -> None:
        self._done.wait(timeout)

    def is_published(self) -> bool:
        return self._done.is_set()


class Client:
    """MQTT 3.1.1 client over one TCP socket.

    Paho-compatible slice: ``username_pw_set``, ``will_set``, ``connect``,
    ``subscribe``, ``publish``, ``loop_start``/``loop_stop``,
    ``disconnect``, ``on_connect``/``on_message``/``on_disconnect``
    callbacks.  ``connect`` is synchronous (CONNACK awaited) so callers may
    subscribe immediately after it returns.
    """

    def __init__(self, client_id: str = "", clean_session: bool = True,
                 userdata=None):
        self.client_id = client_id or f"mini-{uuid.uuid4().hex[:10]}"
        self.clean_session = clean_session
        self.userdata = userdata
        self.on_connect: Optional[Callable] = None
        self.on_message: Optional[Callable] = None
        self.on_disconnect: Optional[Callable] = None
        self._sock: Optional[socket.socket] = None
        self._wlock = threading.Lock()
        self._will: Optional[Tuple[str, bytes, int, bool]] = None
        self._user: Optional[str] = None
        self._pass: Optional[str] = None
        self._pid = 0
        self._pid_lock = threading.Lock()
        # guards _inflight/_pubrel_sent: publish() registers pids from
        # caller threads while the reader thread (_handle) retires them
        # on PUBACK/PUBREC/PUBCOMP — an unguarded dict mutation from both
        # sides can drop an ack and wedge wait_for_publish() forever
        self._track_lock = threading.Lock()
        self._inflight: Dict[int, MessageInfo] = {}
        self._pubrel_sent: Dict[int, MessageInfo] = {}
        self._qos2_inbound: set = set()
        self._suback = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        self._ping_thread: Optional[threading.Thread] = None
        self._running = False
        self._keepalive = 60
        self._connack = threading.Event()
        self._connack_rc = 0

    # -- configuration ----------------------------------------------------
    def username_pw_set(self, username: str, password: str = ""):
        self._user, self._pass = username, password

    def will_set(self, topic: str, payload=b"", qos: int = 0,
                 retain: bool = False):
        if isinstance(payload, str):
            payload = payload.encode("utf-8")
        self._will = (topic, bytes(payload), qos, retain)

    # -- wire helpers ------------------------------------------------------
    def _send(self, data: bytes):
        with self._wlock:
            if self._sock is None:
                raise ConnectionError("not connected")
            self._sock.sendall(data)

    def _next_pid(self) -> int:
        with self._pid_lock:
            self._pid = self._pid % 65535 + 1
            return self._pid

    # -- lifecycle ---------------------------------------------------------
    def connect(self, host: str, port: int = 1883, keepalive: int = 60):
        # connect() happens-before loop_start() by API contract (paho's
        # too), so the reader/ping threads that later read these three
        # cannot exist yet — no lock needed for the setup writes
        self._keepalive = int(keepalive)  # fedrace: disable=unguarded-shared-write
        self._sock = socket.create_connection((host, port), timeout=10.0)  # fedrace: disable=unguarded-shared-write
        self._sock.settimeout(None)
        self._reader = PacketReader(self._sock.recv)  # fedrace: disable=unguarded-shared-write
        self._send(make_connect(self.client_id, self.clean_session,
                                self._keepalive, self._will, self._user,
                                self._pass))
        # CONNACK synchronously (the loop is not running yet)
        ptype, _, body = self._reader.read_packet()
        if ptype != CONNACK or len(body) < 2:
            raise ConnectionError(f"expected CONNACK, got type {ptype}")
        self._connack_rc = body[1]
        if self._connack_rc != 0:
            raise ConnectionError(f"CONNACK refused rc={self._connack_rc}")
        self._connack.set()
        if self.on_connect:
            self.on_connect(self, self.userdata, {}, self._connack_rc)
        return 0

    def subscribe(self, topic, qos: int = 0):
        filters = topic if isinstance(topic, list) else [(topic, qos)]
        self._send(make_subscribe(self._next_pid(), filters))
        return (0, None)

    def publish(self, topic: str, payload=b"", qos: int = 0,
                retain: bool = False) -> MessageInfo:
        if isinstance(payload, str):
            payload = payload.encode("utf-8")
        payload = bytes(payload)
        info = MessageInfo()
        if qos == 0:
            self._send(make_publish(topic, payload, 0, retain))
            info._done.set()
            return info
        pid = self._next_pid()
        with self._track_lock:
            self._inflight[pid] = info
        self._send(make_publish(topic, payload, qos, retain, pid))
        return info

    def loop_start(self):
        if self._running:
            return
        self._running = True
        self._loop_thread = threading.Thread(target=self._loop_forever,
                                             daemon=True)
        self._loop_thread.start()
        self._ping_thread = threading.Thread(target=self._ping_loop,
                                             daemon=True)
        self._ping_thread.start()

    def loop_stop(self):
        self._running = False

    def disconnect(self):
        self._running = False
        try:
            self._send(make_packet(DISCONNECT, 0, b""))
        except Exception:
            pass
        self._close()

    def _close(self):
        with self._wlock:
            if self._sock is not None:
                try:
                    # shutdown (not just close) so the FIN goes out even
                    # while our reader thread is blocked in recv — a bare
                    # close() leaves the kernel socket alive until that
                    # syscall returns, and the peer never sees the drop
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def kill(self):
        """Drop the TCP connection WITHOUT a DISCONNECT packet (test hook:
        the broker must publish our last-will)."""
        self._running = False
        self._close()

    # -- loops -------------------------------------------------------------
    def _ping_loop(self):
        interval = max(self._keepalive / 2.0, 1.0)
        while self._running:
            time.sleep(interval)
            if not self._running:
                return
            try:
                self._send(make_packet(PINGREQ, 0, b""))
            except Exception:
                return

    def _loop_forever(self):
        try:
            while self._running:
                ptype, flags, body = self._reader.read_packet()
                self._handle(ptype, flags, body)
        except (ConnectionError, OSError):
            pass
        finally:
            was_running, self._running = self._running, False
            self._close()
            if self.on_disconnect:
                # rc!=0 signals an unexpected drop (paho convention)
                self.on_disconnect(self, self.userdata,
                                   1 if was_running else 0)

    def _handle(self, ptype: int, flags: int, body: bytes):
        if ptype == PUBLISH:
            topic, payload, qos, retain, dup, pid = parse_publish(flags, body)
            if qos == 1:
                self._send(make_pid_packet(PUBACK, pid))
            elif qos == 2:
                self._send(make_pid_packet(PUBREC, pid))
                if pid in self._qos2_inbound:
                    return  # duplicate delivery suppressed
                self._qos2_inbound.add(pid)
            if self.on_message:
                self.on_message(self, self.userdata,
                                MqttMessage(topic, payload, qos, retain))
        elif ptype == PUBACK:
            pid, = struct.unpack(">H", body)
            with self._track_lock:
                info = self._inflight.pop(pid, None)
            if info:
                info._done.set()
        elif ptype == PUBREC:
            pid, = struct.unpack(">H", body)
            with self._track_lock:
                info = self._inflight.pop(pid, None)
                if info is not None:
                    self._pubrel_sent[pid] = info
            self._send(make_pid_packet(PUBREL, pid))
        elif ptype == PUBCOMP:
            pid, = struct.unpack(">H", body)
            with self._track_lock:
                info = self._pubrel_sent.pop(pid, None)
            if info:
                info._done.set()
        elif ptype == PUBREL:
            pid, = struct.unpack(">H", body)
            self._qos2_inbound.discard(pid)
            self._send(make_pid_packet(PUBCOMP, pid))
        elif ptype in (SUBACK, UNSUBACK):
            self._suback.set()
        elif ptype == PINGRESP:
            pass
        elif ptype == PINGREQ:  # broker-side keepalive probe (unusual)
            self._send(make_packet(PINGRESP, 0, b""))


__all__ = ["Client", "MqttMessage", "MessageInfo", "topic_matches",
           "make_packet", "make_connect", "make_publish", "make_subscribe",
           "make_pid_packet", "parse_publish", "parse_str", "enc_varint",
           "enc_str", "PacketReader"]
