"""In-process MQTT 3.1.1 broker (thread-per-connection TCP server).

Gives the vendored client (:mod:`mini_mqtt`) and the federation comm
managers a REAL broker to talk to in-image — real sockets, real packet
framing, real QoS handshakes — replacing round 2's in-memory stand-in
(``tests/fake_paho``), which validated the repo's fake rather than its
client.  Semantics implemented (the slice a federation exercises, matching
the behavior the reference relies on from mosquitto via paho —
``mqtt_manager.py:50,68``):

- sessions keyed by client id; ``clean_session=False`` sessions persist
  subscriptions and queue QoS>0 messages while the client is offline,
  delivering them on reconnect (broker-side store-and-forward);
- retained messages, delivered on subscribe;
- last-will published when a connection drops without DISCONNECT
  (including keepalive timeout at 1.5x the negotiated interval);
- ``+``/``#`` wildcard filters; effective delivery qos =
  min(publish qos, subscription qos);
- inbound QoS2 PUBREC/PUBREL/PUBCOMP handshake with packet-id dedup.

Not implemented (out of scope for tests): $SYS topics, auth ACLs beyond
optional password check, MQTT 5 features, bridging.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

from .mini_mqtt import (CONNACK, CONNECT, DISCONNECT, PINGREQ, PINGRESP,
                        PUBACK, PUBCOMP, PUBLISH, PUBREC, PUBREL, SUBACK,
                        SUBSCRIBE, UNSUBACK, UNSUBSCRIBE, PacketReader,
                        make_packet, make_pid_packet, make_publish,
                        parse_publish, parse_str, topic_matches)


class _Session:
    def __init__(self, client_id: str):
        self.client_id = client_id
        self.subs: List[Tuple[str, int]] = []
        self.queue: List[Tuple[str, bytes, int]] = []  # offline store
        self.qos2_seen: set = set()  # inbound QoS2 pids mid-handshake
        self.conn: Optional["_Connection"] = None
        self.persistent = False


class _Connection:
    def __init__(self, broker: "MiniMqttBroker", sock: socket.socket):
        self.broker = broker
        self.sock = sock
        self.wlock = threading.Lock()
        self.session: Optional[_Session] = None
        self.will: Optional[Tuple[str, bytes, int, bool]] = None
        self.keepalive = 60
        self.alive = True
        self.clean_disconnect = False
        self._pid = 0

    def send(self, data: bytes):
        with self.wlock:
            self.sock.sendall(data)

    def next_pid(self) -> int:
        with self.wlock:  # deliver() runs on many publisher threads
            self._pid = self._pid % 65535 + 1
            return self._pid

    def deliver(self, topic: str, payload: bytes, qos: int,
                retain: bool = False):
        pid = self.next_pid() if qos > 0 else None
        self.send(make_publish(topic, payload, qos, retain, pid))

    def run(self):
        reader = PacketReader(self.sock.recv)
        try:
            ptype, flags, body = reader.read_packet()
            if ptype != CONNECT:
                return
            self._handle_connect(body)
            while self.alive:
                # keepalive enforcement: 1.5x negotiated interval
                self.sock.settimeout(self.keepalive * 1.5
                                     if self.keepalive else None)
                ptype, flags, body = reader.read_packet()
                self._dispatch(ptype, flags, body)
        except (ConnectionError, OSError, socket.timeout):
            pass
        finally:
            self.broker._drop(self)

    # -- packet handlers ---------------------------------------------------
    def _handle_connect(self, body: bytes):
        proto, off = parse_str(body, 0)
        level = body[off]
        cflags = body[off + 1]
        self.keepalive, = struct.unpack_from(">H", body, off + 2)
        off += 4
        client_id, off = parse_str(body, off)
        if cflags & 0x04:  # will flag
            wtopic, off = parse_str(body, off)
            wlen, = struct.unpack_from(">H", body, off)
            off += 2
            wmsg = body[off:off + wlen]
            off += wlen
            self.will = (wtopic, wmsg, (cflags >> 3) & 0x03,
                         bool(cflags & 0x20))
        username = password = None
        if cflags & 0x80:
            username, off = parse_str(body, off)
        if cflags & 0x40:
            password, off = parse_str(body, off)
        if self.broker.password is not None \
                and password != self.broker.password:
            self.send(make_packet(CONNACK, 0, bytes([0, 5])))  # refused
            self.alive = False
            return
        clean = bool(cflags & 0x02)
        session, present = self.broker._attach(client_id, clean, self)
        self.session = session
        self.send(make_packet(CONNACK, 0, bytes([1 if present else 0, 0])))
        for topic, payload, qos in session.queue:
            self.deliver(topic, payload, qos)
        session.queue.clear()

    def _dispatch(self, ptype: int, flags: int, body: bytes):
        if ptype == PUBLISH:
            topic, payload, qos, retain, dup, pid = parse_publish(flags, body)
            if qos == 1:
                self.send(make_pid_packet(PUBACK, pid))
            elif qos == 2:
                self.send(make_pid_packet(PUBREC, pid))
                # dedup on the SESSION: a persistent client that reconnects
                # mid-handshake and retransmits (DUP) must not double-route
                if pid in self.session.qos2_seen:
                    return
                self.session.qos2_seen.add(pid)
            self.broker.route(topic, payload, qos, retain)
        elif ptype == PUBREL:
            pid, = struct.unpack(">H", body)
            self.session.qos2_seen.discard(pid)
            self.send(make_pid_packet(PUBCOMP, pid))
        elif ptype in (PUBACK, PUBCOMP):
            pass  # client acks for broker-initiated qos>0 deliveries
        elif ptype == PUBREC:
            pid, = struct.unpack(">H", body)
            self.send(make_pid_packet(PUBREL, pid))
        elif ptype == SUBSCRIBE:
            pid, = struct.unpack_from(">H", body, 0)
            off, granted = 2, []
            while off < len(body):
                topic, off = parse_str(body, off)
                qos = body[off]
                off += 1
                self.session.subs = [s for s in self.session.subs
                                     if s[0] != topic] + [(topic, qos)]
                granted.append(qos)
                self.broker._deliver_retained(self, topic, qos)
            self.send(make_packet(SUBACK, 0,
                                  struct.pack(">H", pid) + bytes(granted)))
        elif ptype == UNSUBSCRIBE:
            pid, = struct.unpack_from(">H", body, 0)
            off = 2
            while off < len(body):
                topic, off = parse_str(body, off)
                self.session.subs = [s for s in self.session.subs
                                     if s[0] != topic]
            self.send(make_pid_packet(UNSUBACK, pid))
        elif ptype == PINGREQ:
            self.send(make_packet(PINGRESP, 0, b""))
        elif ptype == DISCONNECT:
            self.clean_disconnect = True
            self.alive = False
            raise ConnectionError("clean disconnect")


class MiniMqttBroker:
    """``MiniMqttBroker(port=0).start()`` → listens on ``.port``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 password: Optional[str] = None):
        self.host = host
        self.port = port
        self.password = password
        self._lock = threading.Lock()
        self._sessions: Dict[str, _Session] = {}
        self._retained: Dict[str, Tuple[bytes, int]] = {}
        self._server: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._running = False
        self.message_log: List[Tuple[str, bytes, int]] = []  # test audit

    def start(self) -> "MiniMqttBroker":
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((self.host, self.port))
        self.port = self._server.getsockname()[1]
        self._server.listen(64)
        self._running = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def stop(self):
        self._running = False
        try:
            self._server.close()
        except OSError:
            pass
        with self._lock:
            conns = [s.conn for s in self._sessions.values() if s.conn]
        for c in conns:
            for op in (lambda: c.sock.shutdown(socket.SHUT_RDWR),
                       c.sock.close):
                try:
                    op()
                except OSError:
                    pass

    def _accept_loop(self):
        while self._running:
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            conn = _Connection(self, sock)
            threading.Thread(target=conn.run, daemon=True).start()

    # -- session management -------------------------------------------------
    def _attach(self, client_id: str, clean: bool, conn: _Connection):
        with self._lock:
            old = self._sessions.get(client_id)
            if old is not None and old.conn is not None:
                # session takeover (spec 3.1.4): drop the old connection
                old.conn.alive = False
                for op in (lambda: old.conn.sock.shutdown(
                               socket.SHUT_RDWR),
                           old.conn.sock.close):
                    try:
                        op()
                    except OSError:
                        pass
            if clean or old is None:
                session = _Session(client_id)
                present = False
            else:
                session, present = old, True
            session.persistent = not clean
            session.conn = conn
            self._sessions[client_id] = session
            return session, present

    def _drop(self, conn: _Connection):
        will = None
        with self._lock:
            s = conn.session
            if s is not None and s.conn is conn:
                s.conn = None
                if not s.persistent:
                    self._sessions.pop(s.client_id, None)
            if not conn.clean_disconnect:
                will = conn.will
        try:
            conn.sock.close()
        except OSError:
            pass
        if will is not None:
            self.route(*will)

    # -- routing -------------------------------------------------------------
    def route(self, topic: str, payload: bytes, qos: int,
              retain: bool = False):
        with self._lock:
            self.message_log.append((topic, payload, qos))
            if retain:
                if payload:
                    self._retained[topic] = (payload, qos)
                else:
                    self._retained.pop(topic, None)  # empty clears (spec)
            targets = []
            for s in self._sessions.values():
                best = max((sq for pat, sq in s.subs
                            if topic_matches(pat, topic)), default=None)
                if best is None:
                    continue
                eff = min(qos, best)
                if s.conn is not None:
                    targets.append((s.conn, eff))
                elif s.persistent and eff > 0:
                    s.queue.append((topic, payload, eff))
        for conn, eff in targets:
            try:
                conn.deliver(topic, payload, eff, retain=False)
            except OSError:
                pass

    def _deliver_retained(self, conn: _Connection, pattern: str, sub_qos: int):
        with self._lock:
            hits = [(t, p, q) for t, (p, q) in self._retained.items()
                    if topic_matches(pattern, t)]
        for t, p, q in hits:
            try:
                conn.deliver(t, p, min(q, sub_qos), retain=True)
            except OSError:
                pass


__all__ = ["MiniMqttBroker"]
