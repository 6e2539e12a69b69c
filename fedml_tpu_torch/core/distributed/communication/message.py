"""Message — the WAN-path unit of exchange (port of
``fedml_tpu.core.distributed.communication.message``).

Control plane: a small dict (msg_type / sender / receiver / scalars).
Data plane: model trees serialized with msgpack, in flax's layout.

What differs from the JAX module: the JAX codec is flax's
``msgpack_serialize``/``msgpack_restore``, and the card's machine has no
``msgpack``, so :func:`encode_tree` / :func:`decode_tree` are the port's
own pure-Python msgpack writer and reader.  They write the same bytes as
``flax.serialization.msgpack_serialize`` for a tree of dicts, lists,
arrays, ints, floats, strings, bytes, bools and ``None`` (dict keys
sorted, as flax's tree copy sorts them; an array as msgpack ext code 1
holding the msgpack triple ``(shape, dtype name, raw C-order bytes)``; a
numpy scalar as ext code 3; an array above 1 GiB split into flax's
``__msgpack_chunked_array__`` dict), and they read flax's bytes back.  A
``torch.Tensor`` leaf goes to the host first; a bf16 tensor travels under
the dtype name ``"bfloat16"``, as flax writes it, and comes back as a
torch bf16 tensor built from the raw bytes (numpy has no bf16).  Every
other array comes back as a read-only numpy array, as flax's does.
"""

from __future__ import annotations

import struct
from collections import namedtuple
from typing import Any, Dict

import numpy as np

MSG_ARG_KEY_TYPE = "msg_type"
MSG_ARG_KEY_OPERATION = "operation"
MSG_ARG_KEY_SENDER = "sender"
MSG_ARG_KEY_RECEIVER = "receiver"

MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
MSG_ARG_KEY_MODEL_PARAMS = "model_params"
MSG_ARG_KEY_MODEL_PARAMS_URL = "model_params_url"
MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
MSG_ARG_KEY_CLIENT_STATUS = "client_status"
MSG_ARG_KEY_CLIENT_OS = "client_os"
MSG_ARG_KEY_EVENT_NAME = "event_name"


class Message:
    MSG_TYPE_CONNECTION_IS_READY = 0

    # class-attr aliases (reference Message exposes these on the class)
    MSG_ARG_KEY_TYPE = MSG_ARG_KEY_TYPE
    MSG_ARG_KEY_OPERATION = MSG_ARG_KEY_OPERATION
    MSG_ARG_KEY_SENDER = MSG_ARG_KEY_SENDER
    MSG_ARG_KEY_RECEIVER = MSG_ARG_KEY_RECEIVER
    MSG_ARG_KEY_NUM_SAMPLES = MSG_ARG_KEY_NUM_SAMPLES
    MSG_ARG_KEY_MODEL_PARAMS = MSG_ARG_KEY_MODEL_PARAMS
    MSG_ARG_KEY_MODEL_PARAMS_URL = MSG_ARG_KEY_MODEL_PARAMS_URL
    MSG_ARG_KEY_CLIENT_INDEX = MSG_ARG_KEY_CLIENT_INDEX
    MSG_ARG_KEY_CLIENT_STATUS = MSG_ARG_KEY_CLIENT_STATUS
    MSG_ARG_KEY_CLIENT_OS = MSG_ARG_KEY_CLIENT_OS
    MSG_ARG_KEY_EVENT_NAME = MSG_ARG_KEY_EVENT_NAME

    def __init__(self, msg_type: int = 0, sender_id: int = 0,
                 receiver_id: int = 0):
        self.msg_params: Dict[str, Any] = {
            MSG_ARG_KEY_TYPE: msg_type,
            MSG_ARG_KEY_SENDER: sender_id,
            MSG_ARG_KEY_RECEIVER: receiver_id,
        }

    # -- reference surface (message.py) ------------------------------------
    def init(self, msg_params):
        self.msg_params = dict(msg_params)

    def init_from_json_object(self, obj):
        self.msg_params = dict(obj)

    def get_sender_id(self) -> int:
        return int(self.msg_params[MSG_ARG_KEY_SENDER])

    def get_receiver_id(self) -> int:
        return int(self.msg_params[MSG_ARG_KEY_RECEIVER])

    def get_type(self):
        # ints for FSM protocols; flow-name strings for the Flow DSL
        t = self.msg_params[MSG_ARG_KEY_TYPE]
        try:
            return int(t)
        except (TypeError, ValueError):
            return str(t)

    def add_params(self, key: str, value: Any):
        self.msg_params[key] = value

    def add(self, key: str, value: Any):
        self.msg_params[key] = value

    def get_params(self) -> Dict[str, Any]:
        return self.msg_params

    def get(self, key: str, default=None):
        return self.msg_params.get(key, default)

    def require(self, key: str):
        """Read a REQUIRED protocol param.  A missing key raises a
        ``KeyError`` naming the msg_type and sender instead of handing the
        caller a silent ``None``."""
        if key not in self.msg_params:
            raise KeyError(
                f"message type {self.get_type()} from sender "
                f"{self.msg_params.get(MSG_ARG_KEY_SENDER)} is missing "
                f"required param {key!r} — no sender add_params-set it")
        return self.msg_params[key]

    def __repr__(self):
        keys = {k: type(v).__name__ for k, v in self.msg_params.items()}
        return f"Message({keys})"


# -- msgpack, flax's layout --------------------------------------------------
#: flax's ``_MsgpackExtType`` codes
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
#: flax's ``MAX_CHUNK_SIZE``: an array above it travels as chunks
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED_KEY = "__msgpack_chunked_array__"

#: an ext payload of an unknown code, as msgpack's ``ExtType``
ExtType = namedtuple("ExtType", "code data")


def _is_tensor(x) -> bool:
    return type(x).__module__.startswith("torch") and hasattr(x, "dtype") \
        and hasattr(x, "detach")


def _is_bf16(x) -> bool:
    return _is_tensor(x) and str(x.dtype) == "torch.bfloat16"


def _host(x):
    """A tensor leaf on the host: a numpy array, or a CPU bf16 tensor."""
    x = x.detach().cpu()
    return x if _is_bf16(x) else x.numpy()


def _array_nbytes(a) -> int:
    return a.numel() * a.element_size() if _is_tensor(a) else a.nbytes


def _chunk(arr) -> dict:
    """flax's ``_chunk``: a flat split into MAX_CHUNK_SIZE pieces."""
    itemsize = arr.element_size() if _is_tensor(arr) else arr.dtype.itemsize
    n = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    size = flat.shape[0]
    return {CHUNKED_KEY: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + n] for i, j in
                       enumerate(range(0, size, n))}}


def _prepare(x, chunk: bool = True):
    """flax's tree copy (dict keys sorted), tensors to the host, and an
    array above MAX_CHUNK_SIZE chunked where flax chunks it: at the root
    or under dicts only (nothing below a list)."""
    if type(x) is dict:
        return {k: _prepare(x[k], chunk) for k in sorted(x)}
    if type(x) is list:
        return [_prepare(v, False) for v in x]
    if _is_tensor(x):
        x = _host(x)
    if chunk and (isinstance(x, np.ndarray) or _is_bf16(x)) and \
            _array_nbytes(x) > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def pack(self, obj, strict: bool = True, ext: bool = True):
        """msgpack-python's ``Packer`` with ``use_bin_type=True`` (and
        ``strict_types`` with flax's ``default`` when ``strict``)."""
        b = self.buf
        t = type(obj)
        if obj is None:
            b.append(0xc0)
        elif t is bool or (not strict and isinstance(obj, bool)):
            b.append(0xc3 if obj else 0xc2)
        elif t is int or (not strict and isinstance(obj, int)):
            self._int(int(obj))
        elif t in (bytes, bytearray):
            n = len(obj)
            if n <= 0xff:
                b += struct.pack(">BB", 0xc4, n)
            elif n <= 0xffff:
                b += struct.pack(">BH", 0xc5, n)
            else:
                b += struct.pack(">BI", 0xc6, n)
            b += obj
        elif t is str:
            s = obj.encode("utf-8")
            n = len(s)
            if n <= 0x1f:
                b.append(0xa0 | n)
            elif n <= 0xff:
                b += struct.pack(">BB", 0xd9, n)
            elif n <= 0xffff:
                b += struct.pack(">BH", 0xda, n)
            else:
                b += struct.pack(">BI", 0xdb, n)
            b += s
        elif t is float or (not strict and isinstance(obj, float)):
            b += struct.pack(">Bd", 0xcb, obj)
        elif t is list or (not strict and t is tuple):
            n = len(obj)
            if n <= 0x0f:
                b.append(0x90 | n)
            elif n <= 0xffff:
                b += struct.pack(">BH", 0xdc, n)
            else:
                b += struct.pack(">BI", 0xdd, n)
            for v in obj:
                self.pack(v, strict, ext)
        elif t is dict:
            n = len(obj)
            if n <= 0x0f:
                b.append(0x80 | n)
            elif n <= 0xffff:
                b += struct.pack(">BH", 0xde, n)
            else:
                b += struct.pack(">BI", 0xdf, n)
            for k, v in obj.items():
                self.pack(k, strict, ext)
                self.pack(v, strict, ext)
        elif ext and (isinstance(obj, np.ndarray) or _is_bf16(obj)):
            self._ext(EXT_NDARRAY, _array_to_bytes(obj))
        elif ext and isinstance(obj, np.generic):
            self._ext(EXT_NPSCALAR, _array_to_bytes(np.asarray(obj)))
        elif ext and t is complex:
            self._ext(EXT_COMPLEX, packb((obj.real, obj.imag), strict=False,
                                         ext=False))
        else:
            raise TypeError(f"can not serialize {t.__name__!r} object")

    def _int(self, v: int):
        b = self.buf
        if 0 <= v < 0x80:
            b.append(v)
        elif -0x20 <= v < 0:
            b += struct.pack(">b", v)
        elif 0x80 <= v <= 0xff:
            b += struct.pack(">BB", 0xcc, v)
        elif -0x80 <= v < 0:
            b += struct.pack(">Bb", 0xd0, v)
        elif 0xff < v <= 0xffff:
            b += struct.pack(">BH", 0xcd, v)
        elif -0x8000 <= v < -0x80:
            b += struct.pack(">Bh", 0xd1, v)
        elif 0xffff < v <= 0xffffffff:
            b += struct.pack(">BI", 0xce, v)
        elif -0x80000000 <= v < -0x8000:
            b += struct.pack(">Bi", 0xd2, v)
        elif 0xffffffff < v <= 0xffffffffffffffff:
            b += struct.pack(">BQ", 0xcf, v)
        elif -0x8000000000000000 <= v < -0x80000000:
            b += struct.pack(">Bq", 0xd3, v)
        else:
            raise OverflowError("Integer value out of range")

    def _ext(self, code: int, data: bytes):
        b = self.buf
        n = len(data)
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if n in fixed:
            b.append(fixed[n])
        elif n <= 0xff:
            b += struct.pack(">BB", 0xc7, n)
        elif n <= 0xffff:
            b += struct.pack(">BH", 0xc8, n)
        else:
            b += struct.pack(">BI", 0xc9, n)
        b += struct.pack(">b", code)
        b += data


def packb(obj, strict: bool = True, ext: bool = True) -> bytes:
    w = _Writer()
    w.pack(obj, strict, ext)
    return bytes(w.buf)


def _array_to_bytes(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of ``(shape, dtype name,
    C-order bytes)``."""
    if _is_tensor(arr):
        import torch
        raw = arr.contiguous().view(torch.int16).numpy().tobytes()
        tpl = (tuple(arr.shape), "bfloat16", raw)
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
        tpl = (arr.shape, arr.dtype.name, arr.tobytes("C"))
    return packb(tpl, strict=False, ext=False)


class _Reader:
    def __init__(self, data, raw: bool, ext_hook):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook

    def _take(self, n: int):
        p = self.pos
        if p + n > len(self.data):
            raise ValueError("msgpack data is truncated")
        self.pos = p + n
        return self.data[p:p + n]

    def _u(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        s = bytes(self._take(n))
        return s if self.raw else s.decode("utf-8")

    def _array(self, n: int):
        return [self.read() for _ in range(n)]

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            if type(k) not in (str, bytes):
                raise ValueError(
                    f"{type(k).__name__} is not allowed for map key")
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self._u(">b")
        return self.ext_hook(code, bytes(self._take(n)))

    def read(self):
        c = self._u(">B")
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self._map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return self._array(c & 0x0f)
        if 0xa0 <= c <= 0xbf:
            return self._str(c & 0x1f)
        if c == 0xc0:
            return None
        if c == 0xc2:
            return False
        if c == 0xc3:
            return True
        if c in (0xc4, 0xc5, 0xc6):
            n = self._u({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[c])
            return bytes(self._take(n))
        if c in (0xc7, 0xc8, 0xc9):
            return self._ext(self._u({0xc7: ">B", 0xc8: ">H",
                                      0xc9: ">I"}[c]))
        if c == 0xca:
            return self._u(">f")
        if c == 0xcb:
            return self._u(">d")
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if c in ints:
            return self._u(ints[c])
        if c in (0xd4, 0xd5, 0xd6, 0xd7, 0xd8):
            return self._ext(1 << (c - 0xd4))
        if c in (0xd9, 0xda, 0xdb):
            return self._str(self._u({0xd9: ">B", 0xda: ">H",
                                      0xdb: ">I"}[c]))
        if c in (0xdc, 0xdd):
            return self._array(self._u(">H" if c == 0xdc else ">I"))
        if c in (0xde, 0xdf):
            return self._map(self._u(">H" if c == 0xde else ">I"))
        raise ValueError(f"msgpack: unknown format byte 0x{c:02x}")


def unpackb(data, raw: bool = False, ext_hook=None):
    r = _Reader(data, raw, ext_hook or ExtType)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError("msgpack: extra data after the object")
    return out


def _array_from_bytes(data: bytes):
    """flax's ``_ndarray_from_bytes``; ``bfloat16`` as a torch tensor."""
    shape, dtype_name, buf = unpackb(data, raw=True)
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        import torch
        if not buf:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buf), dtype=torch.int16).view(
            torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order="C")


def _ext_unpack(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == EXT_COMPLEX:
        re_, im = unpackb(data)
        return complex(re_, im)
    if code == EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    return ExtType(code, data)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if _is_tensor(chunks[0]):
        import torch
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(d):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(d, dict):
        if CHUNKED_KEY in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and CHUNKED_KEY in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_tree(v)
    return d


def to_host(tree):
    """A tree with its tensors on the host as the codec writes them:
    numpy arrays, and bf16 tensors as CPU tensors (numpy has no bf16)."""
    if type(tree) is dict:
        return {k: to_host(v) for k, v in tree.items()}
    if type(tree) is list:
        return [to_host(v) for v in tree]
    return _host(tree) if _is_tensor(tree) else tree


# -- pytree payload codec --------------------------------------------------
def encode_tree(tree: Any) -> bytes:
    """Tree → msgpack bytes, byte for byte flax's ``msgpack_serialize``
    (tensors moved to the host first)."""
    return packb(_prepare(tree))


def decode_tree(data: bytes) -> Any:
    """msgpack bytes (the port's or flax's) → tree."""
    return _unchunk_tree(unpackb(data, raw=False, ext_hook=_ext_unpack))
