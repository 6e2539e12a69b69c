"""SecAgg client FSM (port of
``fedml_tpu.cross_silo.secagg.sa_fedml_client_manager``).

Bonawitz-style secure aggregation over the comm layer:
  round r:  DH public key exchange (via server) → pairwise seeds s_ij
         →  Shamir-share the self-mask seed b_i to peers (via server)
         →  train; upload y_i = quantize(w_i·params) + PRG(b_i) + pairwise
         →  on the server's active-client list, reveal the b-shares held
            for surviving peers so the server can strip self-masks.
Pairwise masks cancel in the sum (``core/mpc/secagg.pairwise_mask``
identity); the server never sees an unmasked update.

The DH group is a Mersenne-prime demo group (M89), its keys Python
integers sent as ``str``; the field arithmetic is host numpy, bitwise the
JAX package's.  The trainer is ``train(global_params, round_idx) ->
(params, num_samples)``; its params may be numpy arrays or tensors on any
device, and are flattened on the host by :func:`flatten_params`.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Dict

import numpy as np
import torch

from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.hostrng import gen as hostgen
from ...core.mpc.secagg import P, masked_input, shamir_share
from .sa_message_define import MyMessage

log = logging.getLogger(__name__)

DH_P = (1 << 89) - 1  # Mersenne prime M89 — demo-grade DH group
DH_G = 3


def derive_pair_seed(shared_secret: int) -> int:
    h = hashlib.sha256(str(shared_secret).encode()).digest()
    return int.from_bytes(h[:8], "little")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(torch.float32).cpu().numpy()
    return np.asarray(leaf)


def flatten_params(params) -> np.ndarray:
    """A params dict as one float32 host vector: the keys sorted, each leaf
    raveled in its own layout (the JAX ``tree_flatten_1d`` of a flat dict).
    Every party of a round flattens the same names the same way, so the
    order never depends on what a process has registered."""
    return np.concatenate([_host(params[k]).astype(np.float32).ravel()
                           for k in sorted(params)])


def unflatten_params(vec: np.ndarray, like, device) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`flatten_params` against ``like``'s shapes and
    dtypes: tensors on ``device``, in ``like``'s key order."""
    out, off = {}, 0
    for k in sorted(like):
        shape = tuple(like[k].shape)
        size = int(np.prod(shape, dtype=np.int64))
        dtype = torch.as_tensor(like[k]).dtype
        out[k] = torch.from_numpy(np.array(vec[off:off + size])).reshape(
            shape).to(device=device, dtype=dtype)
        off += size
    return {k: out[k] for k in like}


class SAClientManager(FedMLCommManager):
    def __init__(self, args, trainer, comm=None, rank=0, size=0,
                 backend="local"):
        super().__init__(args, comm, rank, size, backend)
        self.trainer = trainer
        self.client_num = size - 1
        self.t = int(getattr(args, "secagg_threshold",
                             self.client_num // 2 + 1))
        self.round_idx = 0
        self._sk = None
        self._b_seed = None
        self._pair_seeds: Dict[tuple, int] = {}
        self._held_b_shares: Dict[int, np.ndarray] = {}
        self._pending_global = None

    def register_message_receive_handlers(self):
        M = MyMessage
        self.register_message_receive_handler(M.MSG_TYPE_S2C_INIT_CONFIG,
                                              self._handle_init)
        self.register_message_receive_handler(M.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                                              self._handle_sync)
        self.register_message_receive_handler(M.MSG_TYPE_S2C_OTHER_PK_TO_CLIENT,
                                              self._handle_pk_others)
        self.register_message_receive_handler(M.MSG_TYPE_S2C_OTHER_SS_TO_CLIENT,
                                              self._handle_ss_others)
        self.register_message_receive_handler(M.MSG_TYPE_S2C_ACTIVE_CLIENT_LIST,
                                              self._handle_active)
        self.register_message_receive_handler(M.MSG_TYPE_S2C_FINISH,
                                              self._handle_finish)

    # -- phase 0: receive model, publish DH public key ---------------------
    def _handle_init(self, msg: Message):
        self._start_round(msg)

    def _handle_sync(self, msg: Message):
        self._start_round(msg)

    def _start_round(self, msg: Message):
        self.round_idx = int(msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX) or 0)
        self._pending_global = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        self._held_b_shares.clear()
        self._pair_seeds.clear()
        rng = hostgen(int(getattr(self.args, "random_seed", 0)) + self.rank,
                      0x5A, self.round_idx)
        self._sk = int(rng.integers(2, 1 << 62))
        # b_seed lives in the Shamir field so the server's reconstruction
        # seeds the identical PRG stream
        self._b_seed = int(rng.integers(0, P))
        pk = pow(DH_G, self._sk, DH_P)
        m = Message(MyMessage.MSG_TYPE_C2S_SEND_PK_TO_SERVER, self.rank, 0)
        m.add_params(MyMessage.MSG_ARG_KEY_PK, str(pk))
        self.send_message(m)

    # -- phase 1: derive pair seeds, Shamir-share b_i ----------------------
    def _handle_pk_others(self, msg: Message):
        pks = {int(k): int(v) for k, v in
               msg.get(MyMessage.MSG_ARG_KEY_PK_OTHERS).items()}
        for j, pk_j in pks.items():
            if j == self.rank:
                continue
            shared = pow(pk_j, self._sk, DH_P)
            self._pair_seeds[tuple(sorted((self.rank, j)))] = \
                derive_pair_seed(shared)
        # Shamir-share the self-mask seed to the N clients (share point j
        # goes to client rank j, routed by the server)
        shares = shamir_share(np.array([self._b_seed % P], dtype=np.int64),
                              n=self.client_num, t=self.t,
                              seed=self._sk & 0x7FFFFFFF)
        for j, share in shares.items():
            m = Message(MyMessage.MSG_TYPE_C2S_SEND_SS_TO_SERVER, self.rank, 0)
            m.add_params(MyMessage.MSG_ARG_KEY_CLIENT_ID, j)
            m.add_params(MyMessage.MSG_ARG_KEY_SS, share)
            self.send_message(m)
        # train + upload the masked model
        new_params, num_samples = self.trainer.train(self._pending_global,
                                                     self.round_idx)
        upd = flatten_params(new_params).astype(np.float64)
        peer_ids = list(range(1, self.client_num + 1))
        y = masked_input(upd * float(num_samples), self.rank, peer_ids,
                         self._pair_seeds, self._b_seed)
        m = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, 0)
        m.add_params(MyMessage.MSG_ARG_KEY_MASKED_PARAMS, y)
        m.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, num_samples)
        # round-bind the masked upload like the reveal path does: a
        # delayed or duplicated round-r upload must not land in round
        # r+1's sum
        m.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.round_idx)
        self.send_message(m)

    def _handle_ss_others(self, msg: Message):
        src = int(msg.get(MyMessage.MSG_ARG_KEY_CLIENT_ID))
        self._held_b_shares[src] = np.asarray(
            msg.get(MyMessage.MSG_ARG_KEY_SS), dtype=np.int64)

    # -- phase 2: unmasking — reveal held shares for survivors -------------
    def _handle_active(self, msg: Message):
        active = [int(a) for a in msg.get(MyMessage.MSG_ARG_KEY_ACTIVE_CLIENTS)]
        reveal = {str(i): self._held_b_shares[i] for i in active
                  if i in self._held_b_shares}
        m = Message(MyMessage.MSG_TYPE_C2S_SEND_SS_OTHERS_TO_SERVER,
                    self.rank, 0)
        m.add_params(MyMessage.MSG_ARG_KEY_SS_OTHERS, reveal)
        m.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.round_idx)
        self.send_message(m)

    def _handle_finish(self, msg: Message):
        self.finish()

    def run(self):
        self.send_message(Message(MyMessage.MSG_TYPE_C2S_CLIENT_STATUS,
                                  self.rank, 0))
        super().run()
