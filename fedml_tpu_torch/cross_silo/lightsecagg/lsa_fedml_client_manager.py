"""LightSecAgg client FSM (port of
``fedml_tpu.cross_silo.lightsecagg.lsa_fedml_client_manager``).

Per round: generate a private field mask z_i, MDS-encode it into N shares
(``core/mpc/lightsecagg.mask_encoding``), ship share j to client j via the
server; train; upload quantize(w_i · params) + z_i; when the server announces
the active set, upload the SUM of the shares received from active sources.
The server never sees an unmasked update.  The field arithmetic is host
numpy, bitwise the JAX package's; the trainer and the params are as in
``cross_silo/secagg`` (numpy arrays or tensors, flattened on the host by
``flatten_params``).
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.hostrng import gen as hostgen
from ...core.mpc.lightsecagg import aggregate_shares, mask_encoding
from ...core.mpc.secagg import P, quantize
from ..secagg.sa_fedml_client_manager import flatten_params
from .lsa_message_define import MyMessage

log = logging.getLogger(__name__)


def lsa_dims(n_clients: int, args) -> tuple:
    """(N, U, T) — N clients, decode threshold U, privacy T (args
    ``worker_num`` / ``targeted_number_active_clients`` /
    ``privacy_guarantee``)."""
    N = n_clients
    T = int(getattr(args, "privacy_guarantee", max(1, N // 4)))
    U = int(getattr(args, "targeted_number_active_clients", N - 1 if N > 2 else N))
    U = max(U, T + 1)
    return N, min(U, N), T


class LSAClientManager(FedMLCommManager):
    def __init__(self, args, trainer, comm=None, rank=0, size=0,
                 backend="local"):
        super().__init__(args, comm, rank, size, backend)
        self.trainer = trainer
        self.client_num = size - 1
        self.N, self.U, self.T = lsa_dims(self.client_num, args)
        self.round_idx = 0
        self.num_rounds = int(getattr(args, "comm_round", 1))
        self._received_shares: Dict[int, np.ndarray] = {}
        self._mask: np.ndarray = None
        self._dim = None

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self._handle_init)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_ENCODED_MASK_TO_CLIENT, self._handle_encoded_mask)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, self._handle_sync_model)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SEND_TO_ACTIVE_CLIENT, self._handle_active_set)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_FINISH, self._handle_finish)

    # -- round body --------------------------------------------------------
    def _handle_init(self, msg: Message):
        # adopt the server's round index on init too (it broadcasts it on
        # both paths) so the round-bound upload always matches
        self.round_idx = int(msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX) or 0)
        params = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        self._round(params)

    def _handle_sync_model(self, msg: Message):
        self.round_idx = int(msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX))
        self._round(msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS))

    def _round(self, global_params):
        self._received_shares.clear()
        d = sum(int(np.prod(tuple(v.shape), dtype=np.int64))
                for v in global_params.values())
        k = self.U - self.T
        self._dim = (-(-d // k)) * k  # padded dimension
        # 1) private mask + encoded shares, share j -> client j via server
        rng = hostgen(int(getattr(self.args, "random_seed", 0)) + self.rank,
                      0x15A, self.round_idx)
        self._mask = rng.integers(0, P, size=self._dim, dtype=np.int64)
        shares = mask_encoding(self._dim, self.N, self.U, self.T, self._mask,
                               seed=int(rng.integers(0, 2**31)))
        for j, share in shares.items():
            m = Message(MyMessage.MSG_TYPE_C2S_SEND_ENCODED_MASK_TO_SERVER,
                        self.rank, 0)
            m.add_params(MyMessage.MSG_ARG_KEY_CLIENT_ID, j)
            m.add_params(MyMessage.MSG_ARG_KEY_ENCODED_MASK, share)
            self.send_message(m)
        # 2) local training; upload masked, weight-scaled params
        new_params, num_samples = self.trainer.train(global_params,
                                                     self.round_idx)
        upd = flatten_params(new_params).astype(np.float64)
        masked = (quantize(upd * float(num_samples)) + self._mask[:d]) % P
        m = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, 0)
        m.add_params(MyMessage.MSG_ARG_KEY_MASKED_PARAMS, masked)
        m.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, num_samples)
        # round-bind the masked upload like the aggregate-share path: the
        # mask z_i is per-round, so a stale upload can never be unmasked
        m.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.round_idx)
        self.send_message(m)

    def _handle_encoded_mask(self, msg: Message):
        src = int(msg.get(MyMessage.MSG_ARG_KEY_CLIENT_ID))
        self._received_shares[src] = np.asarray(
            msg.get(MyMessage.MSG_ARG_KEY_ENCODED_MASK), dtype=np.int64)

    def _handle_active_set(self, msg: Message):
        active = [int(a) for a in msg.get(MyMessage.MSG_ARG_KEY_ACTIVE_CLIENTS)]
        agg = aggregate_shares([self._received_shares[i] for i in active
                                if i in self._received_shares])
        m = Message(MyMessage.MSG_TYPE_C2S_SEND_MASK_TO_SERVER, self.rank, 0)
        m.add_params(MyMessage.MSG_ARG_KEY_AGGREGATE_ENCODED_MASK, agg)
        m.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.round_idx)
        self.send_message(m)

    def _handle_finish(self, msg: Message):
        self.finish()

    def run(self):
        # announce readiness so an MLOps-style server can gate on it
        msg = Message(MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.rank, 0)
        self.send_message(msg)
        super().run()
