"""Cross-silo client FSM (port of
``fedml_tpu.cross_silo.client.fedml_client_master_manager``): online
handshake → receive global model → local training (the port's
``LocalTrainer`` pass) → upload.

What differs from the JAX module: no round-level ``mlops`` events
(``log_training_status``: a recorded divergence of the port); no upload
compression (``enable_compression`` is refused by name); and no
intra-silo process group — ``scenario="hierarchical"`` and slave ranks
raise by name in the ``Client`` facade, so the adapter has no round
broadcast to its slaves (``announce_round``/``announce_finish``).  Each
silo's local pass runs on ``device`` (the card unless the CPU is asked
for), and the trained params go back to the host for the message, as
``jax.device_get`` hands numpy arrays to the JAX message.

``ClientMasterManager.timings`` records, per round, the seconds of the
local pass (from the model's arrival to the params on the host) and the
seconds from the upload to the next model sync (or the finish), for the
round split that ``chip_smoke.py`` prints.
"""

from __future__ import annotations

import logging
import time

import torch

from ...core import rng as rng_util
from ...core.distributed.communication.message import Message, to_host
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.security.fedml_attacker import FedMLAttacker
from ...core.wire import tensor_tree
from ...ml.trainer.local_trainer import LocalTrainer, ServerCtx
from ..message_define import MyMessage

log = logging.getLogger(__name__)


class ClientMasterManager(FedMLCommManager):
    def __init__(self, args, trainer_adapter, comm=None, rank=0, size=0,
                 backend="local"):
        super().__init__(args, comm, rank, size, backend)
        self.trainer_adapter = trainer_adapter
        self.num_rounds = int(getattr(args, "comm_round", 10))
        #: per round: {"round", "local_pass_s", "upload_to_sync_s"}
        self.timings = []
        self._uploaded_at = None

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(
            Message.MSG_TYPE_CONNECTION_IS_READY, self.handle_connection_ready)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.handle_message_init)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
            self.handle_message_receive_model_from_server)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_FINISH, self.handle_message_finish)

    def handle_connection_ready(self, msg_params):
        msg = Message(MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.rank, 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_STATUS,
                       MyMessage.MSG_CLIENT_STATUS_ONLINE)
        self.send_message(msg)

    def _mark_sync(self):
        if self._uploaded_at is not None and self.timings:
            self.timings[-1]["upload_to_sync_s"] = \
                time.perf_counter() - self._uploaded_at
            self._uploaded_at = None

    def _train_and_send(self, msg_params):
        t0 = time.perf_counter()
        self._mark_sync()
        # require(): a model sync missing its payload raises a KeyError
        # naming the msg_type and sender instead of training on None
        params = msg_params.require(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        data_idx = int(msg_params.require(MyMessage.MSG_ARG_KEY_CLIENT_INDEX))
        round_idx = int(msg_params.get(MyMessage.MSG_ARG_KEY_ROUND_IDX, 0))
        new_params, n = self.trainer_adapter.train(params, data_idx, round_idx)
        self.timings.append({"round": round_idx,
                             "local_pass_s": time.perf_counter() - t0,
                             "upload_to_sync_s": None})
        msg = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, new_params)
        msg.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, float(n))
        msg.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, round_idx)
        self.send_message(msg)
        self._uploaded_at = time.perf_counter()

    def handle_message_init(self, msg_params):
        self._train_and_send(msg_params)

    def handle_message_receive_model_from_server(self, msg_params):
        self._train_and_send(msg_params)

    def handle_message_finish(self, msg_params):
        self._mark_sync()
        self.finish()


class TrainerDistAdapter:
    """Binds the port's ``LocalTrainer`` to this silo's data and runs its
    local pass (``make_local_train``) on ``device``: the client's batches
    from ``dataset.client_batches`` and, for a model with dropout, keep
    masks drawn from ``core/rng.client_key(seed, round, client)`` on the
    host generator and moved to the device, so a silo's pass draws the
    same masks on the card and on the CPU."""

    def __init__(self, args, model, dataset, device=None):
        from ...device import get_device

        self.args = args
        self.model = model
        self.dataset = dataset
        self.device = get_device(args, device)
        self.trainer = LocalTrainer(model, args)
        # red-team wiring: an edge-case backdoor attacker gets the
        # dataset's edge-example pool (if any) at startup
        FedMLAttacker.get_instance().provide_edge_pool(dataset)
        self.local_train = self.trainer.make_local_train()
        self.order = [n for n, _ in model.module.named_parameters()]
        self.seed = int(getattr(args, "random_seed", 0))
        self.batch_size = int(getattr(args, "batch_size", 10))
        self.epochs = int(getattr(args, "epochs", 1))
        #: a user ClientTrainer given to the Client facade; stored, and
        #: not called, as in the JAX package
        self.user_trainer = None

    def train(self, global_params, data_idx: int, round_idx: int):
        global_params = tensor_tree(global_params, self.device, self.order)
        xb, yb = self.dataset.client_batches(
            data_idx, self.batch_size, self.seed, round_idx, self.epochs)
        steps = xb.shape[0]
        xb = torch.as_tensor(xb, device=self.device)
        yb = torch.as_tensor(yb, device=self.device)
        mask = torch.ones((steps,), dtype=torch.float32, device=self.device)
        drop = None
        if self.model.has_dropout:
            gen = rng_util.client_key(rng_util.root_key(self.seed),
                                      round_idx, data_idx)
            drop = tuple(d.to(self.device) for d in self.model.dropout_masks(
                gen, (steps, self.batch_size)))
        ctx = ServerCtx(global_params=global_params)
        out = self.local_train(global_params, xb, yb, mask, drop, ctx, None)
        n = len(self.dataset.client_idxs[data_idx])
        return to_host(out["params"]), n
