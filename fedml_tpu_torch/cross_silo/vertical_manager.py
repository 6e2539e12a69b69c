"""Cross-silo vertical FL (port of ``fedml_tpu.cross_silo.vertical_manager``):
split learning across real parties over the message plane.

The guest (rank 0: the labels and its feature slice) and the host parties
(ranks ≥ 1: feature slices only) exchange activations and logit gradients;
raw features and labels never leave their owners.  Per batch the guest
announces the batch (the host stream ``hostrng.gen(seed, 0x7F1, round)``'s
permutation, as in the sp engine), the hosts forward their towers and
upload partial logits, the guest sums them, takes the softmax
cross-entropy's gradient and broadcasts it, and every party updates its
own tower (``simulation/sp/vertical_fl.py::VerticalPartyModel``).  A
party's tower lives on ``device`` (the card unless the CPU is asked for);
activations and gradients arriving as host arrays go there.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict

import numpy as np
import torch

from ..core import hostrng, rng as rng_util
from ..core.distributed.communication.message import Message
from ..core.distributed.fedml_comm_manager import FedMLCommManager
from ..core.wire import tensor_tree
from ..simulation.sp.vertical_fl import VerticalFLAPI, VerticalPartyModel

log = logging.getLogger(__name__)

MSG_BATCH = 701          # guest -> hosts: round + batch index list
MSG_PARTIAL = 702        # host -> guest: partial logits
MSG_GRAD = 703           # guest -> hosts: d loss / d logits
MSG_DONE = 704

ARG_ROUND = "vfl_round"
ARG_BATCH = "vfl_batch_idx"
ARG_LOGITS = "vfl_partial_logits"
ARG_GRAD = "vfl_glogit"


def _party(args, features, rows, num_classes, tag, device):
    """A party's features on ``device`` and its tower, seeded by
    ``purpose_key(root_key(seed), tag)``."""
    x = torch.as_tensor(np.asarray(features, np.float32).reshape(rows, -1),
                        device=device)
    key = rng_util.purpose_key(rng_util.root_key(
        int(getattr(args, "random_seed", 0)), device), tag)
    return x, VerticalPartyModel(x.shape[1], int(num_classes),
                                 float(getattr(args, "learning_rate", 0.1)),
                                 key)


class VflGuestManager(FedMLCommManager):
    """Rank 0: the label owner and aggregator."""

    def __init__(self, args, features: np.ndarray, labels: np.ndarray,
                 num_classes: int, comm=None, size: int = 0,
                 backend: str = "local", device=None):
        from ..device import get_device

        super().__init__(args, comm, 0, size, backend)
        self.device = get_device(args, device)
        self.y = torch.as_tensor(np.asarray(labels), device=self.device)
        self.x, self.model = _party(args, features, len(labels),
                                    num_classes, "vfl0", self.device)
        self.num_classes = int(num_classes)
        self.batch_size = int(getattr(args, "batch_size", 64))
        self.rounds = int(getattr(args, "comm_round", 5))
        self.seed = int(getattr(args, "random_seed", 0))
        self.losses = []
        self._round = 0
        self._batch_i = 0
        self._order = None
        self._partials: Dict[int, torch.Tensor] = {}
        self._cur_idx = None
        self._lock = threading.Lock()

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(
            Message.MSG_TYPE_CONNECTION_IS_READY, self._on_ready)
        self.register_message_receive_handler(MSG_PARTIAL, self._on_partial)

    def _on_ready(self, _msg):
        self._announce_batch()

    def _announce_batch(self):
        n = len(self.y)
        if self._order is None or self._batch_i + self.batch_size > n:
            if self._order is not None:
                self._round += 1
                if self._round >= self.rounds:
                    for rank in range(1, self.size):
                        self.send_message(Message(MSG_DONE, 0, rank))
                    self.finish()
                    return
            self._order = hostrng.gen(self.seed, 0x7F1,
                                      self._round).permutation(n)
            self._batch_i = 0
        idx = self._order[self._batch_i: self._batch_i + self.batch_size]
        self._batch_i += self.batch_size
        self._cur_idx = torch.as_tensor(idx, device=self.device)
        self._partials = {}
        for rank in range(1, self.size):
            msg = Message(MSG_BATCH, 0, rank)
            msg.add_params(ARG_ROUND, self._round)
            msg.add_params(ARG_BATCH, np.asarray(idx, np.int64))
            self.send_message(msg)

    def _on_partial(self, msg):
        sender = msg.get_sender_id()
        with self._lock:
            self._partials[sender] = tensor_tree(msg.get(ARG_LOGITS),
                                                 self.device)
            if len(self._partials) < self.size - 1:
                return
            partials = [self._partials[r] for r in sorted(self._partials)]
        x = self.x[self._cur_idx]
        logits = self.model.forward(x) + sum(partials)
        loss, glogit = VerticalFLAPI.guest_grad(logits,
                                                self.y[self._cur_idx])
        self.losses.append(float(loss))
        self.model.backward(x, glogit)
        for rank in range(1, self.size):
            out = Message(MSG_GRAD, 0, rank)
            out.add_params(ARG_GRAD, glogit)
            self.send_message(out)
        self._announce_batch()


class VflHostManager(FedMLCommManager):
    """Rank ≥ 1: a feature-slice owner; it never sees a label."""

    def __init__(self, args, features: np.ndarray, num_classes: int,
                 comm=None, rank: int = 1, size: int = 0,
                 backend: str = "local", device=None):
        from ..device import get_device

        super().__init__(args, comm, rank, size, backend)
        self.device = get_device(args, device)
        self.x, self.model = _party(args, features, features.shape[0],
                                    num_classes, f"vfl{rank}", self.device)
        self._cur_idx = None

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_BATCH, self._on_batch)
        self.register_message_receive_handler(MSG_GRAD, self._on_grad)
        self.register_message_receive_handler(MSG_DONE,
                                              lambda m: self.finish())

    def _on_batch(self, msg):
        self._cur_idx = torch.as_tensor(
            np.asarray(msg.get(ARG_BATCH), np.int64), device=self.device)
        out = Message(MSG_PARTIAL, self.rank, 0)
        out.add_params(ARG_LOGITS, self.model.forward(self.x[self._cur_idx]))
        self.send_message(out)

    def _on_grad(self, msg):
        glogit = tensor_tree(msg.get(ARG_GRAD), self.device)
        self.model.backward(self.x[self._cur_idx], glogit)


__all__ = ["VflGuestManager", "VflHostManager"]
