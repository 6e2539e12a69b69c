"""FedGKT — group knowledge transfer (port of
``fedml_tpu.simulation.sp.fedgkt``): every client trains a small
extractor + head on its data with cross-entropy and a KL term towards the
server's logits, uploads its features, labels and logits, and the server
trains a larger head on that feature bank with cross-entropy and a KL term
towards the clients' logits, then returns per-client server logits.

Every client trains every round; its (extractor, head) parameters are kept
per client.  Client SGD (momentum 0.9) starts fresh each round; the
server's Adam (1e-3) state is kept across rounds.  A step's KD term is
switched by ``has`` (0 until the client has server logits).  As in the JAX
engine, a client's server logits come from LAST round's batch order but
are applied to this round's batches.  The loops run eagerly on the
engine's device; runs on the card unless ``device`` (or ``args.device``)
asks for the CPU."""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core import rng as rng_util
from ...core.state import ClientOptimizer
from ...device import get_device
from ...ml.trainer.local_trainer import cross_entropy_loss
from ...models.base import TorchModel
from ...models.resnet import GN_EPS, ConvSame

log = logging.getLogger(__name__)


class ClientExtractor(nn.Module):
    """Small on-device net: conv stem → feature vector (NHWC input)."""

    def __init__(self, in_channels: int = 3, feature_dim: int = 64):
        super().__init__()
        self.Conv_0 = ConvSame(in_channels, 16, 3)
        self.GroupNorm_0 = nn.GroupNorm(8, 16, eps=GN_EPS)
        self.Conv_1 = ConvSame(16, 32, 3)
        self.GroupNorm_1 = nn.GroupNorm(8, 32, eps=GN_EPS)
        self.Dense_0 = nn.Linear(32, feature_dim)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous()
        x = F.max_pool2d(F.relu(self.GroupNorm_0(self.Conv_0(x))), 2)
        x = F.relu(self.GroupNorm_1(self.Conv_1(x)))
        return self.Dense_0(x.mean(dim=(2, 3)))


class ClientHead(nn.Module):
    def __init__(self, num_classes: int = 10, feature_dim: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(feature_dim, num_classes)

    def forward(self, f: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        return self.Dense_0(F.relu(f))


class ServerHead(nn.Module):
    """The large server-side net on extracted features."""

    def __init__(self, num_classes: int = 10, width: int = 256,
                 depth: int = 3, feature_dim: int = 64):
        super().__init__()
        self.depth = depth
        dims = [feature_dim] + [width] * depth
        for i in range(depth):
            setattr(self, f"Dense_{i}", nn.Linear(dims[i], width))
        setattr(self, f"Dense_{depth}", nn.Linear(dims[-1], num_classes))

    def forward(self, f: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        for i in range(self.depth):
            f = F.relu(getattr(self, f"Dense_{i}")(f))
        return getattr(self, f"Dense_{self.depth}")(f)


def _kl_to(teacher_logits, student_logits, T: float = 1.0):
    """Mean over rows of KL(softmax(teacher/T) ‖ softmax(student/T))."""
    pt = torch.softmax(teacher_logits / T, dim=-1)
    ls = F.log_softmax(student_logits / T, dim=-1)
    lt = F.log_softmax(teacher_logits / T, dim=-1)
    return torch.mean(torch.sum(pt * (lt - ls), dim=-1))


class FedGKTAPI:
    def __init__(self, args, dataset, device=None):
        self.args = args
        self.dataset = dataset
        self.device = get_device(args, device)
        nc = dataset.num_classes
        with torch.device("meta"):
            self.extractor = TorchModel(
                ClientExtractor(dataset.train_x.shape[-1]),
                tuple(dataset.train_x.shape[1:]))
            self.c_head = TorchModel(ClientHead(nc), (64,))
            self.s_head = TorchModel(ServerHead(nc), (64,))
        self.rounds = int(getattr(args, "comm_round", 3))
        self.batch_size = int(getattr(args, "batch_size", 32))
        self.seed = int(getattr(args, "random_seed", 0))
        self.alpha_kd = float(getattr(args, "gkt_kd_weight", 1.0))
        self.tx_c = ClientOptimizer("sgd", float(getattr(args,
                                                         "learning_rate",
                                                         0.03)),
                                    momentum=0.9)
        self.tx_s = ClientOptimizer("adam", 1e-3)
        root = rng_util.root_key(self.seed, self.device)
        #: per-client (extractor, head) params
        self.c_params: Dict[int, tuple] = {}
        self._init_e = self.extractor.init(rng_util.purpose_key(root, "e"))
        self._init_h = self.c_head.init(rng_util.purpose_key(root, "h"))
        self.s_params = self.s_head.init(rng_util.purpose_key(root, "s"))
        self.opt_s = self.tx_s.init(self.s_params)

    # -- the client ----------------------------------------------------------
    def _client_loss(self, e_p, h_p, x, y, sl, has):
        logits = self.c_head.apply(h_p, self.extractor.apply(e_p, x))
        kd = _kl_to(sl, logits) * has
        return cross_entropy_loss(logits, y) + self.alpha_kd * kd

    def client_train(self, params, batches, server_logits):
        """One client's steps: ``params`` (extractor, head), ``batches``
        (x (steps, B, ...), y (steps, B)), ``server_logits`` (logits
        (steps, B, classes), has (steps,)): ``(params, per-step losses)``."""
        e_p, h_p = params
        opt_e, opt_h = self.tx_c.init(e_p), self.tx_c.init(h_p)
        losses = []
        for x, y, sl, has in zip(*batches, *server_logits):
            (ge, gh), loss = torch.func.grad_and_value(
                self._client_loss, argnums=(0, 1))(e_p, h_p, x, y, sl, has)
            ue, opt_e = self.tx_c.update(ge, opt_e, e_p)
            uh, opt_h = self.tx_c.update(gh, opt_h, h_p)
            e_p = {k: v + ue[k] for k, v in e_p.items()}
            h_p = {k: v + uh[k] for k, v in h_p.items()}
            losses.append(loss)
        return (e_p, h_p), torch.stack(losses)

    @torch.no_grad()
    def client_extract(self, e_params, h_params, x):
        f = self.extractor.apply(e_params, x)
        return f, self.c_head.apply(h_params, f)

    # -- the server ----------------------------------------------------------
    def _server_loss(self, p, f, y, cl):
        logits = self.s_head.apply(p, f)
        return cross_entropy_loss(logits, y) + self.alpha_kd * _kl_to(cl,
                                                                      logits)

    def server_train(self, s_params, opt_s, feats, labels, c_logits):
        """The server head's steps over one client's bank, each
        ``(steps, B, ...)``: ``(params, Adam state, per-step losses)``."""
        losses = []
        for f, y, cl in zip(feats, labels, c_logits):
            g, loss = torch.func.grad_and_value(self._server_loss)(
                s_params, f, y, cl)
            upd, opt_s = self.tx_s.update(g, opt_s, s_params)
            s_params = {k: v + upd[k] for k, v in s_params.items()}
            losses.append(loss)
        return s_params, opt_s, torch.stack(losses)

    @torch.no_grad()
    def server_logits(self, s_params, f):
        return self.s_head.apply(s_params, f)

    def _batches(self, c: int, r: int):
        idx = np.asarray(self.dataset.client_idxs[c])
        rng = np.random.default_rng(self.seed * 104729 + r * 13 + c)
        perm = rng.permutation(len(idx))
        bs = min(self.batch_size, len(idx))
        steps = max(1, len(idx) // bs)
        t = idx[perm[:steps * bs]]
        x = self.dataset.train_x[t].reshape(
            (steps, bs) + self.dataset.train_x.shape[1:])
        y = self.dataset.train_y[t].reshape((steps, bs))
        return (torch.as_tensor(x, device=self.device),
                torch.as_tensor(y, device=self.device))

    def train(self) -> dict:
        nc = self.dataset.num_classes
        n = self.dataset.num_clients
        server_logits: Dict[int, torch.Tensor] = {}
        history = []
        for r in range(self.rounds):
            banks, c_last = [], []
            for c in range(n):
                if c not in self.c_params:
                    self.c_params[c] = (self._init_e, self._init_h)
                xb, yb = self._batches(c, r)
                steps, bs = xb.shape[:2]
                if c in server_logits:
                    sl = server_logits[c][:steps * bs].reshape(steps, bs, nc)
                    has = torch.ones((steps,), device=self.device)
                else:
                    sl = torch.zeros((steps, bs, nc), device=self.device)
                    has = torch.zeros((steps,), device=self.device)
                self.c_params[c], ls = self.client_train(
                    self.c_params[c], (xb, yb), (sl, has))
                c_last.append(ls[-1])
                f, cl = self.client_extract(*self.c_params[c],
                                            xb.reshape((-1,) + xb.shape[2:]))
                banks.append((f.reshape(steps, bs, -1), yb,
                              cl.reshape(steps, bs, nc)))
            # the server: one pass over every client's uploaded bank
            s_last = []
            for c, (f, y, cl) in enumerate(banks):
                self.s_params, self.opt_s, ls = self.server_train(
                    self.s_params, self.opt_s, f, y, cl)
                s_last.append(ls[-1])
                server_logits[c] = self.server_logits(
                    self.s_params, f.reshape((-1, f.shape[-1])))
            history.append({"round": r,
                            "client_loss": sum(torch.stack(c_last).tolist())
                            / n,
                            "server_loss": sum(torch.stack(s_last).tolist())
                            / n})
            log.info("fedgkt round %d: client_loss=%.4f server_loss=%.4f",
                     r, history[-1]["client_loss"],
                     history[-1]["server_loss"])
        return {"history": history}

    @torch.no_grad()
    def evaluate(self) -> float:
        """End-to-end accuracy: client 0's extractor → the server head."""
        e_p, _ = self.c_params[0]
        xb, yb, mask = self.dataset.test_batches(256)
        correct = torch.zeros((), device=self.device)
        for x, y, m in zip(xb, yb, mask):
            x, y, m = (torch.as_tensor(a, device=self.device)
                       for a in (x, y, m))
            logits = self.server_logits(self.s_params,
                                        self.extractor.apply(e_p, x))
            correct = correct + torch.sum((torch.argmax(logits, -1) == y) * m)
        return float(correct) / max(float(np.sum(mask)), 1.0)
