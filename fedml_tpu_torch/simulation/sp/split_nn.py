"""Split learning (port of ``fedml_tpu.simulation.sp.split_nn``): the model
is cut at a layer; the client owns the bottom, the server the top.  Per
batch the client sends the cut-layer activations up, the server runs its
forward and backward and returns the activation gradient, and the client
finishes its backward by a VJP.

The three stages stay separate functions, each with its own SGD, so the
protocol boundary is explicit.  ``fuse`` is accepted and unused, as in the
JAX class.  Runs on the card unless ``device`` (or ``args.device``) asks
for the CPU."""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from ...core import rng as rng_util
from ...core.state import ClientOptimizer
from ...device import get_device
from ...ml.trainer.local_trainer import cross_entropy_loss
from ...models.base import TorchModel


class SplitNNAPI:
    def __init__(self, args, dataset, client_module: nn.Module,
                 server_module: nn.Module, fuse: bool = False, device=None):
        """``client_module`` maps a batch in the dataset's layout to the
        cut-layer activations, ``server_module`` those to logits; both run
        through ``functional_call``, and their parameters are initialised
        here (flax's initialisers, by flax name:
        :meth:`TorchModel.init`)."""
        self.args = args
        self.dataset = dataset
        self.device = get_device(args, device)
        self.client_module, self.server_module = client_module, server_module
        self.seed = int(getattr(args, "random_seed", 0))
        self.batch_size = int(getattr(args, "batch_size", 32))
        self.epochs = int(getattr(args, "epochs", 1))
        self.comm_rounds = int(getattr(args, "comm_round", 5))
        self.tx = ClientOptimizer("sgd",
                                  float(getattr(args, "learning_rate", 0.05)))
        root = rng_util.root_key(self.seed, self.device)
        self.client_params = TorchModel(client_module, ()).init(
            rng_util.purpose_key(root, "client"))
        self.server_params = TorchModel(server_module, ()).init(
            rng_util.purpose_key(root, "server"))
        self.opt_c = self.tx.init(self.client_params)
        self.opt_s = self.tx.init(self.server_params)

    # -- the protocol's stages (the wire crosses between them) ---------------
    @torch.no_grad()
    def client_forward(self, params_c, x):
        return functional_call(self.client_module, params_c, (x,))

    def server_step(self, params_s, opt_s, h, y):
        """The server's forward and backward on activations ``h``:
        ``(loss, params, optimizer state, dL/dh)``."""
        def loss_fn(p, hh):
            return cross_entropy_loss(
                functional_call(self.server_module, p, (hh,)), y)

        (gs, gh), loss = torch.func.grad_and_value(loss_fn, argnums=(0, 1))(
            params_s, h)
        upd, opt_s = self.tx.update(gs, opt_s, params_s)
        return loss, {k: v + upd[k] for k, v in params_s.items()}, opt_s, gh

    def client_backward(self, params_c, opt_c, x, gh):
        """The client's backward from the returned gradient: ``(params,
        optimizer state)``."""
        _, vjp = torch.func.vjp(
            lambda p: functional_call(self.client_module, p, (x,)), params_c)
        (gc,) = vjp(gh)
        upd, opt_c = self.tx.update(gc, opt_c, params_c)
        return {k: v + upd[k] for k, v in params_c.items()}, opt_c

    def train_step(self, x, y):
        """One batch through the three stages; returns the loss tensor."""
        h = self.client_forward(self.client_params, x)              # wire ↑
        loss, self.server_params, self.opt_s, gh = self.server_step(
            self.server_params, self.opt_s, h, y)
        self.client_params, self.opt_c = self.client_backward(      # wire ↓
            self.client_params, self.opt_c, x, gh)
        return loss

    def train(self):
        """``comm_round`` passes over client 0's batches: the per-step
        losses."""
        losses = []
        for r in range(self.comm_rounds):
            xb, yb = self.dataset.client_batches(
                0, self.batch_size, self.seed, r, self.epochs)
            xb, yb = (torch.as_tensor(a, device=self.device)
                      for a in (xb, yb))
            for s in range(xb.shape[0]):
                losses.append(self.train_step(xb[s], yb[s]))
        return torch.stack(losses).tolist() if losses else []

    @torch.no_grad()
    def evaluate(self):
        xb, yb, mb = self.dataset.test_batches()
        correct = torch.zeros((), device=self.device)
        for x, y, m in zip(xb, yb, mb):
            x, y, m = (torch.as_tensor(a, device=self.device)
                       for a in (x, y, m))
            logits = functional_call(
                self.server_module, self.server_params,
                (self.client_forward(self.client_params, x),))
            correct = correct + torch.sum((torch.argmax(logits, -1) == y) * m)
        return float(correct) / float(mb.sum())
