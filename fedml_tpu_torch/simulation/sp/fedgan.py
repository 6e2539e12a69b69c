"""Federated GAN training (port of ``fedml_tpu.simulation.sp.fedgan``):
clients train a local generator/discriminator pair on their private
images, and the server averages both networks by sample count.

Each batch takes one discriminator step against a detached fake, then one
generator step against the updated discriminator, with the non-saturating
sigmoid-BCE loss on logits; each network has its own Adam (b1 0.5), fresh
for every client.  The local loop runs eagerly on the engine's device.

The latent noise is an input of :meth:`FedGANAPI.client_train`: a
``(steps, 2, B, latent)`` tensor whose ``[:, 0]`` feeds the D steps and
``[:, 1]`` the G steps.  The engine draws it from its own
``torch.Generator`` (seeded with ``random_seed + 7``, as the JAX engine's
root key), in :meth:`client_noise`, one client after another; the draws are
torch's, not threefry's.  Runs on the card unless ``device`` (or
``args.device``) asks for the CPU."""

from __future__ import annotations

import logging
from typing import List

import numpy as np
import torch

from ...core import rng as rng_util
from ...core.state import ClientOptimizer
from ...core.tree import weighted_average
from ...device import get_device
from ...models.base import TorchModel
from ...models.gan import Discriminator, Generator

log = logging.getLogger(__name__)


def _bce_logits(logits, target: float):
    """Mean sigmoid BCE: softplus(logits) − target·logits."""
    return torch.mean(torch.logaddexp(logits, torch.zeros_like(logits))
                      - target * logits)


class FedGANAPI:
    def __init__(self, args, images: np.ndarray, client_idxs: List[np.ndarray],
                 generator: Generator = None,
                 discriminator: Discriminator = None, device=None):
        """``images``: (N, H, W, C) in the dataset's layout;
        ``client_idxs``: each client's rows; ``generator`` and
        ``discriminator``: the nets, by default ``Generator`` and
        ``Discriminator`` sized to the images."""
        self.args = args
        self.device = get_device(args, device)
        self.images = np.asarray(images, np.float32)
        self.client_idxs = client_idxs
        hw, ch = self.images.shape[1], self.images.shape[-1]
        with torch.device("meta"):
            gen = generator or Generator(out_hw=hw, out_channels=ch)
            disc = discriminator or Discriminator(in_hw=hw, in_channels=ch)
        self.latent_dim = gen.latent_dim
        self.gen = TorchModel(gen, (self.latent_dim,))
        self.disc = TorchModel(disc, tuple(self.images.shape[1:]))
        self.batch_size = int(getattr(args, "batch_size", 32))
        self.rounds = int(getattr(args, "comm_round", 5))
        self.clients_per_round = int(getattr(args, "client_num_per_round",
                                             min(4, len(client_idxs))))
        self.seed = int(getattr(args, "random_seed", 0))
        lr = float(getattr(args, "learning_rate", 2e-4))
        self.tx_g = ClientOptimizer("adam", lr, b1=0.5)
        self.tx_d = ClientOptimizer("adam", lr, b1=0.5)
        root = rng_util.root_key(self.seed, self.device)
        self.g_params = self.gen.init(rng_util.purpose_key(root, "g"))
        self.d_params = self.disc.init(rng_util.purpose_key(root, "d"))
        self._z_gen = rng_util.root_key(self.seed + 7, self.device)

    def _d_loss(self, d_p, g_p, xb, z):
        fake = self.gen.apply(g_p, z).detach()
        return (_bce_logits(self.disc.apply(d_p, xb), 1.0)
                + _bce_logits(self.disc.apply(d_p, fake), 0.0))

    def _g_loss(self, g_p, d_p, z):
        return _bce_logits(self.disc.apply(d_p, self.gen.apply(g_p, z)), 1.0)

    def client_train(self, g_params, d_params, batches, z):
        """One client's steps over real ``batches`` (steps, B, H, W, C) with
        latent noise ``z`` (steps, 2, B, latent): ``(g_params, d_params,
        (D losses, G losses))``."""
        opt_g, opt_d = self.tx_g.init(g_params), self.tx_d.init(d_params)
        dls, gls = [], []
        for s in range(batches.shape[0]):
            gd, dl = torch.func.grad_and_value(self._d_loss)(
                d_params, g_params, batches[s], z[s, 0])
            upd, opt_d = self.tx_d.update(gd, opt_d, d_params)
            d_params = {k: v + upd[k] for k, v in d_params.items()}
            gg, gl = torch.func.grad_and_value(self._g_loss)(
                g_params, d_params, z[s, 1])
            upd, opt_g = self.tx_g.update(gg, opt_g, g_params)
            g_params = {k: v + upd[k] for k, v in g_params.items()}
            dls.append(dl)
            gls.append(gl)
        return g_params, d_params, (torch.stack(dls), torch.stack(gls))

    def client_noise(self, steps: int, batch: int) -> torch.Tensor:
        """The next client's ``(steps, 2, batch, latent)`` noise."""
        return torch.randn((steps, 2, batch, self.latent_dim),
                           generator=self._z_gen, device=self.device)

    def _client_batches(self, c: int, round_idx: int) -> np.ndarray:
        idx = np.asarray(self.client_idxs[c])
        rng = np.random.default_rng(self.seed * 1000003 + round_idx * 101 + c)
        perm = rng.permutation(len(idx))
        steps = max(1, len(idx) // self.batch_size)
        take = idx[perm[:steps * self.batch_size]]
        return self.images[take].reshape((steps, self.batch_size) +
                                         self.images.shape[1:])

    def train(self) -> dict:
        history = []
        for r in range(self.rounds):
            rng = np.random.default_rng(self.seed + r)
            cohort = rng.choice(len(self.client_idxs),
                                size=min(self.clients_per_round,
                                         len(self.client_idxs)),
                                replace=False)
            g_locals, d_locals, ws, last = [], [], [], []
            for c in cohort:
                batches = torch.as_tensor(self._client_batches(int(c), r),
                                          device=self.device)
                z = self.client_noise(batches.shape[0], batches.shape[1])
                g_p, d_p, (dl, gl) = self.client_train(
                    self.g_params, self.d_params, batches, z)
                g_locals.append(g_p)
                d_locals.append(d_p)
                ws.append(float(len(self.client_idxs[int(c)])))
                last.append(torch.stack([dl[-1], gl[-1]]))
            self.g_params = weighted_average(g_locals, ws)
            self.d_params = weighted_average(d_locals, ws)
            d_loss, g_loss = (sum(col) for col in
                              zip(*torch.stack(last).tolist()))
            history.append({"round": r, "d_loss": d_loss / len(cohort),
                            "g_loss": g_loss / len(cohort)})
            log.info("fedgan round %d: d_loss=%.4f g_loss=%.4f", r,
                     history[-1]["d_loss"], history[-1]["g_loss"])
        return {"history": history, "g_params": self.g_params,
                "d_params": self.d_params}

    @torch.no_grad()
    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` images from the global generator, (n, H, W, C) in
        [−1, 1], from latent noise seeded by ``seed``."""
        z = torch.randn((n, self.latent_dim),
                        generator=rng_util.root_key(seed, self.device),
                        device=self.device)
        return self.gen.apply(self.g_params, z).cpu().numpy()
