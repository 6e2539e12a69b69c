"""Vertical-FL party models (port of ``fedml_tpu.models.vfl``): the
reference's ``DenseModel``/``LocalModel`` with the explicit
``forward(x)``/``backward(x, grads)`` surface of its split protocol.

``forward`` runs the party's sub-model to the activation it sends up;
``backward`` pushes the upstream gradient back through it by one
``torch.func.vjp``, applies the party's own SGD (momentum 0.9, weight
decay 0.01) and returns ``dL/dx`` for the party below.  Both take and
return host numpy arrays, since they cross a party boundary.  Weights are
U(−1/√in, 1/√in) kernels from ``torch.Generator`` seeded by ``seed`` and
zero biases.  Runs on the card unless ``device`` asks for the CPU."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import rng as rng_util
from ..core.state import ClientOptimizer
from ..device import get_device


class _SplitPartyModule:
    """Holds params + optimizer and exposes the forward/backward split."""

    def __init__(self, in_dim: int, out_dim: int, learning_rate: float,
                 seed: int = 0, bias: bool = True, device=None):
        self.device = get_device(None, device)
        self.in_dim = int(in_dim)
        self.output_dim = int(out_dim)
        scale = 1.0 / math.sqrt(in_dim)
        g = rng_util.root_key(seed, self.device)
        u = torch.rand((in_dim, out_dim), generator=g, device=self.device)
        self.params = {"kernel": (2 * u - 1) * scale}
        if bias:
            self.params["bias"] = torch.zeros((out_dim,), device=self.device)
        self.tx = ClientOptimizer("sgd", float(learning_rate), momentum=0.9,
                                  weight_decay=0.01)
        self.opt_state = self.tx.init(self.params)

    def _apply(self, params, x):
        raise NotImplementedError

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    @torch.no_grad()
    def forward(self, x):
        """The activation for the upstream party, as host numpy."""
        return self._apply(self.params, self._tensor(x)).cpu().numpy()

    def backward(self, x, grads):
        """Applies the local update and returns dL/dx (host numpy) for the
        party below."""
        _, vjp = torch.func.vjp(self._apply, self.params, self._tensor(x))
        pgrads, xgrad = vjp(self._tensor(grads))
        upd, self.opt_state = self.tx.update(pgrads, self.opt_state,
                                             self.params)
        self.params = {k: v + upd[k] for k, v in self.params.items()}
        return xgrad.cpu().numpy()


class VFLClassifier(_SplitPartyModule):
    """The guest's top model: one linear layer over the concatenated party
    activations."""

    def _apply(self, params, x):
        y = x @ params["kernel"]
        return y + params["bias"] if "bias" in params else y


class VFLFeatureExtractor(_SplitPartyModule):
    """A host's bottom model: linear + LeakyReLU (slope 0.01)."""

    def _apply(self, params, x):
        y = x @ params["kernel"]
        if "bias" in params:
            y = y + params["bias"]
        return F.leaky_relu(y, 0.01)

    def get_output_dim(self) -> int:
        return self.output_dim


# the reference's vfl_models_standalone.py names
DenseModel = VFLClassifier
LocalModel = VFLFeatureExtractor
