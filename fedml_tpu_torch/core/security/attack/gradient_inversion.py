"""Gradient-inversion (data reconstruction) attacks (port of
``fedml_tpu.core.security.attack.gradient_inversion``): DLG (optimize
dummy ``(x, y)`` until its gradient matches the victim's), inverting
gradients (the cosine-similarity match of Geiping et al.) and revealing
labels (the classes whose output-bias gradient is negative).

The JAX attacks run ``jax.grad`` inside an optax Adam ``fori_loop``; the
port takes ``torch.autograd.grad`` of the match loss through the caller's
``grad_fn`` (itself a ``create_graph`` gradient, e.g.
:func:`classifier_grad_fn` over ``torch.func.functional_call``) and steps
its own functional Adam, optax's arithmetic.  The dummy data's initial
draws come from the ``dlg`` generator on the params' device
(:mod:`fedml_tpu_torch.core.noise`).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ... import noise
from ...tree import tree_dot, tree_sq_norm, tree_sub
from ..defense.common import layout_of

#: optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def classifier_grad_fn(model) -> Callable:
    """``grad_fn(params, x, y_soft)`` of a classifier ``TorchModel``: the
    gradient of the soft-label cross entropy over the params (the model's
    ``functional_call`` forward), built with ``create_graph`` so a match
    loss differentiates through it to ``x`` and ``y``."""

    def grad_fn(params: Dict[str, torch.Tensor], x, y_soft):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits = model.apply(p, x)
        loss = -torch.mean(torch.sum(
            y_soft * torch.log_softmax(logits, dim=-1), dim=-1))
        grads = torch.autograd.grad(loss, list(p.values()),
                                    create_graph=True)
        return dict(zip(p, grads))

    return grad_fn


class _GradientMatcherBase:
    """Given the victim's gradient and a ``grad_fn(params, x, y) -> grads``,
    optimize dummy data to match."""

    def __init__(self, args):
        self.args = args
        self.iters = int(getattr(args, "attack_iters", 300))
        self.lr = float(getattr(args, "attack_lr", 0.1))
        self._noise = noise.NoiseSource(
            "dlg", int(getattr(args, "random_seed", 0)))

    def _match_loss(self, g_dummy, g_victim):
        raise NotImplementedError

    def reconstruct_data(self, a_gradient, extra_auxiliary_info=None):
        """``extra_auxiliary_info = (grad_fn, params, x_shape,
        y_onehot_shape)``; returns ``(x_hat, y_hat_logits)``."""
        grad_fn, params, x_shape, y_shape = extra_auxiliary_info
        dev = next(iter(params.values())).device
        xy = [noise.draw(self._noise, x_shape, dev) * 0.1,
              noise.draw(self._noise, y_shape, dev) * 0.1]
        mu = [torch.zeros_like(t) for t in xy]
        nu = [torch.zeros_like(t) for t in xy]
        for step in range(1, self.iters + 1):
            leaves = [t.detach().requires_grad_(True) for t in xy]
            g = grad_fn(params, leaves[0], torch.softmax(leaves[1], dim=-1))
            loss = self._match_loss(g, a_gradient)
            grads = torch.autograd.grad(loss, leaves)
            c1 = 1.0 - torch.tensor(_B1, dtype=torch.float32) ** step
            c2 = 1.0 - torch.tensor(_B2, dtype=torch.float32) ** step
            for i, gi in enumerate(grads):
                mu[i] = (1 - _B1) * gi + _B1 * mu[i]
                nu[i] = (1 - _B2) * (gi * gi) + _B2 * nu[i]
                upd = (mu[i] / c1.item()) / (
                    torch.sqrt(nu[i] / c2.item()) + _EPS)
                xy[i] = xy[i] - self.lr * upd
        return xy[0], xy[1]


class DLGAttack(_GradientMatcherBase):
    """DLG: the L2 gradient match."""

    def _match_loss(self, g_dummy, g_victim):
        return tree_sq_norm(tree_sub(g_dummy, g_victim))


class InvertGradientAttack(_GradientMatcherBase):
    """Inverting gradients: one minus the cosine similarity of the
    gradients."""

    def __init__(self, args):
        super().__init__(args)
        self.tv_weight = float(getattr(args, "attack_tv_weight", 1e-4))

    def _match_loss(self, g_dummy, g_victim):
        num = tree_dot(g_dummy, g_victim)
        den = torch.sqrt(tree_sq_norm(g_dummy) * tree_sq_norm(g_victim)) \
            + 1e-12
        return 1.0 - num / den


class RevealingLabelsAttack:
    """Label restoration from the classification head's gradient: for
    softmax cross entropy the output bias's gradient is negative exactly
    at the classes in the victim's batch (with zero inputs)."""

    def __init__(self, args):
        self.args = args

    def reconstruct_data(self, a_gradient, extra_auxiliary_info=None):
        # the last 1-D leaf in the JAX leaf order: the output-layer bias
        ones = [n for n, _ in layout_of(a_gradient)
                if a_gradient[n].ndim == 1]
        if not ones:
            return None
        gb = a_gradient[ones[-1]]
        return torch.nonzero(gb < 0).flatten()
