"""Plain optimizer steps of the training references: Adam and SGD with
momentum as ``torch.optim`` defines them (the two the port's
``make_optimizer`` builds), in float32 over a flat dict of leaves, going on
from the program's optimizer state before the followed steps.

The configuration's ``optimizer`` names the step: ``{"name": "adam", "lr",
"weight_decay"}`` (betas (0.9, 0.999), eps 1e-8) or ``{"name": "sgd",
"lr", "weight_decay", "momentum"}`` (dampening 0, not Nesterov). Both add
the decay to the gradient (L2). A leaf without a gradient is not stepped,
as torch skips it.

``first_gradient`` works out the gradient an optimizer took in one step
from its state before and after that step.
"""

from __future__ import annotations

import numpy as np
import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def build(config: dict, states: dict):
    """The step ``config`` names, going on from ``states``: leaf name ->
    the program optimizer's state of that leaf (empty where it has none)."""
    kind = {"adam": Adam, "sgd": SGD}.get(config["name"])
    if kind is None:
        raise ValueError(f"no reference of the optimizer {config['name']!r}")
    return kind(config, states)


def _copied(states: dict, key: str) -> dict:
    return {n: s[key].detach().clone().float() for n, s in states.items()
            if s.get(key) is not None}


class Adam:
    """torch's Adam, the decay added to the gradient, bias-corrected."""

    def __init__(self, config: dict, states: dict):
        self.lr, self.wd = config["lr"], config["weight_decay"]
        self.m, self.v = _copied(states, "exp_avg"), _copied(states, "exp_avg_sq")
        self.t = {n: int(s["step"]) for n, s in states.items() if "step" in s}

    def step(self, params: dict, grads: dict) -> dict:
        """One step of ``params`` (its entries replaced) by ``grads`` (None
        for a leaf without one). Returns each leaf's gradient as the step
        took it, the decay added (zeros for a leaf without one)."""
        b1, b2 = BETAS
        took = {}
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n]
                if g is None:
                    took[n] = torch.zeros_like(p)
                    continue
                g = g + self.wd * p
                took[n] = g
                t = self.t[n] = self.t.get(n, 0) + 1
                m = self.m[n] = b1 * self.m.get(n, torch.zeros_like(p)) + (1 - b1) * g
                v = self.v[n] = b2 * self.v.get(n, torch.zeros_like(p)) + (1 - b2) * g * g
                bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
                denom = v.sqrt() / np.sqrt(bc2) + EPS
                params[n] = p - (self.lr / bc1) * m / denom
        return took


class SGD:
    """torch's SGD with momentum (dampening 0, not Nesterov): the first
    step's buffer is the gradient, later ones ``momentum * buf + grad``."""

    def __init__(self, config: dict, states: dict):
        self.lr, self.wd, self.mu = config["lr"], config["weight_decay"], config["momentum"]
        self.buf = _copied(states, "momentum_buffer")

    def step(self, params: dict, grads: dict) -> dict:
        """As :meth:`Adam.step`."""
        took = {}
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n]
                if g is None:
                    took[n] = torch.zeros_like(p)
                    continue
                g = g.add(p, alpha=self.wd) if self.wd else g
                took[n] = g
                if self.mu:
                    buf = self.buf.get(n)
                    g = self.buf[n] = (g.clone() if buf is None
                                       else buf.mul(self.mu).add(g, alpha=1.0))
                params[n] = p.add(g, alpha=-self.lr)
        return took


def first_gradient(config: dict, before: dict, after: dict, like: dict) -> dict:
    """Each leaf's gradient as the optimizer ``config`` names took it in
    one step, the decay included, from its state before and after that
    step (leaf name -> state; a missing moment is zero; ``like`` gives the
    leaves' shapes): Adam ``(m1 - beta1 m0) / (1 - beta1)``, SGD with
    momentum ``buf1 - momentum buf0``."""
    if config["name"] == "adam":
        key, b1 = "exp_avg", BETAS[0]

        def took(m0, m1):
            return (m1 - b1 * m0) / (1 - b1)
    elif config["name"] == "sgd" and config["momentum"]:
        key, mu = "momentum_buffer", config["momentum"]

        def took(m0, m1):
            return m1 - mu * m0
    else:
        raise ValueError(f"the state of {config} does not hold its gradient")

    def moment(states, n):
        got = states.get(n, {}).get(key)
        return torch.zeros_like(like[n]) if got is None else got

    return {n: took(moment(before, n), moment(after, n)) for n in like}
