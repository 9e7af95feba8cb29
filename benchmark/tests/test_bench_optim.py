"""The training references' optimizer steps (``reference/optim.py``): SGD
with momentum against ``torch.optim.SGD``, Adam against the arithmetic the
DGCNN reference took its steps with before the step was shared, and the
first gradient worked out from either optimizer's state."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from conftest import BENCH

sys.path.insert(0, str(BENCH))

from reference import optim  # noqa: E402

SGD = {"name": "sgd", "lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4}
ADAM = {"name": "adam", "lr": 1e-3, "weight_decay": 1e-4}
SHAPES = {"a.weight": (16, 8), "a.bias": (16,), "b.scale": (5,), "unused.weight": (3, 4)}


def leaves(seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {n: torch.randn(s, generator=gen) for n, s in SHAPES.items()}


def gradients(seed: int, steps: int) -> list:
    """Each step's gradients, None for the leaf no loss reaches."""
    out = []
    for i in range(steps):
        g = leaves(seed + 1 + i)
        g["unused.weight"] = None
        out.append(g)
    return out


def torch_steps(opt_cls, kwargs: dict, params: dict, grads: list):
    """``torch.optim`` over ``params`` (copied) by ``grads``: the parameters
    and the optimizer (its state by leaf name) after."""
    ps = {n: torch.nn.Parameter(t.clone()) for n, t in params.items()}
    opt = opt_cls(ps.values(), **kwargs)
    for g in grads:
        for n, p in ps.items():
            p.grad = None if g[n] is None else g[n].clone()
        opt.step()
    return {n: p.detach().clone() for n, p in ps.items()}, opt, ps


def states(opt, ps: dict) -> dict:
    return {n: {k: v.clone() if torch.is_tensor(v) else v
                for k, v in opt.state.get(p, {}).items()} for n, p in ps.items()}


@pytest.mark.parametrize("warm", [0, 2])
def test_sgd_is_torch_sgd(warm):
    """Three steps from a fresh buffer (``warm`` 0) or from the buffers two
    steps of torch's SGD left."""
    kwargs = dict(lr=SGD["lr"], momentum=SGD["momentum"], weight_decay=SGD["weight_decay"])
    grads = gradients(10, warm + 3)
    start, opt, ps = torch_steps(torch.optim.SGD, kwargs, leaves(0), grads[:warm])
    ref = optim.build(SGD, states(opt, ps))
    params = dict(start)
    for g in grads[warm:]:
        ref.step(params, g)
    want, opt, ps = torch_steps(torch.optim.SGD, kwargs, leaves(0), grads)
    for n in SHAPES:
        assert torch.equal(params[n], want[n]), n
    for n, p in ps.items():
        got = ref.buf.get(n)
        assert (got is None) == ("momentum_buffer" not in opt.state.get(p, {})), n
        if got is not None:
            assert torch.equal(got, opt.state[p]["momentum_buffer"]), n
    assert torch.equal(params["unused.weight"], leaves(0)["unused.weight"])


def parent_adam(p: dict, m: dict, v: dict, t: int, grads: dict, lr: float, wd: float):
    """The Adam update of the DGCNN reference's ``step`` before the step was
    shared (one global step count), copied."""
    t += 1
    b1, b2 = (0.9, 0.999)
    got = {}
    with torch.no_grad():
        for n, q in list(p.items()):
            g = grads[n]
            g = (torch.zeros_like(q) if g is None else g) + wd * q
            got[n] = g
            m[n] = b1 * m[n] + (1 - b1) * g
            v[n] = b2 * v[n] + (1 - b2) * g * g
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            denom = v[n].sqrt() / np.sqrt(bc2) + 1e-8
            p[n] = q - (lr / bc1) * m[n] / denom
    return t, got


@pytest.mark.parametrize("warm", [0, 2])
def test_adam_is_the_parent_arithmetic(warm):
    """Bit-equal parameters and taken gradients over three steps, from
    fresh moments or from those two steps of torch's Adam left; the unused
    leaf is zero, as the DGCNN configuration's unused heads are, so that
    the parent's stepping of it moved nothing either."""
    kwargs = dict(lr=ADAM["lr"], weight_decay=ADAM["weight_decay"])
    grads = gradients(20, warm + 3)
    init = leaves(0)
    init["unused.weight"] = torch.zeros(SHAPES["unused.weight"])
    start, opt, ps = torch_steps(torch.optim.Adam, kwargs, init, grads[:warm])
    st = states(opt, ps)
    ref = optim.build(ADAM, st)
    mine, theirs = dict(start), dict(start)
    m = {n: st[n].get("exp_avg", torch.zeros_like(t)).clone() for n, t in start.items()}
    v = {n: st[n].get("exp_avg_sq", torch.zeros_like(t)).clone() for n, t in start.items()}
    t = max((int(s["step"]) for s in st.values() if s), default=0)
    for g in grads[warm:]:
        took = ref.step(mine, g)
        t, got = parent_adam(theirs, m, v, t, g, ADAM["lr"], ADAM["weight_decay"])
        for n in SHAPES:
            assert torch.equal(mine[n], theirs[n]) and torch.equal(took[n], got[n]), n
    want, _, _ = torch_steps(torch.optim.Adam, kwargs, init, grads)
    for n in SHAPES:
        torch.testing.assert_close(mine[n], want[n], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cfg, cls", [(SGD, torch.optim.SGD), (ADAM, torch.optim.Adam)])
@pytest.mark.parametrize("warm", [0, 2])
def test_first_gradient(cfg, cls, warm):
    """The gradient torch's optimizer took in one step, the decay added,
    worked out from its state before and after that step."""
    kwargs = {k: v for k, v in cfg.items() if k != "name"}
    grads = gradients(30, warm + 1)
    start, opt, ps = torch_steps(cls, kwargs, leaves(0), grads[:warm])
    before = states(opt, ps)
    for n, p in ps.items():
        p.grad = None if grads[warm][n] is None else grads[warm][n].clone()
    opt.step()
    got = optim.first_gradient(cfg, before, states(opt, ps), start)
    for n, q in start.items():
        g = grads[warm][n]
        want = torch.zeros_like(q) if g is None else g + cfg["weight_decay"] * q
        torch.testing.assert_close(got[n], want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_sgd_without_momentum_has_no_first_gradient():
    with pytest.raises(ValueError):
        optim.first_gradient(dict(SGD, momentum=0.0), {}, {}, leaves(0))
