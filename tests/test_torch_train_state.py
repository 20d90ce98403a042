"""dropclip_tpu_torch.distill.train_state.AmsgradChain against the JAX
package's optax chain (clip_by_global_norm -> scale_by_amsgrad ->
add_decayed_weights -> scale_by_learning_rate(SGDR)) over 10 steps of
random gradients, from zero state and from a mid-training optax state
carried over by convert.amsgrad_opt_state."""

import numpy as np
import pytest

import jax
import optax
import torch
from torch import nn

from dropclip_tpu.core.config import CfgNode as JCfg
from dropclip_tpu.distill.train_state import make_optimizer as j_optimizer
from dropclip_tpu_torch.convert import amsgrad_opt_state
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.distill.train_state import (AmsgradChain,
                                                    create_train_state,
                                                    global_norm,
                                                    make_optimizer)

CFG = dict(base_lr=3e-4, min_lr=1e-4, epochs=2, weight_decay=1e-5,
           max_norm=5.0)
SHAPES = {"block": {"kernel": (27, 4, 3)}, "bn": {"scale": (3,),
                                                  "bias": (3,)}}


class Params(nn.Module):
    """Parameters named as the flax tree ``SHAPES`` flattens."""

    def __init__(self, values):
        super().__init__()
        for mod, leaves in values.items():
            sub = nn.Module()
            for k, v in leaves.items():
                setattr(sub, k, nn.Parameter(torch.tensor(np.array(v))))
            setattr(self, mod, sub)


def _grads(rng, step):
    # every third step is large enough to be clipped (norm > 5)
    scale = 10.0 if step % 3 == 2 else 0.3
    return {m: {k: (scale * rng.randn(*s)).astype(np.float32)
                for k, s in leaves.items()} for m, leaves in SHAPES.items()}


def _run(n, params, opt_state, tx_j, model, state, rng, start):
    for i in range(start, start + n):
        g = _grads(rng, i)
        upd, opt_state = tx_j.update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
        for m, leaves in g.items():
            for k, v in leaves.items():
                getattr(getattr(model, m), k).grad = torch.as_tensor(v)
        norm = state.apply_gradients()
        assert float(norm) == pytest.approx(float(optax.global_norm(g)),
                                            rel=1e-6)
    return params, opt_state


def _check(model, params):
    for m, leaves in params.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(
                getattr(getattr(model, m), k).detach().numpy(),
                np.asarray(v), rtol=1e-6, atol=1e-6, err_msg=f"{m}.{k}")


@pytest.mark.parametrize("mid", [False, True])
def test_amsgrad_chain_matches_optax(mid):
    """10 steps of random gradients (some clipped): parameters 1e-6, grad
    norms 1e-6 relative; the moments 1e-4 relative plus 1e-6 of each
    tensor's largest (nu_max holds nu / (1 - 0.999**count), and at count 8
    that difference keeps 3 of float32's digits, so one ulp of pow moves
    it by 1e-5). ``mid``: both start from the optax state after 7
    steps, where the bias correction and the running max matter."""
    rng = np.random.RandomState(0)
    tx_j = j_optimizer(JCfg(dict(CFG)), iters_per_epoch=3)
    params = {m: {k: rng.randn(*s).astype(np.float32)
                  for k, s in leaves.items()}
              for m, leaves in SHAPES.items()}
    opt_state = tx_j.init(params)
    start = 0
    if mid:
        # warm the optax state alone on other gradients
        for i in range(7):
            upd, opt_state = tx_j.update(_grads(rng, i), opt_state, params)
            params = optax.apply_updates(params, upd)
        start = 7
    params = jax.tree_util.tree_map(np.asarray, params)
    model = Params(params)
    state = create_train_state(model, make_optimizer(CfgNode(dict(CFG)), 3))
    if mid:
        ams = jax.tree_util.tree_map(np.asarray, opt_state[1])
        state.opt_state = amsgrad_opt_state(ams.mu, ams.nu, ams.nu_max,
                                            ams.count)
        assert state.opt_state["count"] == 7
    params, opt_state = _run(10, params, opt_state, tx_j, model, state,
                             rng, start)
    _check(model, params)
    ams = jax.tree_util.tree_map(np.asarray, opt_state[1])
    assert state.opt_state["count"] == int(ams.count) == start + 10
    for name in ("mu", "nu", "nu_max"):
        ref = getattr(ams, name)
        for m, leaves in ref.items():
            for k, v in leaves.items():
                np.testing.assert_allclose(
                    state.opt_state["moments"][f"{m}.{k}"][name].numpy(), v,
                    rtol=1e-4, atol=1e-6 * np.abs(v).max(),
                    err_msg=f"{name} {m}.{k}")


def test_amsgrad_is_not_torchs():
    """The chain's running max is over the bias-corrected second moment:
    torch.optim.AdamW(amsgrad=True), which maxes the raw moment, leaves
    another trajectory on the same gradients (the reason for the chain)."""
    rng = np.random.RandomState(1)
    w0 = rng.randn(50).astype(np.float32)
    model = nn.Linear(1, 1)
    model.weight = nn.Parameter(torch.as_tensor(w0.copy()))
    del model.bias
    ref = nn.Parameter(torch.as_tensor(w0.copy()))
    tx = AmsgradChain(lambda c: 1e-2)
    st, opt = tx.init(model), torch.optim.AdamW([ref], lr=1e-2,
                                                weight_decay=0.0,
                                                amsgrad=True)
    for i in range(6):
        g = torch.as_tensor(rng.randn(50).astype(np.float32)
                            * (3.0 if i < 2 else 0.1))
        model.weight.grad, ref.grad = g.clone(), g.clone()
        tx.update(model, st)
        opt.step()
    assert float((model.weight - ref).abs().max().detach()) > 1e-4


def test_global_norm_and_clip_have_no_epsilon():
    """clip_by_global_norm scales by max_norm / norm exactly
    (clip_grad_norm_ adds 1e-6); at norm < max_norm nothing moves."""
    g = torch.tensor([3.0, 4.0])
    assert float(global_norm([g])) == 5.0
    model = nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        model.weight.zero_()
    model.weight.grad = g[None].clone()
    tx = AmsgradChain(lambda c: 1.0, max_norm=2.5)
    st = tx.init(model)
    tx.update(model, st)
    mu = st["moments"]["weight"]["mu"]
    torch.testing.assert_close(mu, 0.1 * g[None] * 0.5, rtol=0, atol=0)
