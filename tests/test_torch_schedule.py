"""dropclip_tpu_torch.core.schedule against dropclip_tpu.core.schedule:
SGDR with t_mult 1 and > 1, poly and step policies."""

import numpy as np
import pytest

from dropclip_tpu.core import schedule as jsched
from dropclip_tpu_torch.core import schedule


@pytest.mark.parametrize("t_mult", [1, 2, 3])
def test_sgdr_matches_jax(t_mult):
    """lr(t) over fractional epochs through several restarts: 1e-7 of
    base_lr (both compute in float32)."""
    kw = dict(base_lr=3e-4, eta_min=1e-4, t_0=5.0, t_mult=t_mult)
    j, p = jsched.cosine_annealing_warm_restarts(**kw), \
        schedule.cosine_annealing_warm_restarts(**kw)
    for t in np.concatenate([np.linspace(0, 60, 241), [0.5 / 3, 7 / 3]]):
        assert abs(p(float(t)) - float(j(t))) <= 1e-7 * 3e-4, t


def test_sgdr_recipe_and_argument_checks():
    """The recipe (T_0 = epochs, eta_min = min_lr) starts at base_lr and
    reaches min_lr at the end of the period; bad periods raise."""
    lr = schedule.cosine_annealing_warm_restarts(3e-4, 1e-4, t_0=200)
    assert lr(0) == pytest.approx(3e-4)
    assert lr(100) == pytest.approx(2e-4)
    assert lr(199.999) == pytest.approx(1e-4, rel=1e-6)
    for kw in (dict(t_0=0), dict(t_mult=0)):
        with pytest.raises(ValueError):
            schedule.cosine_annealing_warm_restarts(1.0, **kw)


@pytest.mark.parametrize("it", [0, 7, 99])
def test_poly_and_step_match_jax(it):
    """Both are plain Python in both packages: equal."""
    assert schedule.poly_learning_rate(0.01, it, 100) == \
        jsched.poly_learning_rate(0.01, it, 100)
    assert schedule.step_learning_rate(0.01, it, 30) == \
        jsched.step_learning_rate(0.01, it, 30)
