"""Forward-Euler and generalized-alpha integrator tests (same bar oracle)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.formulations.courant import courant_dt
from nlpartsol.formulations.explicit import ExplicitConfig
from nlpartsol.formulations.integrators import (
    forward_euler_step,
    generalized_alpha_parameters,
    generalized_alpha_step,
)
from nlpartsol.models import materials as M

from tests.test_explicit import bar_setup, C, E_


def _mode_setup():
    grid, p, mats, L, h = bar_setup("fem")
    V = 0.01
    omega = np.pi * C / L
    vx = V * np.sin(np.pi * np.asarray(p.x)[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1)))
    return grid, p, mats, L, h, V, omega


def test_generalized_alpha_parameters():
    a, b, g = generalized_alpha_parameters(1.0)
    assert a == pytest.approx(0.5) and g == pytest.approx(1.0)
    a, b, g = generalized_alpha_parameters(0.0)
    assert a == pytest.approx(-1.0) and g == pytest.approx(2.5)


@pytest.mark.parametrize("which", ["fe", "ga"])
def test_bar_vibration_other_integrators(which):
    grid, p, mats, L, h, V, omega = _mode_setup()
    dt = courant_dt(0.1, h, C)
    cfg = ExplicitConfig(dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,))
    if which == "fe":
        step = jax.jit(forward_euler_step, static_argnums=(3,))
        args = ()
    else:
        step = jax.jit(generalized_alpha_step, static_argnums=(3, 5))
        args = (0.9,)
    body = jnp.zeros((2,), jnp.float32)
    n_quarter = int(round((np.pi / 2 / omega) / dt))
    for _ in range(n_quarter):
        p, diag = step(p, grid, mats, cfg, body, *args)
    xs = np.asarray(p.x)[:, 0] - np.asarray(p.dis)[:, 0]
    u_ref = (V / omega) * np.sin(np.pi * xs / L)
    u_num = np.asarray(p.dis)[:, 0]
    err = np.abs(u_num - u_ref).max() / (V / omega)
    # first-order FE and dissipative GA: looser gates than Newmark PC
    assert err < 0.2, f"{which}: quarter-period displacement error {err:.3f}"
    assert np.all(np.isfinite(np.asarray(p.x)))
