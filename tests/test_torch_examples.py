"""The port's example modules on the CPU: ``implicit_coupling`` (its
checks live in ``main``, as in examples/implicit_coupling.py),
``sensitivity_map`` against ``jax.grad`` of the JAX package's step on the
same climatology (fp64, rtol 1e-10 and atol 1e-12 * max|ref|: one reverse
pass each, as tests/test_torch_grad.py holds one step's gradients), and
each module's command line refusing to run without a GPU unless given
``--device cpu``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import api as japi
from aerobulk_tpu_torch import implicit_coupling, sensitivity_map

REPO = Path(__file__).resolve().parent.parent


def test_implicit_coupling_main_on_cpu():
    """The abridged horizon of tests/test_grad.py::
    test_implicit_coupling_example: implicit 12 h coupling reaches the
    resolved equilibrium, explicit 12 h coupling strays further."""
    ref, exp, imp = implicit_coupling.main(days=8.0, device="cpu")
    assert len(ref) == 8 * 24 + 1 and len(imp) == 8 * 2 + 1
    assert abs(imp[-1] - ref[-1]) < 0.05


def test_implicit_step_matches_the_jax_linearization():
    """One implicit step's flux derivative equals jax.jvp of the JAX step
    at the slab's start temperature (rtol 1e-10)."""
    T0 = 295.15
    args = implicit_coupling.forcing("cpu")
    _, d, _ = implicit_coupling.flux_step_linearized(
        implicit_coupling.CFG, torch.full((1,), T0, dtype=torch.float64),
        *args, wrt="sst")
    cfg = japi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=False)
    _, jd, _ = japi.flux_step_linearized(
        cfg, jnp.full((1,), T0), *(jnp.asarray(a.numpy()) for a in args),
        wrt="sst")
    np.testing.assert_allclose((d.QL + d.QH).numpy(),
                               np.asarray(jd.QL + jd.QH), rtol=1e-10)


def test_sensitivity_map_matches_jax_grad():
    dq_dsst, dq_du = sensitivity_map.main(device="cpu")
    sst, t_zt, q_zt, U, _, _ = (jnp.asarray(x) for x in
                                sensitivity_map.synthetic_climatology())
    shape = (sensitivity_map.NY, sensitivity_map.NX)
    slp, rsw, rlw = (jnp.full(shape, x) for x in (101000.0, 250.0, 370.0))
    cfg = japi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)

    def qnet(sst, U):
        out, _ = japi.flux_step(cfg, sst, t_zt, q_zt, U, jnp.zeros_like(U),
                                slp, rad_sw=rsw, rad_lw=rlw,
                                isecday_utc=43200)
        return jnp.sum(out.QL + out.QH)

    ref = jax.grad(qnet, argnums=(0, 1))(sst, U)
    for g, r in zip((dq_dsst, dq_du), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=1e-10,
                                   atol=1e-12 * np.max(np.abs(r)))
    assert dq_dsst.max() < 0.0       # a warmer ocean loses more heat


@pytest.mark.parametrize("module", ["implicit_coupling", "sensitivity_map",
                                    "calibrate_charnock"])
def test_example_cli_needs_a_gpu_or_device_cpu(module):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the module would run on it")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m", f"aerobulk_tpu_torch.{module}"],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env=env)
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr
    r = subprocess.run([sys.executable, "-m", f"aerobulk_tpu_torch.{module}",
                        "--help"], cwd=REPO, capture_output=True, text=True,
                       timeout=120, env=env)
    assert r.returncode == 0 and "--device" in r.stdout


def test_sensitivity_map_imports_matplotlib_only_for_the_plot():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; import aerobulk_tpu_torch.sensitivity_map as m, "
         "aerobulk_tpu_torch.calibrate_charnock, "
         "aerobulk_tpu_torch.implicit_coupling\n"
         "m.NY, m.NX = 4, 8\n"
         "m.main(device='cpu')\n"
         "assert 'matplotlib' not in sys.modules\n"
         "assert 'optax' not in sys.modules and 'jax' not in sys.modules\n"
         "print('ok')"],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
