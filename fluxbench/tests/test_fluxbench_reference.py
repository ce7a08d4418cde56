"""The benchmark's plain reference (fluxbench/reference/aerobulk.py) against
the program's eager step in float64 on the CPU: every output of every
record and the final state of a series, and the gradient of sum(QL + QH)
with respect to the SST of every record.  The reference imports nothing of
the program; these tests do."""

import numpy as np
import pytest
import torch

from aerobulk_tpu_torch import api
from fluxbench import forcing
from fluxbench.entry import program_config
from fluxbench.reference import aerobulk as ref
from fluxbench.run import ROOT, read_json

CONFIGS = ("coare3p6_skin_era5_0p25", "ecmwf_skin_era5_0p25")
SHAPE = (9, 13)
NREC = 30      # past a dawn and a dusk at every longitude


def _case(name, seed, nrec=NREC):
    cfg = read_json(ROOT / "fluxbench" / "configs" / f"{name}.json")
    mix = dict(read_json(ROOT / "fluxbench" / "traffic" / "resident_day.json"),
               records=nrec)
    fields, lon, isd = forcing.series(mix, seed, SHAPE)
    f = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in fields.items()}
    return cfg, f, torch.as_tensor(lon, dtype=torch.float64), isd


def _program_series(cfg, f, lon, isd):
    pcfg = program_config(cfg)
    state = api.init_skin_state(pcfg, SHAPE, torch.float64, device="cpu")
    return api.run_series(pcfg, f, skin_state=state, isecday_utc=isd,
                          lon=lon, backend="eager")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", (1, 2 ** 31 + 5))
def test_series_matches_the_program(name, seed):
    cfg, f, lon, isd = _case(name, seed)
    outs, state = ref.run_series(cfg, f, lon, isd)
    out, pstate = _program_series(cfg, f, lon, isd)
    for i, field in enumerate(ref.OUTPUTS):
        got = torch.stack([o[i] for o in outs])
        want = getattr(out, field)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(
            want.abs().max()), msg=field)
    for got, want, field in zip(state, pstate, ref.SkinState._fields):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * max(
            float(want.abs().max()), 1.0), msg=field)
    # the series builds and drains a warm layer: the state is not trivial
    assert float(state.dT_wl.abs().max()) > 1e-3 or name == "ecmwf"


@pytest.mark.parametrize("name", CONFIGS)
def test_gradient_matches_the_programs_autograd(name):
    cfg, f, lon, isd = _case(name, 7, nrec=6)
    sst = f["sst"].clone().requires_grad_()
    outs, _ = ref.run_series(cfg, dict(f, sst=sst), lon, isd)
    loss = sum((o[0] + o[1]).sum() for o in outs)
    (g_ref,) = torch.autograd.grad(loss, sst)

    sst_p = f["sst"].clone().requires_grad_()
    out, _ = _program_series(cfg, dict(f, sst=sst_p), lon, isd)
    (g_prog,) = torch.autograd.grad((out.QL + out.QH).sum(), sst_p)
    torch.testing.assert_close(g_ref, g_prog, rtol=1e-10,
                               atol=1e-10 * float(g_prog.abs().max()))
    assert np.isfinite(g_ref.numpy()).all()


def test_reference_runs_in_bfloat16():
    """The control: the same code at the precision below float32 runs and
    gives finite fluxes."""
    cfg, f, lon, isd = _case(CONFIGS[0], 3, nrec=4)
    outs, state = ref.run_series(cfg, {k: v.bfloat16() for k, v in f.items()},
                                 lon.bfloat16(), isd)
    assert outs[0][0].dtype == torch.bfloat16
    assert all(torch.isfinite(x.float()).all() for o in outs for x in o)
