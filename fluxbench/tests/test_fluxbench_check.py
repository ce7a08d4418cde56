"""The check that decides ``correct``, driven through the rest of a run on
the CPU at a small grid (the look for a card skipped: ``run.measure`` with
a CPU device, where the program's fused step is its plain version): a
sound run is correct; the control, the plain reference computed in
bfloat16 and put in the program's step's place, is not; nor is a run whose
step is broken underneath in each way a cell of this benchmark can break:
the warm-layer state returned unchanged, half of the points left out (the
mean of the rest in their place), or one record's answer altered where the
step produces it.  (No cell runs over several chips: there is no exchange
to leave out.)"""

import dataclasses

import pytest
import torch

import aerobulk_tpu_torch.kernels.fused as kfused
from aerobulk_tpu_torch.skin import SkinState
from fluxbench.reference import aerobulk as ref
from fluxbench.run import ROOT, Cell, measure, read_json

BENCH = read_json(ROOT / "BENCHMARK.json")
#: the streamed feed's cell, measured but left out of BENCHMARK.json for
#: its spread (PERF.md §7): its entry and mix are checked here all the same
STREAMED = {"name": "coare3p6_skin_era5_0p25.streamed_2day",
            "config": "coare3p6_skin_era5_0p25", "traffic": "streamed_2day",
            "chips": 1, "why": "the host feed"}
BENCH["workloads"].append(STREAMED)
CELLS = [w["name"] for w in BENCH["workloads"]]
SHAPE = (24, 40)
SEED = 2 ** 31 + 123


def _run(workload):
    result, lines = measure(Cell(BENCH, workload), SEED, 0.05, False,
                            torch.device("cpu"), shape=SHAPE,
                            log=lambda line: None)
    return result, "\n".join(lines)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    result, lines = _run(workload)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "check"
    assert all(c["value"] <= c["limit"] for c in result["check"].values())


def _control_step(cfg, sst, t_zt, hum_zt, U_zu, V_zu, slp, rad_sw, rad_lw,
                  lon=None, isecday_utc=43200, skin_state=None,
                  grad_backend="kernel"):
    """The plain reference in bfloat16 in the place of the fused step."""
    def low(x):
        return x.to(torch.bfloat16)
    if skin_state is None:
        state = ref.init_state(cfg.algo, sst.shape, torch.bfloat16,
                               sst.device)
    else:
        state = ref.SkinState(*map(low, skin_state))
    outs, new = ref.flux_step(
        dataclasses.asdict(cfg), *map(low, (sst, t_zt, hum_zt, U_zu, V_zu,
                                            slp, rad_sw, rad_lw)),
        low(torch.zeros_like(sst) if lon is None else lon),
        int(isecday_utc), state)
    return (tuple(o.to(sst.dtype) for o in outs),
            SkinState(*(s.to(sst.dtype) for s in new)))


def _state_unchanged(step):
    def broken(*args, skin_state=None, **kw):
        outs, new = step(*args, skin_state=skin_state, **kw)
        return outs, (new if skin_state is None else skin_state)
    return broken


def _half_left_out(step):
    def broken(*args, **kw):
        outs, new = step(*args, **kw)

        def half(x):
            flat = x.reshape(-1)
            n = flat.numel() // 2
            rest = flat[:n].mean().expand(flat.numel() - n)
            return torch.cat([flat[:n], rest]).reshape(x.shape)
        return tuple(map(half, outs)), SkinState(*map(half, new))
    return broken


def _answer_altered(step):
    def broken(*args, isecday_utc=43200, **kw):
        (ql, *rest), new = step(*args, isecday_utc=isecday_utc, **kw)
        if int(isecday_utc) == 3 * 3600:     # one record's latent heat
            ql = ql * 1.1
        return (ql, *rest), new
    return broken


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload, monkeypatch):
    monkeypatch.setattr(kfused, "fused_flux_step", _control_step)
    result, lines = _run(workload)
    assert not result["correct"], lines
    assert any(c["value"] > c["limit"] for c in result["check"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    monkeypatch.setattr(kfused, "fused_flux_step",
                        FAULTS[fault](kfused.fused_flux_step))
    result, lines = _run(workload)
    assert not result["correct"], lines
