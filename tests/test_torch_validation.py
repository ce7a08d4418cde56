"""aerobulk_tpu_torch.validation against aerobulk_tpu.validation, fp64 on
the CPU: the idealized forcing bitwise, and ``run_idealized`` over 48
hourly records at niter=4 for each of the five ocean algorithms at rtol
1e-12 (atol 1e-12 * max|ref| for Qlat and Qsen, which cross zero).  The
week-long acceptance bands are checked in
tests/test_torch_validation_bands.py.
"""

import numpy as np
import pytest
import torch

from aerobulk_tpu import validation as jval
from aerobulk_tpu_torch import io as tio
from aerobulk_tpu_torch import validation as tval

NT = 48


def test_idealized_forcing_is_bitwise_equal():
    for nt in (NT, 24 * 365):
        got, ref = tval.idealized_forcing(nt=nt), jval.idealized_forcing(nt=nt)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            assert got[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("algo", tval.OCEAN_ALGOS_ORDER)
def test_run_idealized_matches_jax(algo, tmp_path):
    forcing = tval.idealized_forcing(nt=NT)
    got = tval.run_idealized(algo, forcing, niter=4, device="cpu")
    ref = jval.run_idealized(algo, forcing, niter=4)
    assert set(got) == set(tval.FLUX_VARS) == set(ref)
    for v in tval.FLUX_VARS:
        r = np.asarray(ref[v])
        np.testing.assert_allclose(got[v], r, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(r)), err_msg=v)

    # the band file's writer path (write_validation_file without the year)
    path = str(tmp_path / "VALIDATION_IDEALIZED.nc")
    tio.write_series(path, np.arange(NT) * 3600.0,
                     {f"{v}_mean": got[v] for v in tval.FLUX_VARS})
    np.testing.assert_array_equal(tio.read_forcing(path)["Qlat_mean"],
                                  got["Qlat"])


def test_run_idealized_without_gpu_names_the_cpu_option(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tval.run_idealized("ncar", tval.idealized_forcing(nt=2))
