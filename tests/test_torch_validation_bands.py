"""The week-long acceptance bands of aerobulk_tpu_torch.validation on the
CPU: tests/test_validation.py's check (the JAX package's, marked slow
there) on the port's runs.  Its parity with aerobulk_tpu.validation is
held in tests/test_torch_validation.py.
"""

import numpy as np

from aerobulk_tpu_torch import validation


def test_week_long_bands_accept_members_and_reject_scaled():
    """tests/test_validation.py's check on the port: over one week of hourly
    records the five algorithms agree within a sane envelope, each member
    is accepted by the family's bands, a run scaled by 1.5 is not."""
    forcing = validation.idealized_forcing(nt=24 * 7)
    runs = {a: validation.run_idealized(a, forcing, niter=6, device="cpu")
            for a in validation.OCEAN_ALGOS_ORDER}
    bands = {}
    for v in validation.FLUX_VARS:
        stack = np.stack([runs[a][v] for a in validation.OCEAN_ALGOS_ORDER])
        assert np.all(np.isfinite(stack)), v
        bands[v] = {"mean": stack.mean(0), "lower": stack.min(0),
                    "upper": stack.max(0)}
        width = bands[v]["upper"] - bands[v]["lower"]
        assert np.max(width) < (0.12 if v == "Tau" else 60.0), v
    for a in validation.OCEAN_ALGOS_ORDER:
        verdict = validation.check_against_bands(runs[a], bands)
        assert all(verdict.values()), (a, verdict)
    bad = {v: runs["coare3p6"][v] * 1.5 for v in validation.FLUX_VARS}
    assert not all(validation.check_against_bands(bad, bands).values())
