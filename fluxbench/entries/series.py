"""Entry ``series``: one call is ``api.run_series(backend="fused")`` over
the mix's records held on the device, from a fresh warm-layer state, as a
forced ocean model runs a day of hourly records; kernel 1 once a record."""

from __future__ import annotations

import torch

from fluxbench.entry import Resident, series_answers, sync
from fluxbench.reference import aerobulk as ref


class Call(Resident):
    def __call__(self):
        out, state = self._run_series(self.program_cfg, self.forcing,
                                      isecday_utc=self.isd, lon=self.lon,
                                      backend="fused")
        sync(self.device)
        return out, state

    def answers(self, result):
        out, state = result
        recs = [tuple(getattr(out, n)[k] for n in ref.OUTPUTS)
                for k in range(self.records)]
        sst = torch.as_tensor(self.host[0]["sst"], device=self.device)
        return series_answers(recs, state, sst)

    def reference(self, dtype):
        return self.reference_series(self.host, dtype)
