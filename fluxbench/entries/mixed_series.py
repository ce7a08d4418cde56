"""Entry ``mixed_series``: one call is ``api.run_series(backend="fused")``
of a mixed ocean + sea-ice config over the mix's records held on the
device, as a forced ocean–sea-ice model computes its ice, lead and net
fluxes over a day of hourly records: the mixed kernel (kernel 5) once a
record.  The records are independent; ``Ts_i`` and ``frice`` pass through
each unchanged, and the step reads neither ``rad_sw`` nor ``lon``."""

from __future__ import annotations

import dataclasses

import torch

from fluxbench.entry import Resident, program_config, sync
from fluxbench.reference import mixed


class Call(Resident):
    kernels = ("kernel5",)

    def __init__(self, cfg, mix, seed, shape, device):
        # the mixed config first: a program without ice_algo fails here,
        # before the forcing is made
        program_cfg = dataclasses.replace(program_config(cfg),
                                          ice_algo=cfg["ice_algo"])
        super().__init__(cfg, mix, seed, shape, device)
        self.program_cfg = program_cfg

    def __call__(self):
        out, _ = self._run_series(self.program_cfg, self.forcing,
                                  backend="fused")
        sync(self.device)
        return out

    def answers(self, result):
        return self._named([getattr(result, n) for n in mixed.OUTPUTS])

    def reference(self, dtype):
        """The plain reference over every point of every record, in blocks
        of points (the records and points are independent)."""
        fields = self.host[0]
        flat = {k: torch.as_tensor(fields[k]).reshape(-1)
                for k in mixed.FORCING}
        block = int(self.mix["reference_block_points"])
        parts = []
        with torch.no_grad():
            for a in range(0, flat["sst"].numel(), block):
                parts.append(mixed.flux_step(self.cfg, *(
                    flat[k][a:a + block].to(self.device, dtype)
                    for k in mixed.FORCING)))
        outs = [torch.cat(p).reshape(self.records, *self.shape)
                for p in zip(*parts)]
        return self._named(outs)

    def _named(self, outs):
        """{"QL[k]": ..., "dT_s[k]": T_s - sst, ...} of the net outputs
        ``outs`` (:data:`mixed.OUTPUTS` order, each (records, *shape))."""
        sst = torch.as_tensor(self.host[0]["sst"], device=self.device)
        answers = {}
        for name, x in zip(mixed.OUTPUTS, outs):
            for k in range(self.records):
                if name == "T_s":
                    answers[f"dT_s[{k}]"] = x[k].double() - sst[k].double()
                else:
                    answers[f"{name}[{k}]"] = x[k]
        return answers
