"""Entry ``batch_series``: one call is ``api.run_series(batch_records=True,
backend="fused")`` of a stateless config over the mix's records held on the
device, as a flux product or an offline forcing job computes a month of
bulk fluxes: the stateless kernel (kernel 3) once a call, over every point
of every record.  The records are independent and the step reads neither
the radiation nor ``lon``: they are drawn with the rest, and only the six
fields the kernel reads are put on the device."""

from __future__ import annotations

import torch

from fluxbench.entry import Entry, sync
from fluxbench.reference import bulk


class Call(Entry):
    kernels = ("kernel3",)

    def __init__(self, cfg, mix, seed, shape, device):
        super().__init__(cfg, mix, seed, shape, device)
        from aerobulk_tpu_torch import api
        self._run_series = api.run_series
        self.host = self.host_series()
        self.forcing = {k: torch.as_tensor(self.host[0][k], device=device)
                        for k in bulk.FORCING}

    def __call__(self):
        out, _ = self._run_series(self.program_cfg, self.forcing,
                                  batch_records=True, backend="fused")
        sync(self.device)
        return out

    def answers(self, result):
        return self._named([getattr(result, n) for n in bulk.OUTPUTS])

    def reference(self, dtype):
        """The plain reference over every point of every record, in blocks
        of points."""
        fields = self.host[0]
        flat = {k: torch.as_tensor(fields[k]).reshape(-1)
                for k in bulk.FORCING}
        block = int(self.mix["reference_block_points"])
        parts = []
        with torch.no_grad():
            for a in range(0, flat["sst"].numel(), block):
                parts.append(bulk.flux_step(self.cfg, *(
                    flat[k][a:a + block].to(self.device, dtype)
                    for k in bulk.FORCING)))
        outs = [torch.cat(p).reshape(self.records, *self.shape)
                for p in zip(*parts)]
        return self._named(outs)

    def release(self):
        self.forcing = None

    def _named(self, outs):
        """{"QL[k]": ..., "dT_s[k]": T_s - sst, ...} of the outputs ``outs``
        (:data:`bulk.OUTPUTS` order, each (records, *shape))."""
        sst = torch.as_tensor(self.host[0]["sst"], device=self.device)
        answers = {}
        for name, x in zip(bulk.OUTPUTS, outs):
            for k in range(self.records):
                if name == "T_s":
                    answers[f"dT_s[{k}]"] = x[k].double() - sst[k].double()
                else:
                    answers[f"{name}[{k}]"] = x[k]
        return answers
