"""Entry ``streamed``: one call is ``pipeline.run_series_pipelined(backend=
"fused")`` over the mix's records made on the host as they are fed, in
chunks, the chosen fluxes collected back to host numpy, from a fresh
warm-layer state: forcing that does not fit on the card.  The host feed
(the producer thread's staging, the link) does most of the work."""

from __future__ import annotations

import numpy as np
import torch

from fluxbench import forcing
from fluxbench.entry import STATE, Entry, sync

#: the fields the feed collects by default, in its order
COLLECTED = ("QL", "QH", "Tau", "Evap")


class Call(Entry):
    def __init__(self, cfg, mix, seed, shape, device):
        super().__init__(cfg, mix, seed, shape, device)
        from aerobulk_tpu_torch.pipeline import run_series_pipelined
        self._run = run_series_pipelined
        self.base = forcing.base_fields(mix, seed, self.shape)
        self.offs = forcing.offsets(mix, self.records)
        self.lon = torch.as_tensor(self.base["lon"], device=device)
        self.counters = {"producer_seconds": []}

    def __call__(self):
        m = self.mix
        recs = forcing.stream_records(self.base, self.offs, self.records,
                                      record_seconds=int(m["record_seconds"]))
        results, state = self._run(
            self.program_cfg, recs, backend="fused", chunk=int(m["chunk"]),
            inflight=int(m["inflight"]), wire=m["wire"],
            collect_wire=m["collect_wire"], lon=self.lon, device=self.device,
            producer_seconds=self.counters["producer_seconds"])
        sync(self.device)
        return results, state

    def answers(self, result):
        results, state = result
        answers = {}
        for name in COLLECTED:
            recs = np.concatenate([r[name] for r in results])
            for k, x in enumerate(recs):
                answers[f"{name}[{k}]"] = torch.as_tensor(x)
        answers.update(zip(STATE, state))
        return answers

    def reference(self, dtype):
        full = self.reference_series(self.host_series(), dtype)
        answers = {k: v for k, v in full.items()
                   if k.split("[")[0] in COLLECTED or k in STATE}
        for k in range(self.records):
            answers[f"Tau[{k}]"] = torch.hypot(full[f"Tau_x[{k}]"],
                                               full[f"Tau_y[{k}]"])
        return answers

    def release(self):
        self.lon = None
