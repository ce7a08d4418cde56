"""Entry ``series_grad``: one call is the gradient of a sum of fluxes over
the mix's records with respect to their SST, taken with
``torch.autograd.grad`` through ``api.run_series(backend="fused",
fused_grad_backend="kernel")`` from a fresh warm-layer state, as a 4D-Var
window or a calibration step takes it: kernel 1 forward and kernel 2
backward once a record."""

from __future__ import annotations

import torch

from fluxbench.entry import STATE, Resident, sync
from fluxbench.reference import aerobulk as ref
from fluxbench.reference import check


class Call(Resident):
    kernels = ("kernel1", "kernel2")

    def __init__(self, cfg, mix, seed, shape, device):
        super().__init__(cfg, mix, seed, shape, device)
        self.loss_fields = tuple(mix["loss"])
        self.forcing["sst"].requires_grad_()

    def __call__(self):
        with torch.profiler.record_function("fluxbench.forward"):
            out, state = self._run_series(self.program_cfg, self.forcing,
                                      isecday_utc=self.isd, lon=self.lon,
                                      backend="fused",
                                      fused_grad_backend="kernel")
            loss = sum(getattr(out, n) for n in self.loss_fields).sum()
        with torch.profiler.record_function("fluxbench.backward"):
            (grad,) = torch.autograd.grad(loss, self.forcing["sst"])
        sync(self.device)
        return loss.detach(), grad, tuple(x.detach() for x in state)

    def answers(self, result):
        loss, grad, state = result
        return {"loss": loss, "dsst": grad, **dict(zip(STATE, state))}

    def reference(self, dtype):
        """The loss and its gradient by autograd of the plain reference,
        in blocks of points (the points are independent; autograd holds
        every record's graph of a block at once)."""
        fields, lon, isd = self.host
        n = self.shape[0] * self.shape[1]
        block = int(self.mix["reference_block_points"])
        flat = {k: torch.as_tensor(v, device=self.device).reshape(
            self.records, n) for k, v in fields.items()}
        lon = torch.as_tensor(lon, device=self.device).reshape(n)
        loss, grads, states = 0.0, [], []
        for a in range(0, n, block):
            f = {k: v[:, a:a + block].to(dtype) for k, v in flat.items()}
            f["sst"].requires_grad_()
            outs, state = ref.run_series(self.cfg, f,
                                         lon[a:a + block].to(dtype), isd)
            part = sum(out[ref.OUTPUTS.index(name)].sum()
                       for out in outs for name in self.loss_fields)
            (g,) = torch.autograd.grad(part, f["sst"])
            loss += float(part.detach())
            grads.append(g.detach())
            states.append([x.detach() for x in state])
        return {"loss": torch.tensor(loss, dtype=torch.float64),
                "dsst": torch.cat(grads, 1).reshape(self.records,
                                                    *self.shape),
                **{name: torch.cat(parts).reshape(self.shape)
                   for name, *parts in zip(STATE, *states)}}

    def numbers(self, answers, reference):
        r = float(reference["loss"])
        loss_rel = abs(float(answers["loss"]) - r) / abs(r)
        sig, med = check.grad_errors(answers["dsst"], reference["dsst"])
        # the state's median error is 0 on both sides: most points end the
        # window with no warm layer, exactly as they began it
        state = check.fields_numbers(answers, {k: reference[k] for k in STATE})
        return {"loss_rel": (loss_rel, "loss"), "grad_sig_frac": (sig, "dsst"),
                "grad_med_err": (med, "dsst"),
                "state_sig_frac": state["sig_frac"]}
