"""What every entry of the benchmark shares: the program's configuration
from a config file, the traffic mix's forcing on the device, and the
answers of a series of records.

An entry (``entries/<name>.py``, named by a mix's ``entry``) defines
``Call``, a subclass of :class:`Entry`: ``__call__`` runs one call of the
timed path and waits for the device; ``answers`` turns what a call returned
into named tensors; ``reference`` computes the same names with the plain
reference; ``numbers`` compares the two.  The program
(``aerobulk_tpu_torch``) is imported here, in set-up, and nowhere in the
reference.
"""

from __future__ import annotations

import torch

from . import forcing
from .reference import aerobulk as ref
from .reference import check

#: the final state's fields, in the program's order
STATE = ("dT_wl", "Hz_wl", "Qnt_ac", "Tau_ac")


def program_config(cfg: dict):
    """The program's ``AeroBulkConfig`` of a config file."""
    from aerobulk_tpu_torch.api import AeroBulkConfig
    return AeroBulkConfig(algo=cfg["algo"], zt=float(cfg["zt"]),
                          zu=float(cfg["zu"]), niter=int(cfg["niter"]),
                          use_skin=bool(cfg["use_skin"]),
                          humidity=cfg["humidity"], rdt=float(cfg["rdt"]),
                          gdept=float(cfg["gdept"]))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Entry:
    """A call of a config under a mix on ``device``, its forcing made from
    ``seed`` at ``shape`` (the config's grid unless a test gives another)."""

    #: the kernels of the program one record runs, as the census names them
    kernels = ("kernel1",)

    def __init__(self, cfg: dict, mix: dict, seed: int, shape, device):
        if cfg["dtype"] != "float32":
            raise ValueError(f"entry: the benchmark runs float32 configs, "
                             f"not {cfg['dtype']}")
        self.cfg, self.mix, self.device = cfg, mix, device
        self.shape = tuple(shape)
        self.seed = seed
        self.program_cfg = program_config(cfg)
        self.records = int(mix["records"])
        self.points = self.records * self.shape[0] * self.shape[1]
        #: program counters of the calls since the last clear, by name
        self.counters = {}

    def host_series(self):
        """The mix's records stacked on the host (see
        :func:`forcing.series`)."""
        return forcing.series(self.mix, self.seed, self.shape)

    def reference_series(self, host, dtype, state_too=True):
        """The plain reference over the host records ``host`` (as
        :meth:`host_series` gives them), in ``dtype``, on the device:
        {"QL[k]": ..., "dT_s[k]": T_s - sst, ..., and the final state}."""
        fields, lon, isd = host
        f = {k: torch.as_tensor(v, device=self.device).to(dtype)
             for k, v in fields.items()}
        lon = torch.as_tensor(lon, device=self.device).to(dtype)
        with torch.no_grad():
            outs, state = ref.run_series(self.cfg, f, lon, isd)
        sst = torch.as_tensor(fields["sst"], device=self.device)
        return series_answers(outs, state if state_too else None, sst)

    def numbers(self, answers: dict, reference: dict):
        return check.fields_numbers(answers, reference)

    def release(self):
        """Drop the device copies of the forcing before the reference
        runs."""


class Resident(Entry):
    """An entry whose records are held on the device: the host series, its
    device copy, and the seconds of day on the host."""

    def __init__(self, cfg, mix, seed, shape, device):
        super().__init__(cfg, mix, seed, shape, device)
        from aerobulk_tpu_torch import api
        self._run_series = api.run_series
        self.host = self.host_series()
        fields, lon, self.isd = self.host
        self.forcing = {k: torch.as_tensor(v, device=device)
                        for k, v in fields.items()}
        self.lon = torch.as_tensor(lon, device=device)

    def release(self):
        self.forcing = self.lon = None


def series_answers(outs, state, sst):
    """Named answers of a series: ``outs`` a list, one per record, of the
    six outputs (:data:`ref.OUTPUTS` order) or a sequence of records
    indexable as such; T_s as T_s - sst, the informative part."""
    answers = {}
    for k, out in enumerate(outs):
        for name, x in zip(ref.OUTPUTS, out):
            if name == "T_s":
                answers[f"dT_s[{k}]"] = x.double() - sst[k].double()
            else:
                answers[f"{name}[{k}]"] = x
    if state is not None:
        for name, x in zip(STATE, state):
            answers[name] = x
    return answers
