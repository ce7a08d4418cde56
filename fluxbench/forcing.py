"""The benchmark's one traffic generator: seeded synthetic forcing of hourly
records on a grid, from the parameters of a traffic mix
(``traffic/<mix>.json``).

A mix lists the base fields in the order they are drawn from numpy's
generator (``fields``: name, ``uniform`` lo + span * U[0, 1) or ``normal``
mean, sd), each rounded to float32, and how the records evolve from the base
(``evolution``): a slow SST ramp per record, a diurnal air-temperature
wobble and a diurnal shortwave cycle over ``period_records`` records.  With
the parameters of the mixes committed here this is, draw for draw, the
streamed forcing of ``aerobulk_tpu_torch.measure.streamed_forcing`` and
``stream_records`` (bench.py's distributions), copied so that a change to
the program cannot change the benchmark's inputs.
"""

from __future__ import annotations

import numpy as np

#: seconds in a day, the warm layer's solar clock
DAY_SECONDS = 86400


def rng_for(seed: int) -> np.random.Generator:
    """numpy's generator for ``seed``, any whole number (a negative one is
    taken modulo 2**64)."""
    return np.random.default_rng(int(seed) % 2 ** 64)


def base_fields(mix: dict, seed: int, shape) -> dict:
    """The mix's base fields of ``shape``, float32 numpy, drawn in order."""
    rng = rng_for(seed)
    out = {}
    for name, kind, a, b in mix["fields"]:
        if kind == "uniform":
            x = a + b * rng.random(shape)
        elif kind == "normal":
            x = rng.normal(a, b, shape)
        else:
            raise ValueError(f"forcing: field {name!r} has unknown draw "
                             f"{kind!r} (uniform or normal)")
        out[name] = x.astype(np.float32)
    return out


def offsets(mix: dict, nrec: int) -> dict:
    """The per-record evolution factors of ``nrec`` records, float32, so
    that the host records and every device copy apply the same
    arithmetic."""
    ev = mix["evolution"]
    jts = np.arange(nrec)
    cycle = np.sin(2 * np.pi * jts / float(ev["period_records"]))
    return {"sst": (ev["sst_ramp_per_record"] * jts).astype(np.float32),
            "t_zt": (ev["t_zt_amplitude"] * cycle).astype(np.float32),
            "rad_sw": np.clip(cycle, 0.0, 1.0).astype(np.float32)}


def stream_records(base: dict, offs: dict, stop: int, start: int = 0,
                   record_seconds: int = 3600):
    """Host records ``start`` to ``stop``: the base fields (``lon`` left
    out) with each record's SST ramp, air-temperature wobble and shortwave
    factor, and its UTC seconds of day under ``isecday_utc``."""
    fields = {k: v for k, v in base.items() if k != "lon"}
    for jt in range(start, stop):
        rec = dict(fields)
        rec["sst"] = fields["sst"] + offs["sst"][jt]
        rec["t_zt"] = fields["t_zt"] + offs["t_zt"][jt]
        rec["rad_sw"] = fields["rad_sw"] * offs["rad_sw"][jt]
        rec["isecday_utc"] = np.int32((jt * record_seconds) % DAY_SECONDS)
        yield rec


def series(mix: dict, seed: int, shape):
    """The mix's ``records`` records stacked: (forcing as name -> float32
    array of shape (records, *shape), lon of ``shape``, the records' UTC
    seconds of day as a list)."""
    nrec = int(mix["records"])
    base = base_fields(mix, seed, shape)
    recs = list(stream_records(base, offsets(mix, nrec), nrec,
                               record_seconds=int(mix["record_seconds"])))
    forcing = {k: np.stack([r[k] for r in recs])
               for k in recs[0] if k != "isecday_utc"}
    return forcing, base["lon"], [int(r["isecday_utc"]) for r in recs]
