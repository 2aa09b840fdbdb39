"""The comparison that decides ``correct``: the program's readings of its
first steps against the reference's.

* ``loss_gap``: the largest gap between the two sides' mean loss, over the
  steps compared (nats).
* ``grad_gap``: over the leaf slices, the largest gap between the two
  sides' norm of step 0's gradient, over the reference's norm of that
  slice or of the median slice, whichever is larger.
* ``change_gap``: the same of the norm of each slice's change over the
  steps compared.  A slice whose reference gradient is under a thousandth
  of the median slice's moves under AdamW by round-off alone, and is left
  out.

Each is held to its limit in ``limits/<workload>.json``; a reading that is
missing or not finite fails.
"""
from __future__ import annotations

import math
import statistics

IGNORED_GRAD_SHARE = 1e-3


def relative_gaps(prog: dict, ref: dict, keys) -> dict[str, float]:
    """Each slice's gap over the reference's norm of it or of the median
    slice, whichever is larger."""
    keys = list(keys)
    floor = statistics.median(ref[k] for k in keys)
    return {k: abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], floor)
            for k in keys}


def _worst(gaps: dict[str, float]) -> float:
    values = list(gaps.values())
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def moved(ref) -> list[str]:
    """The slices whose reference gradient is not nought to rounding."""
    gmed = statistics.median(ref.grad_norms.values())
    return [k for k, g in ref.grad_norms.items()
            if g >= IGNORED_GRAD_SHARE * gmed]


def readings_gaps(prog, ref) -> dict[str, float]:
    n = len(ref.losses)
    if len(prog.losses) != n or not ref.grad_norms or not prog.grad_norms:
        return {"loss_gap": math.nan, "grad_gap": math.nan,
                "change_gap": math.nan}
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog.losses, ref.losses)),
        "grad_gap": _worst(relative_gaps(prog.grad_norms, ref.grad_norms,
                                         ref.grad_norms)),
        "change_gap": _worst(relative_gaps(prog.change_norms or {},
                                           ref.change_norms, moved(ref))),
    }


def worst_slices(prog, ref, n: int = 3) -> dict[str, list]:
    """The ``n`` slices of each per-slice number that read the most."""
    out = {}
    for name, p, r, keys in (
            ("grad_gap", prog.grad_norms, ref.grad_norms, ref.grad_norms),
            ("change_gap", prog.change_norms or {}, ref.change_norms,
             moved(ref))):
        gaps = relative_gaps(p, r, keys)
        out[name] = [[k, gaps[k], p.get(k), r[k]] for k in sorted(
            gaps, key=lambda k: -gaps[k] if gaps[k] == gaps[k] else -1e300)
            [:n]]
    return out


def compare(prog, ref, limits: dict) -> tuple[bool, dict]:
    gaps = readings_gaps(prog, ref)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
