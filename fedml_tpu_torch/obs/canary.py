"""fedslo canary verdicts — promote | rollback | extend, with receipts.

A stdlib copy of ``fedml_tpu.obs.canary``, held to it on the same
inputs by ``tests/test_torch_obs_stdlib.py``.

An adapter promotion loop needs exactly one decision function: a
freshly aggregated adapter is serving a traffic slice next to the
incumbent; somebody has to look at the two metric streams and say
*promote* (candidate is fine), *rollback* (candidate regressed), or
*extend* (not enough evidence yet).  :class:`CanaryJudge` is that
function, built on the fedslo primitives:

- **Burn-rate comparison** (:mod:`.slo`): each objective rule's bad
  fraction is computed for both streams at bucket resolution; the
  candidate *violates* a rule when it both blows the rule's own error
  budget (by ``burn_min``×) AND is materially worse than the baseline
  (``ratio_min``× the baseline's bad fraction plus an absolute floor —
  a baseline already on fire must not launder the candidate).
- **Bucket-level two-sample test**: a chi-square homogeneity test over
  the (merged-label) histogram buckets of the primary objective metric,
  so a latency *shift* shows up even when both streams stay inside the
  SLO.  The p-value uses the Wilson–Hilferty normal approximation
  (stdlib ``math.erfc``) — exact enough at these counts, zero deps.
- **Audit log**: every verdict appends one JSONL record (timestamp,
  verdict, per-rule evidence, the test statistic, both streams' counts)
  — the machine-readable trail an operator replays when a rollback is
  questioned.  :func:`validate_audit_log` is the schema witness tests
  and the bench both run.

Decision table: any violated rule with a significant shift ⇒
``rollback``; no violations and enough traffic ⇒ ``promote``
(a significant but *favorable or in-budget* shift does not block);
otherwise ⇒ ``extend``.  Pure stdlib, host floats only.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, Iterable, List, Optional

from .histogram import Histogram, _le_key, merge_bucket_entries
from .slo import objective_budget, validate_objective

#: audit-record schema — every JSONL line carries exactly these keys
AUDIT_KEYS = ("ts", "verdict", "adapter", "metric", "baseline",
              "candidate", "rules", "shift", "meta")
VERDICTS = ("promote", "rollback", "extend")


def _norm_stream(stream) -> Dict[str, Any]:
    """Accept a :class:`Histogram`, a snapshot map, or a single bucket
    entry; return one merged-across-labels bucket entry."""
    if isinstance(stream, Histogram):
        stream = stream.snapshot()
    if isinstance(stream, dict) and "buckets" in stream:
        return stream
    if isinstance(stream, dict):
        merged = merge_bucket_entries(list(stream.values()))
        if merged is None:
            return {"buckets": [], "sum": 0.0, "count": 0}
        return merged
    raise TypeError(f"cannot read metric stream of type {type(stream)}")


def _bad_fraction(entry: Dict[str, Any], threshold: float
                  ) -> Optional[float]:
    """Fraction of samples above ``threshold``, at bucket resolution
    (good = cumulative count at the smallest bound ≥ threshold)."""
    total = int(entry.get("count", 0))
    if total <= 0:
        return None
    good = 0
    for le, cum in sorted(entry["buckets"], key=lambda b: _le_key(b[0])):
        if _le_key(le) >= threshold:
            good = cum
            break
    return (total - good) / total


def chi2_two_sample(a: Dict[str, Any], b: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """Chi-square homogeneity test over two bucket entries sharing one
    ``le`` grid.  Adjacent sparse buckets pool until every expected cell
    ≥ 5 (the textbook validity rule); returns the statistic, degrees of
    freedom, and a Wilson–Hilferty p-value."""
    les_a = [le for le, _c in a["buckets"]]
    les_b = [le for le, _c in b["buckets"]]
    if les_a != les_b:
        raise ValueError("two-sample test needs identical boundaries")
    def widths(entry):
        out, prev = [], 0
        for _le, cum in sorted(entry["buckets"],
                               key=lambda x: _le_key(x[0])):
            out.append(cum - prev)
            prev = cum
        return out
    ca, cb = widths(a), widths(b)
    na, nb = sum(ca), sum(cb)
    if na == 0 or nb == 0:
        return {"stat": 0.0, "df": 0, "p_value": 1.0, "cells": 0}
    # pool adjacent buckets until each pooled column's total expected
    # count supports the approximation
    pooled: List[List[int]] = []
    run = [0, 0]
    for xa, xb in zip(ca, cb):
        run[0] += xa
        run[1] += xb
        tot = run[0] + run[1]
        if tot * na / (na + nb) >= 5 and tot * nb / (na + nb) >= 5:
            pooled.append(run)
            run = [0, 0]
    if run != [0, 0]:
        if pooled:
            pooled[-1][0] += run[0]
            pooled[-1][1] += run[1]
        else:
            pooled.append(run)
    if len(pooled) < 2:
        return {"stat": 0.0, "df": 0, "p_value": 1.0,
                "cells": len(pooled)}
    stat = 0.0
    for xa, xb in pooled:
        tot = xa + xb
        ea = tot * na / (na + nb)
        eb = tot * nb / (na + nb)
        stat += (xa - ea) ** 2 / ea + (xb - eb) ** 2 / eb
    df = len(pooled) - 1
    # Wilson–Hilferty: ((X/df)^(1/3) - (1 - 2/(9df))) / sqrt(2/(9df)) ~ N(0,1)
    z = (((stat / df) ** (1.0 / 3.0) - (1.0 - 2.0 / (9.0 * df)))
         / math.sqrt(2.0 / (9.0 * df)))
    p = 0.5 * math.erfc(z / math.sqrt(2.0))
    return {"stat": round(stat, 4), "df": df,
            "p_value": round(min(max(p, 0.0), 1.0), 6),
            "cells": len(pooled)}


class CanaryJudge:
    """The promote/rollback/extend decision function (module docstring
    has the decision table)."""

    def __init__(self, rules: Iterable[Dict[str, Any]],
                 audit_path: Optional[str] = None,
                 min_count: int = 20, alpha: float = 0.01,
                 burn_min: float = 1.0, ratio_min: float = 2.0,
                 abs_floor: float = 0.02, clock=time.time):
        self.rules = [r for r in rules if r.get("objective")]
        if not self.rules:
            raise ValueError("CanaryJudge needs at least one "
                             "objective-style rule")
        for r in self.rules:
            validate_objective(r["objective"],
                               where=r.get("name", "rule"))
        self.audit_path = audit_path
        self.min_count = int(min_count)
        self.alpha = float(alpha)
        self.burn_min = float(burn_min)
        self.ratio_min = float(ratio_min)
        self.abs_floor = float(abs_floor)
        self._clock = clock

    def judge(self, baseline, candidate, adapter: str = "candidate",
              meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Compare two metric streams for the primary objective metric
        (``baseline``/``candidate``: :class:`Histogram`, snapshot map,
        or bucket entry) and return the verdict record (also appended
        to the audit log when one is configured)."""
        base = _norm_stream(baseline)
        cand = _norm_stream(candidate)
        rule_rows: List[Dict[str, Any]] = []
        violated = False
        for rule in self.rules:
            obj = rule["objective"]
            budget = objective_budget(obj)
            thr = float(obj["threshold"])
            bf_base = _bad_fraction(base, thr)
            bf_cand = _bad_fraction(cand, thr)
            row: Dict[str, Any] = {
                "name": rule.get("name", obj["metric"]),
                "metric": obj["metric"], "threshold": thr,
                "budget": budget, "baseline_bad_fraction": bf_base,
                "candidate_bad_fraction": bf_cand,
                "baseline_burn": (bf_base / budget
                                  if bf_base is not None else None),
                "candidate_burn": (bf_cand / budget
                                   if bf_cand is not None else None),
            }
            v = (bf_cand is not None
                 and bf_cand > budget * self.burn_min
                 and bf_cand > ((bf_base or 0.0) * self.ratio_min
                                + self.abs_floor))
            row["violated"] = bool(v)
            violated = violated or v
            rule_rows.append(row)

        shift = chi2_two_sample(base, cand) if base["buckets"] \
            and cand["buckets"] else {"stat": 0.0, "df": 0,
                                      "p_value": 1.0, "cells": 0}
        significant = shift["p_value"] < self.alpha
        enough = (int(base.get("count", 0)) >= self.min_count
                  and int(cand.get("count", 0)) >= self.min_count)

        if violated and (significant or not enough):
            # a budget blowout with a confirmed distribution shift is a
            # regression; a blowout on thin evidence still must not
            # promote — keep the canary and keep watching
            verdict = "rollback" if significant else "extend"
        elif violated:
            verdict = "rollback"
        elif not enough:
            verdict = "extend"
        else:
            verdict = "promote"

        record = {
            "ts": float(self._clock()),
            "verdict": verdict,
            "adapter": str(adapter),
            "metric": self.rules[0]["objective"]["metric"],
            "baseline": {"count": int(base.get("count", 0)),
                         "sum": float(base.get("sum", 0.0))},
            "candidate": {"count": int(cand.get("count", 0)),
                          "sum": float(cand.get("sum", 0.0))},
            "rules": rule_rows,
            "shift": dict(shift, alpha=self.alpha,
                          significant=significant),
            "meta": dict(meta or {}),
        }
        if self.audit_path:
            append_audit(self.audit_path, record)
        return record


def append_audit(path: str, record: Dict[str, Any]) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(record, sort_keys=True) + "\n")


def validate_audit_log(path: str) -> List[Dict[str, Any]]:
    """Load + schema-check a JSONL audit log; raises ``ValueError`` on
    the first malformed record.  Returns the records."""
    out: List[Dict[str, Any]] = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}")
            missing = [k for k in AUDIT_KEYS if k not in rec]
            if missing:
                raise ValueError(f"{path}:{lineno}: audit record "
                                 f"missing {missing}")
            if rec["verdict"] not in VERDICTS:
                raise ValueError(f"{path}:{lineno}: unknown verdict "
                                 f"{rec['verdict']!r}")
            if not isinstance(rec["rules"], list) or not rec["rules"]:
                raise ValueError(f"{path}:{lineno}: empty rules "
                                 "evidence")
            out.append(rec)
    return out
