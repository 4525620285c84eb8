"""Shared benchmark artifact writer + claims gate.

Every ``BENCH_*.json`` artifact has the same shape::

    {"bench": <suite>, "metric": <units of the row columns>,
     "config": {...}, "claims": {...},
     "rows": [{"name", "us_per_call", "derived"}, ...]}

Historically each suite hand-rolled this dump (and the anchor gate in
``tools/check_anchors.py`` re-implemented the claim lookups); the
helpers here are the one implementation the per-suite ``write_artifact``
shims, ``benchmarks.run``, and the anchor gate all delegate to.  Lives
in ``repro`` (not ``benchmarks/``) so ``repro_torch.control.sweep`` can reach
it without a path dance.
"""

from __future__ import annotations

import json
import sys


def write_bench_artifact(
    out: str,
    bench: str,
    rows: list[tuple],
    metric: str | None = None,
    claims: dict | None = None,
    config: dict | None = None,
    extra: dict | None = None,
) -> None:
    """Write one ``BENCH_*.json`` artifact in the common schema.

    ``rows`` are ``(name, us_per_call, derived)`` triples; ``claims``
    and ``config`` are included only when given (older artifacts omit
    them); ``extra`` merges additional top-level keys (e.g. a manifest's
    ``artifacts`` map)."""
    doc: dict = {"bench": bench}
    if metric is not None:
        doc["metric"] = metric
    if config is not None:
        doc["config"] = config
    if claims is not None:
        doc["claims"] = claims
    if extra:
        doc.update(extra)
    doc["rows"] = [
        {"name": n, "us_per_call": u, "derived": d} for n, u, d in rows
    ]
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"# wrote {out}", file=sys.stderr)


def gate_claims(path_or_doc, gates: list[tuple]) -> list[str]:
    """Check recorded claims against bounds; returns readable errors.

    ``gates`` entries are ``(claim_key, op, bound, message)`` where op is
    one of ``">="``, ``"<="``; a missing claim is itself an error.  Used
    by ``tools/check_anchors.py`` so each new suite doesn't re-implement
    the lookup/compare/format dance."""
    if isinstance(path_or_doc, dict):
        doc = path_or_doc
    else:
        try:
            with open(path_or_doc) as f:
                doc = json.load(f)
        except OSError:
            return [f"  missing artifact {path_or_doc}"]
    claims = doc.get("claims", {})
    errors = []
    for key, op, bound, message in gates:
        val = claims.get(key)
        if val is None:
            errors.append(f"  claim {key} missing")
            continue
        ok = val >= bound if op == ">=" else val <= bound
        if not ok:
            errors.append(
                f"  {message} ({key} = {val:.3g}, wanted {op} {bound:.3g})"
            )
    return errors
