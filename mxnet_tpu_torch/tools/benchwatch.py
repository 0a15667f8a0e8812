"""Replay the committed bench history through the regression sentinel.

Ported from ``tools/benchwatch.py``; run it as ``python -m
mxnet_tpu_torch.tools.benchwatch`` from the repository root. It rebuilds
the per-(metric, config) trajectories from the repo's ``BENCH_*.json``
files (round order, the Emitter JSONL tail included when present) and
prints the verdict each line would have received at the moment it
landed — the verdict-then-absorb sequence
:func:`mxnet_tpu_torch.telemetry.regress.stamp_line` runs live. Three
uses:

* **post-mortem**: rerun after a round to see which trajectories moved
  (dead rounds show up as ``no_value`` lines carrying their error, not
  as silent gaps);
* **pre-merge**: point it at a candidate bench line (``--line file``)
  to judge it against committed history before the file is committed;
* **CI sentinel**: exit code 9 when the *latest* point of any
  trajectory is a confirmed regression, 0 otherwise.

Exit codes: 0 clean, 9 confirmed regression at head, 2 usage error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..telemetry import regress


def _fmt_value(v):
    if v is None:
        return "-"
    if isinstance(v, float):
        return "%.4g" % v
    return str(v)


def _fmt_row(source, verdict):
    tag = verdict["verdict"]
    if verdict.get("confirmed"):
        tag = tag.upper()
    delta = verdict.get("delta_pct")
    delta_s = "%+.1f%%" % (delta * 100) if isinstance(delta, float) else ""
    return "%-28s %-42s %10s %-22s %8s  %s" % (
        source[:28], str(verdict.get("metric"))[:42],
        _fmt_value(verdict.get("value")), tag, delta_s,
        (verdict.get("error") or "")[:60])


def replay(paths, args):
    """Chronological replay: every line gets its at-the-time verdict.

    Returns ``(verdicts, head)`` where *verdicts* is the full list (in
    replay order, each tagged with its source file) and *head* maps each
    trajectory key to its final verdict — the rc gate judges only the
    head, so an old regression that later recovered does not fail a
    clean tree forever.
    """
    store = regress.TrajectoryStore()
    verdicts = []
    head = {}
    for path in paths:
        source = os.path.basename(path)
        for line in regress.iter_bench_lines(path):
            verdict = store.verdict(line)
            verdict["source"] = source
            key = store.add(line, source=source)
            verdicts.append(verdict)
            if key is not None:
                head[key] = verdict
    return verdicts, head


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="benchwatch",
        description="replay bench history through the regression sentinel")
    parser.add_argument("paths", nargs="*",
                        help="history files to replay in order "
                             "(default: the repo's BENCH_*.json, round "
                             "order, plus the Emitter JSONL if present)")
    parser.add_argument("--line", metavar="FILE", action="append",
                        default=[],
                        help="judge FILE's bench line(s) against the "
                             "replayed history (appended last, so its "
                             "verdicts see the full committed history)")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON document instead of the table")
    parser.add_argument("--all", action="store_true",
                        help="print every verdict, not just "
                             "noteworthy ones (non-ok, or head of a "
                             "trajectory)")
    args = parser.parse_args(argv)

    paths = args.paths or regress.default_paths()
    missing = [p for p in list(paths) + list(args.line)
               if not os.path.exists(p)]
    if missing:
        parser.error("no such history file: %s" % ", ".join(missing))
    if not paths:
        parser.error("no history files found (no BENCH_*.json in repo "
                     "root and none given)")
    paths = list(paths) + list(args.line)

    verdicts, head = replay(paths, args)
    head_verdicts = set(map(id, head.values()))
    regressed = sorted("%s [%s]" % (v.get("metric"), v.get("config"))
                       for v in head.values() if v.get("confirmed"))

    if args.json:
        doc = {"paths": paths, "points": len(verdicts),
               "trajectories": len(head),
               "regressions_at_head": regressed,
               "verdicts": verdicts, "rc": 9 if regressed else 0}
        json.dump(doc, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        print("%-28s %-42s %10s %-22s %8s  %s" % (
            "source", "metric", "value", "verdict", "delta", "error"))
        shown = 0
        for v in verdicts:
            noteworthy = (v["verdict"] not in ("ok",)
                          or id(v) in head_verdicts)
            if args.all or noteworthy:
                print(_fmt_row(v["source"], v))
                shown += 1
        if shown < len(verdicts):
            print("(%d unremarkable verdict(s) hidden; --all shows them)"
                  % (len(verdicts) - shown))
        print("replayed %d point(s) across %d trajectorie(s) from %d "
              "file(s)" % (len(verdicts), len(head), len(paths)))
        if regressed:
            print("CONFIRMED REGRESSION at head of: %s"
                  % "; ".join(regressed))
        else:
            print("no confirmed regressions at head")

    return 9 if regressed else 0


if __name__ == "__main__":
    sys.exit(main())
