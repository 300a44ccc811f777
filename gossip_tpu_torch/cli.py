"""Command line of the port: ``python -m gossip_tpu_torch run ...``.

The port of the JAX package's ``run`` command on one device::

    python -m gossip_tpu_torch run --mode pull --n 10000000 --engine xla \\
        [--family F] [--k K] [--p P] [--degree-cap D] [--rumors R]
        [--fanout F] [--period T] [--seed S] [--origin O] [--target C]
        [--max-rounds M] [--drop-prob P] [--death D] [--curve]
        [--churn-event NODE:DIE[:REC]]... [--partition START:END:CUT]...
        [--drop-ramp START:END:P0:P1] [--device cpu]

``--mode`` is one of the five SI modes and ``--engine`` one of
``auto|xla|fused`` (``backend.run_simulation``).  The topology and the
fault take ``--seed`` as their seeds too, as the JAX command sets them.
The three churn flags build a fault program (``ChurnConfig``), which runs
on the xla engine (``auto`` takes it; ``fused`` refuses it).
It prints the report's JSON on one line, as the JAX command does.  Any
other flag or value is refused with exit code 2, and so is a run the
backend refuses (with its reason on stderr).  Without ``--device cpu``
the run needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import (ChurnConfig, FaultConfig,
                                     ProtocolConfig, RunConfig,
                                     TopologyConfig)


def _parse_churn(a) -> Optional[ChurnConfig]:
    """``--churn-event`` / ``--partition`` / ``--drop-ramp`` -> a
    :class:`ChurnConfig`, or None without any (the JAX command's parse;
    the checks of the fields live in ``ChurnConfig``)."""
    def fields(s, what, lens):
        parts = s.split(":")
        if len(parts) not in lens:
            raise ValueError(
                f"--{what} takes {'|'.join(map(str, sorted(lens)))} "
                f"colon-separated fields, got {s!r}")
        return parts

    events = []
    for s in (getattr(a, "churn_event", None) or ()):
        parts = fields(s, "churn-event", {2, 3})
        if len(parts) == 2:
            parts.append("-1")
        events.append(tuple(int(x) for x in parts))
    partitions = [tuple(int(x) for x in fields(s, "partition", {3}))
                  for s in (getattr(a, "partition", None) or ())]
    ramp = None
    if getattr(a, "drop_ramp", None):
        f = fields(a.drop_ramp, "drop-ramp", {4})
        ramp = (int(f[0]), int(f[1]), float(f[2]), float(f[3]))
    if not (events or partitions or ramp):
        return None
    return ChurnConfig(events=tuple(events), partitions=tuple(partitions),
                       ramp=ramp)


def cmd_run(a) -> int:
    from gossip_tpu_torch.backend import run_simulation
    churn = _parse_churn(a)
    fault = (FaultConfig(node_death_rate=a.death, drop_prob=a.drop_prob,
                         seed=a.seed, churn=churn)
             if a.drop_prob > 0 or a.death > 0 or churn is not None
             else None)
    report = run_simulation(
        ProtocolConfig(mode=a.mode, fanout=a.fanout, rumors=a.rumors,
                       period=a.period),
        TopologyConfig(family=a.family, n=a.n, k=a.k, p=a.p,
                       degree_cap=a.degree_cap, seed=a.seed),
        RunConfig(target_coverage=a.target, max_rounds=a.max_rounds,
                  seed=a.seed, origin=a.origin, engine=a.engine),
        fault, want_curve=a.curve, device=a.device)
    print(json.dumps(report.to_dict()))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gossip_tpu_torch",
        description="gossip simulation on PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="run one simulation")
    p.add_argument("--mode", required=True, choices=C.SI_MODES)
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--engine", required=True, choices=("auto", "xla",
                                                       "fused"))
    p.add_argument("--family", default=C.COMPLETE, choices=C.FAMILIES)
    p.add_argument("--k", type=int, default=4,
                   help="ring/WS neighbors; BA attachment edges")
    p.add_argument("--p", type=float, default=0.01,
                   help="ER edge prob / WS rewire prob")
    p.add_argument("--degree-cap", type=int, default=None)
    p.add_argument("--fanout", type=int, default=1)
    p.add_argument("--rumors", type=int, default=1,
                   help="concurrent rumors (fused: up to 32, one word per "
                        "node)")
    p.add_argument("--period", type=int, default=1,
                   help="anti-entropy exchange period (rounds)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--origin", type=int, default=0)
    p.add_argument("--target", type=float, default=0.99)
    p.add_argument("--max-rounds", type=int, default=256)
    p.add_argument("--drop-prob", type=float, default=0.0,
                   help="per-message drop probability per round")
    p.add_argument("--death", type=float, default=0.0,
                   help="fraction of nodes statically dead")
    p.add_argument("--churn-event", action="append", default=None,
                   metavar="NODE:DIE[:REC]",
                   help="scripted crash/recover churn: NODE dies at round "
                        "DIE and recovers at round REC (omit REC or pass "
                        "-1 for a permanent crash); repeatable")
    p.add_argument("--partition", action="append", default=None,
                   metavar="START:END:CUT",
                   help="network partition window: for rounds [START, END) "
                        "every message crossing node-id CUT is lost; "
                        "repeatable, windows must not overlap")
    p.add_argument("--drop-ramp", default=None, metavar="START:END:P0:P1",
                   help="drop-rate ramp: link drop probability moves "
                        "linearly P0 -> P1 over rounds [START, END), then "
                        "holds P1")
    p.add_argument("--curve", action="store_true",
                   help="run exactly max_rounds rounds and include the "
                        "per-round coverage curve")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cpu runs the plain versions (default: cuda, which "
                        "must be present)")
    p.set_defaults(fn=cmd_run)
    a = ap.parse_args(argv)
    try:
        return a.fn(a)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
