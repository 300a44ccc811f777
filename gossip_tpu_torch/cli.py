"""Command line of the port: ``python -m gossip_tpu_torch run ...``.

The port of the JAX package's ``run`` command on one device::

    python -m gossip_tpu_torch run --mode pull --n 10000000 [--engine E] \\
        [--family F] [--k K] [--p P] [--degree-cap D] [--rumors R]
        [--fanout F] [--period T] [--seed S] [--origin O] [--target C]
        [--max-rounds M] [--drop P] [--death D] [--curve]
        [--rumor-k K] [--rumor-variant feedback|blind]
        [--swim-subjects S] [--swim-proxies K] [--swim-suspect-rounds T]
        [--swim-rotate] [--swim-epoch-rounds E]
        [--swim-diss scatter|sort|pack] [--swim-rng split|packed]
        [--dead-nodes ID...] [--fail-round R]
        [--churn-event NODE:DIE[:REC]]... [--partition START:END:CUT]...
        [--drop-ramp START:END:P0:P1] [--device cpu]

``--mode`` is one of the five SI modes, ``swim`` or ``rumor``, and
``--engine`` one of ``auto|xla|fused`` (default ``auto``;
``backend.run_simulation``).  The flags, their defaults and their parse
are the JAX command's (``--drop-prob`` is another name for ``--drop``;
``--swim-suspect-rounds 0`` is ``suggested_suspect_rounds(n, fanout)``
for SWIM and 4 otherwise).  The topology and the fault take ``--seed``
as their seeds too, as the JAX command sets them.  The three churn flags
build a fault program (``ChurnConfig``), which runs on the xla engine
(``auto`` takes it; ``fused`` refuses it).
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
    fault = None
    if a.drop > 0 or a.death > 0 or a.dead_nodes or churn is not None:
        fault = FaultConfig(node_death_rate=a.death, drop_prob=a.drop,
                            seed=a.seed, dead_nodes=tuple(a.dead_nodes or ()),
                            fail_round=a.fail_round, churn=churn)
    t = a.swim_suspect_rounds
    if not t and a.mode == C.SWIM:
        from gossip_tpu_torch.models.swim import suggested_suspect_rounds
        t = suggested_suspect_rounds(a.n, a.fanout)
    report = run_simulation(
        ProtocolConfig(mode=a.mode, fanout=a.fanout, rumors=a.rumors,
                       period=a.period, swim_subjects=a.swim_subjects,
                       swim_proxies=a.swim_proxies,
                       swim_suspect_rounds=t or 4,
                       swim_rotate=a.swim_rotate,
                       swim_epoch_rounds=a.swim_epoch_rounds,
                       swim_diss=a.swim_diss, swim_rng=a.swim_rng,
                       rumor_k=a.rumor_k, rumor_variant=a.rumor_variant),
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
    p.add_argument("--mode", default=C.PUSH, choices=C.MODES)
    p.add_argument("--rumor-k", type=int, default=2,
                   help="rumor mongering: remove a rumor after this many "
                        "unnecessary (feedback) or total (blind) pushes")
    p.add_argument("--rumor-variant", default="feedback",
                   choices=C.RUMOR_VARIANTS)
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--engine", default="auto", choices=("auto", "xla",
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
    p.add_argument("--drop", "--drop-prob", type=float, default=0.0,
                   help="per-message drop probability per round")
    p.add_argument("--death", type=float, default=0.0,
                   help="fraction of nodes statically dead")
    p.add_argument("--swim-subjects", type=int, default=8)
    p.add_argument("--swim-proxies", type=int, default=3)
    p.add_argument("--swim-suspect-rounds", type=int, default=0,
                   help="0 = use suggested_suspect_rounds(n)")
    p.add_argument("--swim-rotate", action="store_true",
                   help="rotate the subject window over all n nodes "
                        "(full-membership failure detection)")
    p.add_argument("--swim-epoch-rounds", type=int, default=0,
                   help="rounds per rotating-window epoch (0 = auto)")
    p.add_argument("--swim-diss", choices=("scatter", "sort", "pack"),
                   default="sort",
                   help="dissemination lowering (equal results)")
    p.add_argument("--swim-rng", choices=("split", "packed"),
                   default="split",
                   help="per-round draws: one threefry chain per quantity "
                        "(split) or one multi-word draw per node (packed)")
    p.add_argument("--dead-nodes", nargs="*", type=int, default=None,
                   metavar="ID",
                   help="node ids that fail at --fail-round (swim scenario; "
                        "default: node 1%%S fails at round 2)")
    p.add_argument("--fail-round", type=int, default=0)
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
