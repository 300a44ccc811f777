"""Command line of the port: ``python -m gossip_tpu_torch run ...``.

The port of the JAX package's ``run`` command on the fused pull routes::

    python -m gossip_tpu_torch run --mode pull --n 10000000 --engine fused \\
        [--rumors R] [--fanout F] [--drop-prob P] [--curve] [--device cpu]

It prints the report's JSON on one line, as the JAX command does.  Any
other flag or value is refused with exit code 2, and so is a run the
backend refuses (with its reason on stderr).  Without ``--device cpu``
the run needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

from gossip_tpu_torch.config import (FaultConfig, ProtocolConfig, RunConfig,
                                     TopologyConfig)


def cmd_run(a) -> int:
    from gossip_tpu_torch.backend import run_simulation
    fault = FaultConfig(drop_prob=a.drop_prob) if a.drop_prob else None
    report = run_simulation(
        ProtocolConfig(mode=a.mode, fanout=a.fanout, rumors=a.rumors),
        TopologyConfig(family="complete", n=a.n),
        RunConfig(engine=a.engine), fault, want_curve=a.curve,
        device=a.device)
    print(json.dumps(report.to_dict()))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gossip_tpu_torch",
        description="gossip simulation on PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="run one simulation")
    p.add_argument("--mode", required=True, choices=("pull",))
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--engine", required=True, choices=("fused",))
    p.add_argument("--fanout", type=int, default=1)
    p.add_argument("--rumors", type=int, default=1,
                   help="concurrent rumors (up to 32, one word per node)")
    p.add_argument("--drop-prob", type=float, default=0.0,
                   help="per-pull drop probability")
    p.add_argument("--curve", action="store_true",
                   help="run exactly max_rounds rounds and include the "
                        "per-round coverage curve")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cpu runs the round's plain version (default: "
                        "cuda, which must be present)")
    p.set_defaults(fn=cmd_run)
    a = ap.parse_args(argv)
    try:
        return a.fn(a)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
