"""Crashloop: the nemesis pointed at the simulator's own process.

The port's copy of the JAX package's ``tools/crashloop.py``.  It
launches a checkpointed run of the port's command line under the mixed
fault program (a crash and recovery, a permanent crash, a partition
window and a drop ramp), SIGKILLs the process at randomized round
thresholds, resumes after each kill, and checks the crash contract
(:mod:`gossip_tpu_torch.utils.checkpoint`):

* the final checkpoint is bitwise the uninterrupted run's: every array
  and the whole metadata entry (the configuration fingerprint, the
  absolute round cursor, the exact ``dropped`` total), and the report's
  coverage, msgs, rounds, dropped and fault-program digest;
* the coverage of the eventual-alive set is 1.0 in both runs;
* the run ledger parses strictly, with the harness's provenance first,
  and holds one ``kill`` and one ``resume`` event a cycle, each at the
  durable round cursor of the crash leg's last ``checkpoint`` event
  before it (the children write their flight records into the same
  file through ``GOSSIP_TELEMETRY``).

Kill points are round thresholds drawn from ``--kill-seed``, one in each
equal slice of the rounds: the harness polls the checkpoint's durable
cursor, waits for that checkpoint's ledger event, and SIGKILLs the child
while its next segment runs::

    python -m gossip_tpu_torch.tools.crashloop --n 4096 --max-rounds 12 \\
        --every 4 --kills 1 --poll-ms 2 --device cpu

It prints one JSON line (``ok``, the kills, the coverage, ``dropped``,
the ledger's path and the legs' walls) and exits 0, or names each broken
gate on stderr and exits 1.  Without ``--device cpu`` the children run on
the card.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from gossip_tpu_torch.utils import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# a wedged child fails the harness instead of hanging it
LEG_TIMEOUT_S = 900


def churn_flags(n: int, rounds: int) -> list:
    """The mixed fault program, scaled to the run (the reference's)."""
    heal = max(4, rounds // 2)
    return ["--churn-event", f"3:2:{heal}",
            "--churn-event", "7:3",
            "--partition", f"{max(2, rounds // 6)}:{heal}:{n // 2}",
            "--drop-ramp", f"1:{max(3, rounds // 3)}:0.0:0.15"]


def cli_argv(a, ckpt: str, resume: bool) -> list:
    argv = [sys.executable, "-m", "gossip_tpu_torch", "run",
            "--mode", a.mode, "--n", str(a.n), "--fanout", "2",
            "--max-rounds", str(a.max_rounds), "--seed", str(a.seed),
            "--checkpoint", ckpt, "--checkpoint-every", str(a.every)]
    if a.devices > 1:
        argv += ["--devices", str(a.devices)]
    if a.device:
        argv += ["--device", a.device]
    argv += churn_flags(a.n, a.max_rounds)
    if resume:
        argv.append("--resume")
    return argv


def durable_round(ckpt: str) -> int:
    """The checkpoint's absolute round cursor, -1 before the first
    durable segment (the atomic replace never hands over a torn file)."""
    try:
        with np.load(ckpt, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
        return int(meta.get("extra", {}).get("round", -1))
    except Exception:
        return -1


def _checkpoint_rounds(ledger: str, ckpt: str) -> list:
    """The rounds of the ``checkpoint`` events of ``ckpt`` in the ledger,
    in file order."""
    try:
        events = telemetry.load_ledger(ledger)
    except FileNotFoundError:
        return []
    return [e["round"] for e in events
            if e.get("ev") == "checkpoint" and e.get("path") == ckpt]


def run_to_completion(argv, env) -> dict:
    p = subprocess.run(argv, capture_output=True, text=True, env=env,
                       timeout=LEG_TIMEOUT_S)
    if p.returncode != 0:
        raise RuntimeError(f"leg failed rc={p.returncode}:\n{p.stderr}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def kill_at_round(argv, env, ckpt: str, ledger: str, threshold: int,
                  max_rounds: int, log_prefix: str, poll_s: float = 0.01):
    """Launch a leg and SIGKILL it once the durable cursor reaches
    ``threshold`` and the ledger holds that checkpoint's event.  Returns
    ``(killed, observed round, stale tmp, wall s)``; ``killed`` False
    means the leg finished (or made its last checkpoint durable) first,
    and a kill then would interrupt nothing.  The child's output goes
    to files, so a full pipe never blocks it.  The child runs in a
    session of its own and the whole session is killed, so no rank it
    spawned is left."""
    t0 = time.perf_counter()
    with open(log_prefix + ".out", "wb") as fo, \
            open(log_prefix + ".err", "wb") as fe:
        proc = subprocess.Popen(argv, stdout=fo, stderr=fe, env=env,
                                start_new_session=True)
        try:
            while True:
                rc = proc.poll()
                r = durable_round(ckpt)
                if rc is not None:
                    if rc != 0:
                        err = open(log_prefix + ".err",
                                   errors="replace").read()
                        raise RuntimeError(
                            f"leg died on its own rc={rc}:\n{err}")
                    return False, r, False, time.perf_counter() - t0
                if time.perf_counter() - t0 > LEG_TIMEOUT_S:
                    raise RuntimeError(
                        f"leg exceeded {LEG_TIMEOUT_S}s without reaching "
                        f"round {threshold}")
                if r >= max_rounds:
                    proc.wait()
                    return False, r, False, time.perf_counter() - t0
                if r >= threshold and r in _checkpoint_rounds(ledger, ckpt):
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
                    stale = os.path.exists(ckpt + ".tmp")
                    # the cursor the resume continues from
                    return (True, durable_round(ckpt), stale,
                            time.perf_counter() - t0)
                time.sleep(poll_s)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def assert_bitwise_equal(ref_ckpt: str, crash_ckpt: str) -> list:
    """Every array and the metadata entry must match bitwise."""
    problems = []
    with np.load(ref_ckpt, allow_pickle=False) as a, \
            np.load(crash_ckpt, allow_pickle=False) as b:
        if sorted(a.files) != sorted(b.files):
            return [f"entry sets differ: {sorted(a.files)} vs "
                    f"{sorted(b.files)}"]
        for name in a.files:
            if name == "__meta__":
                ma, mb = json.loads(str(a[name])), json.loads(str(b[name]))
                if ma != mb:
                    problems.append(f"metadata differs: {ma} vs {mb}")
            elif not np.array_equal(np.asarray(a[name]),
                                    np.asarray(b[name])):
                problems.append(f"array {name!r} differs")
    return problems


def ledger_problems(path: str, run_id: str, crash_ckpt: str,
                    kills: int) -> list:
    """The flight-recorder gates: strict parse, the harness's provenance
    first, one ``kill`` and one ``resume`` a cycle, each at the round of
    the crash leg's last ``checkpoint`` event before it."""
    try:
        events = telemetry.load_ledger(path, strict=True)
    except ValueError as e:
        return [f"ledger does not parse: {e}"]
    if not events or events[0].get("ev") != "provenance" \
            or events[0].get("run") != run_id:
        return ["the ledger's first line is not the harness's provenance"]
    problems = []
    last = None
    pairs = {"kill": [], "resume": []}
    for e in events:
        if e.get("ev") == "checkpoint" and e.get("path") == crash_ckpt:
            last = e["round"]
        elif e.get("run") == run_id and e.get("ev") in pairs:
            pairs[e["ev"]].append(e)
            if e["durable_round"] != last:
                problems.append(
                    f"{e['ev']} {e['seq']} at durable round "
                    f"{e['durable_round']}, but the last checkpoint event "
                    f"before it is at round {last}")
    for kind, got in pairs.items():
        if len(got) != kills:
            problems.append(f"{len(got)} {kind} events for {kills} kills")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384,
                    help="node count; large enough that a segment outlasts "
                         "the poller")
    ap.add_argument("--mode", default="pushpull")
    ap.add_argument("--max-rounds", type=int, default=60)
    ap.add_argument("--every", type=int, default=5)
    ap.add_argument("--kills", type=int, default=3)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--kill-seed", type=int, default=12,
                    help="seeds the kill thresholds (a failing sequence "
                         "replays exactly)")
    ap.add_argument("--poll-ms", type=float, default=10.0,
                    help="cursor poll interval; well under a segment's "
                         "wall")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the children's device (default: the card)")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint and log directory (default: a fresh "
                         "temporary directory)")
    ap.add_argument("--out", default=None,
                    help="the ledger (default: WORKDIR/crashloop.jsonl)")
    a = ap.parse_args(argv)

    a.workdir = a.workdir or tempfile.mkdtemp(prefix="crashloop_")
    os.makedirs(a.workdir, exist_ok=True)
    out = os.path.abspath(a.out or os.path.join(a.workdir, "crashloop.jsonl"))
    ref_ckpt = os.path.abspath(os.path.join(a.workdir, "reference.npz"))
    crash_ckpt = os.path.abspath(os.path.join(a.workdir, "crashloop.npz"))
    for p in (ref_ckpt, crash_ckpt, crash_ckpt + ".tmp"):
        if os.path.exists(p):
            os.remove(p)

    led = telemetry.Ledger(out)
    # the children write their flight records into this ledger
    env = dict(os.environ, GOSSIP_TELEMETRY=out)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    rng = random.Random(a.kill_seed)
    # one threshold in each equal slice of the rounds before the last
    # segment (a later one could only fire on the final checkpoint)
    lo, hi = a.every, max(a.every + 1, a.max_rounds - a.every)
    pool = []
    for i in range(a.kills):
        s0 = lo + (hi - lo) * i // a.kills
        s1 = max(s0 + 1, lo + (hi - lo) * (i + 1) // a.kills)
        pool.append(rng.randrange(s0, s1))
    pool.sort()
    led.event("config", n=a.n, mode=a.mode, max_rounds=a.max_rounds,
              every=a.every, kills=a.kills, devices=a.devices,
              device=a.device, seed=a.seed, kill_seed=a.kill_seed,
              kill_thresholds=pool, churn=churn_flags(a.n, a.max_rounds))

    t0 = time.perf_counter()
    ref = run_to_completion(cli_argv(a, ref_ckpt, resume=False), env)
    ref_wall = time.perf_counter() - t0
    led.event("reference_done", wall_s=round(ref_wall, 3),
              coverage=ref["coverage"], rounds=ref["rounds"],
              dropped=ref.get("dropped"),
              fault_program=ref.get("fault_program"))

    kills_done, kill_rounds, legs = 0, [], []
    resume = False
    for threshold in pool:
        # each leg publishes at least one new segment before its kill
        threshold = max(threshold, durable_round(crash_ckpt) + 1)
        if resume:
            led.event("resume", seq=kills_done,
                      durable_round=durable_round(crash_ckpt))
        killed, at, stale, wall = kill_at_round(
            cli_argv(a, crash_ckpt, resume=resume), env, crash_ckpt, out,
            threshold, a.max_rounds,
            os.path.join(a.workdir, f"leg{kills_done + 1}"),
            poll_s=a.poll_ms / 1000.0)
        legs.append(round(wall, 3))
        if not killed:
            led.event("completed_before_kill", threshold=threshold,
                      durable_round=at, wall_s=round(wall, 3))
            break
        kills_done += 1
        kill_rounds.append(at)
        led.event("kill", seq=kills_done, threshold=threshold,
                  durable_round=at, stale_tmp=stale, wall_s=round(wall, 3))
        resume = True
    t0 = time.perf_counter()
    if resume:
        led.event("resume", seq=kills_done,
                  durable_round=durable_round(crash_ckpt))
    final = run_to_completion(cli_argv(a, crash_ckpt, resume=resume), env)
    legs.append(round(time.perf_counter() - t0, 3))
    led.event("resume_done" if resume else "run_done",
              resumed_from=kill_rounds[-1] if kill_rounds else None,
              wall_s=legs[-1], coverage=final["coverage"],
              dropped=final.get("dropped"))

    problems = assert_bitwise_equal(ref_ckpt, crash_ckpt)
    if kills_done < a.kills:
        problems.append(f"only {kills_done}/{a.kills} kills landed (raise "
                        "--max-rounds or --n, or lower --every)")
    if any(k >= a.max_rounds for k in kill_rounds):
        problems.append(f"a kill landed after the final checkpoint "
                        f"(durable rounds {kill_rounds})")
    for name, rep in (("crashloop", final), ("reference", ref)):
        if rep["coverage"] != 1.0:
            problems.append(f"the {name} leg did not converge on the "
                            f"eventual-alive set: coverage="
                            f"{rep['coverage']}")
    for key in ("coverage", "msgs", "rounds", "dropped", "fault_program"):
        if ref.get(key) != final.get(key):
            problems.append(f"report {key!r} differs: {ref.get(key)} vs "
                            f"{final.get(key)}")
    led.event("verdict", ok=not problems, kills=kills_done,
              bitwise_equal=not [p for p in problems if "differ" in p],
              coverage=final["coverage"], dropped=final.get("dropped"),
              problems=problems)
    run_id = led.run_id
    led.close()
    # the ledger's own gates, read back as a reader would
    problems += ledger_problems(out, run_id, crash_ckpt, kills_done)
    if problems:
        for p in problems:
            print(f"CRASHLOOP FAIL: {p}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "kills": kills_done,
                      "kill_rounds": kill_rounds,
                      "coverage": final["coverage"],
                      "dropped": final.get("dropped"), "ledger": out,
                      "reference_wall_s": round(ref_wall, 3),
                      "leg_walls_s": legs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
