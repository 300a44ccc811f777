"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in this checkout,
holds each bitwise against its plain PyTorch version at N = 10M, drives
the flagship run (single-rumor pull gossip to 99% coverage), the
multi-rumor run (32 rumors, to 99% min-over-rumors coverage), the
threefry-keyed XLA engine (with its threefry sampler and with the
sampling kernel, without and under a fault program), SWIM failure
detection and rumor mongering, the CRDT payloads (with the byzantine
liar program), the replicated logs and the LWW registers' txn workload,
the node-sharded drivers at K = 1 (NCCL) and K = 2 (two ranks on the
card under gloo), SWIM, rumor and the payloads among them, the sparse
all_to_all and halo ppermute exchanges, the fused rumor planes, the
sweep axis (seed ensembles, config grids, churn sweeps), and the
roofline tool through the port's own entry
points, and measures them.  One JSON line per phase:

1. ``device``  the card, as ``nvidia-smi`` and torch name it;
2. ``build``   every kernel's build (seven entry points from five
   sources, and the measurement variants of ``csrc/fused_mr_parts.cu``,
   one ``nvcc`` per source, started together);
3. ``checks``  one kernel round against the plain version on the card,
   bitwise (tolerance 0), at N = 10M and 10M - 37, once for every
   instantiation the launcher picks: fanout 1, plane sharing 1 on the
   Philox stream with each combination of the drop coin, alive and cut
   tables; the generic one at fanout 2 and plane sharing 2 (and with all
   three operands), and under injected bits (once with every draw's drop
   coin at the threshold or one below it); then the kernel's time per
   round, the plain version's, the bound, and the static SASS counts of
   the main path's instantiations; and, for measurement only, the generic
   instantiation's time at fanout 2 under deaths and drops;
4. ``main_path``  ``run_simulation`` at N = 10M, pull, fanout 1, seed 0,
   target 0.99, with every launch count set to 0 just before and read
   just after; then the same loop replayed round by round with the
   plain version, the cost of the loop's once-per-round host read, and
   the kernel's share of the loop's wall (rounds x kernel time / wall);
5. ``bench``   the node-rounds/s line of ``gossip_tpu_torch.bench``;
6. ``mr_build``  the two multi-rumor kernels' build reports;
7. ``mr_checks``  both multi-rumor kernels against their plain versions
   on the card, bitwise, at N = 10M and 10M - 37 with 32 rumors, fanout
   1 to 5 (every instantiation of the value kernel's operand path), each
   combination of the drop coin, alive and cut words, and under injected
   bits (and at the coin boundary), each case with its instantiation's
   dynamic shared memory and resident blocks per SM: the lane-major
   kernel the loops launch against ``fused_mr_round_lanes_plain``,
   ``fused_multirumor_pull_round`` (the kernel between two transposes)
   and the whole staged round against ``fused_mr_round_plain`` (the
   routes draw one stream), the gather pass against its plain version,
   and every per-rumor counter against the plain counts; then each
   kernel's time (the value kernel's as the loops launch it,
   lane-major), its plain version's, its bound, the staged route's torch
   rotation, and the value kernel's static SASS counts;
7b. ``mr_parts``  the value kernel's operand path at CF256's operands
   (10M x 32, ``churn_heal``'s round 1) broken down by part: the
   replaced generic instantiation and the redesign, each beside
   variants with a part knocked out (``csrc/fused_mr_parts.cu``), each
   operand set apart, fanout 1 and 2, and a table of whole waves; with
   each instantiation's shared memory and resident blocks per SM;
8. ``mr_routes``  both routes' time per round at 10M x 32 and 1M x 32,
   fanout 1 and 2, as a loop pays it (the value route on the loops'
   lane-major buffers), the value kernel's own time at each,
   and the routing rule those times give; the port's loops take the value
   route at every size, so the phase fails where the staged route is
   faster;
9. ``mr_main_path``  ``run_simulation`` at N = 10M, 32 rumors, pull,
   fanout 1, seed 0, target 0.99, counts set to 0 just before and read
   just after; on the same line, the same loop replayed through the
   plain version, the loop's time (``until_fused_multirumor`` and the
   curve loop), its host read per round and node-rounds/s;
10. ``mr_staged_path``  the main path's rounds stepped through the staged
   round ``fused_mr_round_big`` (counts set to 0 just before and read
   just after), which must end in the same table;
11. ``sampler_checks``  the sampling kernel (``csrc/sampler.cu``) against
   its plain version on the card, bitwise, at n = 10M and 10M - 37, k = 1
   and 3, self-exclusion on and off, three seed scalars (a wrapped
   negative one among them), and under injected zero, all-ones and
   random bits; the chi-square of a 10M-draw stream; then its time, its
   plain version's, its bound and ``torch.randint``'s time;
12. ``xla_main_path``  ``run_simulation`` with ``engine='xla'`` at
   N = 10M and 1M, pull, fanout 1, seed 0, target 0.99, which must give
   the JAX package's rounds, coverage and msgs (``XLA_10M``,
   ``XLA_1M``); at 100,000 nodes the card's final states of pull,
   anti-entropy and pull with drops and deaths equal the port's CPU
   runs; then the
   round's time split (threefry draw, gather, requests, coverage read)
   and the packed bench loop;
13. ``xla_sampler_path``  ``compiled_until_packed(sampler="kernel")`` at
   N = 10M, counts set to 0 just before and read just after: one sampler
   launch a round, 25-30 rounds to 99%, and the same table as a replay
   with the plain sampler; its time per round against threefry's;
14. ``churn_path``  the JAX package's ``churn_heal`` fault program
   (``bench.heal_fault``: two churn events, one of them permanent, a
   partition at n/2 for rounds [0, 6), a drop ramp) on the XLA engine:
   ``run_simulation`` at N = 10M and 1M with ``engine='xla'`` and
   ``'auto'``, which must give the JAX package's rounds, coverage and
   msgs (``HEAL_10M``, ``HEAL_1M``) on the bit-packed loop, and
   ``engine='fused'`` refused; the card's final states against the CPU's,
   bitwise (the packed pull at 100,000 nodes under the program, the bool
   push-pull
   and anti-entropy with period 2 under the four mixed scenario shapes
   at 10,000 nodes); no node at or above the cut informed before round
   6 at 10M, and some after it; the kernel-sampler loop at 10M under the
   program (counts set to 0 just before and read just after: one
   sampler launch a round, rounds within 2 of threefry's, coverage of
   the eventual alive set at least 0.99, the same table and msgs as a
   replay composed from the plain sampler); each loop's ms per round,
   and one round's parts (partner draw, coin, schedule masks, gather,
   lost count, coverage read);
15. ``swim_rumor_path``  SWIM failure detection at BASELINE.json's
   configuration 4 (power-law table, N = 1M, k 3, degree cap 256,
   fanout 2, 8 subjects, 3 proxies, suspicion 24 rounds) and rumor
   mongering at N = 10M (fanout 1, ``rumor_k`` 2) through
   ``run_simulation`` with ``engine='auto'``: SW1-SW4 (the ``sort``,
   ``pack`` and ``packed``-rng runs and a churn program with a ramp) and
   RM1-RM3 (feedback, blind, and under ``churn_heal``) must give the JAX
   package's rounds, coverage and msgs (``SWIM_CASES``,
   ``RUMOR_CASES``) with no kernel launched, SW1 and RM1 again through
   ``python -m gossip_tpu_torch run``; the card against the CPU at
   10,000 nodes, every state field (SWIM with the rotating window and
   the packed rng under drops; rumor under the four mixed scenario
   shapes); each run's ms a round and node-rounds/s, and one SWIM
   round's parts at SW1's shape (draws, each dissemination lowering, the
   detection read);
16. ``crdt_log_path``  the JAX package's ``crdt`` and ``log`` command
   lines (``CRDT_LOG_CASES``: counters and an OR-set at their documents'
   sizes, CR4's G-counter at n = 65,536 (two ``int32[n, n]`` states,
   34.4 GB), a liar program defended and not at 16 nodes and at 65,536,
   the logs at up to 100,000 nodes) through the port's ``crdt`` and
   ``log`` commands on the card, each against the JAX package's rounds,
   convergence, truth and msgs (CR1's curve too), no kernel launched;
   CR1 and LG1 again through ``python -m gossip_tpu_torch``; the final
   state of CR1, CR2, CR3, LG2, BZ1d, BZ1u, BZ2u and BZ2d equal to the
   port's CPU run, every field; CR4 through ``simulate_until_crdt`` with
   its peak of allocated memory (at most 2.1 states: a round holds the
   state, its successor and one block); each run's ms a round and
   node-rounds/s, and one round's parts at CR4's and CR3's shapes;
17. ``txn_path``  the JAX package's ``txn`` command lines (``TXN_CASES``:
   its documents' deployments, the liar program defended and not with
   every liar kind, ``inflate`` past int32 among them, and the defaults
   and TX2's program at N = 10M, two ``int32[10M, 16]`` states) through
   the port's ``txn`` command on the card, each against the JAX
   package's rounds, txn_conv, truth and msgs (TX1's and TX3's curves
   too), no kernel launched; the final state of the ten small ids equal
   to the port's CPU run, every field; TX1 and TX10M again through
   ``python -m gossip_tpu_torch txn``; TX10M through
   ``simulate_until_txn`` with its peak of allocated memory beside the
   state's bytes and a bare partner draw's peak; each run's ms a round
   and node-rounds/s, and one round's parts at TX10M's and TX10Mh's
   deployments (partner draw, coin, the round's own exchange, the
   converged count);
18. ``fused_deaths``  one single-rumor and one 32-rumor fused run at
   N = 10M with ``node_death_rate=0.1`` against their plain replays, the
   stop test's counter-read coverage against a recount, and their ms per
   round;
19. ``mesh_k1`` and ``mesh_path``  the node-sharded drivers
   (``gossip_tpu_torch.parallel``): at K = 1 under NCCL through the
   library API, the packed and the dense while-loop at N = 10M, which
   must print ``XLA_10M`` and end in the single-device state; at K = 2
   ranks sharing this card under gloo, ``python -m gossip_tpu_torch run
   --devices 2 --share-card`` for BASELINE.json's configuration 5 (10M x
   32 rumors, the packed loop) and the dense curve at 10M (30 rounds),
   which must print the JAX package's values on its 2-device mesh
   (``MESH_CFG5``, ``MESH_CURVE``), and the same runs through the
   library API, whose final states must equal the single-device port
   runs'; each run's ms a round, its all_gather's ms a round and every
   rank's peak allocated memory, with the single-device runs' ms a round;
   then ``mesh_models``, the sharded SWIM, rumor and payload drivers:
   K = 2 ranks on this card through ``--devices 2 --share-card`` for
   SW1, RM1, CR3, LG1 and TX1 (TX1's curve too), each printing the JAX
   package's values on its 2-device mesh (``MESH_*``); TX10M, BZ2d, SW1
   and RM1 through the library API in one spawn, each rank's SHA-256 of
   its padded final rows equal to the single-device state's window (the
   earlier phases' runs); CR4 and TX10M at K = 1 under NCCL, CR4's peak
   allocated memory at most 4.1 states; each run's ms a round, each
   collective's ms a round by name and every rank's peak, beside the
   single-device run's ms a round, no kernel launched, and the largest
   G-counter n the gather design allows; then ``mesh_exchanges``, the
   sparse and halo exchanges at K = 2 ranks on this card: the command
   lines of ``EXCHANGE_CASES`` (SP5 ``BASELINE.json`` configuration 5 and
   SPCH its ``churn_heal`` program on the sparse all_to_all exchange,
   SPAE anti-entropy with 33 rumors, TS3 configuration 3's
   Watts-Strogatz table on the capacity-capped buckets, HL1 the 1M-node
   halo ring), each printing the JAX package's values on its 2-device
   mesh (``MESH_SP5`` ... ``MESH_HL1``, TS3's overflow and bucket cap
   too); the same runs through the library API in one spawn, each
   rank's SHA-256 of its padded final rows equal to the window of the
   single-device state on the card (the sparse twin at p = 2, HL1's XLA
   run); each run's ms a round, collectives by name, bytes a round and
   peaks, beside the dense exchange's ms a round, no kernel launched;
   then ``mesh_fused_planes``, the fused rumor planes at the README's
   N = 10M x 256 rumors (``FP_CASES``: FP256, FPD with static deaths and
   drops, FPCH under the ``churn_heal`` program): K = 1 under NCCL through
   the library API (8 planes on one rank, counts set to 0 just before and
   read just after: 8 ``fused_mr_round`` launches a round and nothing
   else), FP256's and FPD's planes equal to the single-device
   multi-rumor loop on each plane and FP256's rounds the planes' largest
   rounds to the target; ``run --engine fused --devices 2 --share-card``
   for the three and the same through the library API in one spawn
   (FP256's curve beside them), every rank's plane digests equal to
   K = 1's and every rank launching ``fused_mr_round`` 4 x its rounds and
   nothing else; FPD's first two rounds and FPCH's first eight (every
   change of its program) against the plain lane-major round on the same
   operands, the planes, each rumor's count from the kernel's counters
   and the curve; each K = 1 coverage against the final planes' least
   count in plain float32; the PRNG invariant holding at K = 2 and
   raising when each rank takes its own seed; the planes' refusals (push
   rounds, a table, an exchange, scripted dead nodes); each run's ms a
   round, collectives by name, launches and peaks;
20. ``sweeps``  the sweep axis (``gossip_tpu_torch.parallel.sweep``) at
   the README's commands: EN32 (``run --mode pushpull --n 10000
   --ensemble 32``), EN10M (8 seeds of the 10M pull flagship, 32
   rounds), ES32 and ER32 (SWIM and rumor ensembles of 32 at 100,000
   nodes), GR12 (``grid --modes push pull pushpull --fanouts 1 2 --drops
   0 0.1``) at n = 4096 and at 10M (40 rounds), GRF (the families grid
   at 100,000 nodes), GRP (the pod sweep on the 2 x 1 and 1 x 2 hybrid
   meshes), CS8 (the JAX bench's churn_sweep family) and CS10M (four
   programs at 10M), CF256 (``churn-sweep --engine fused`` at 10M x 256
   rumors, fanout 2, at K = 1 under NCCL and K = 2 sharing the card).
   Every point of GR12 at 4096 and CS8 equals its solo run on the card,
   bitwise; the first and last of the others; K = 2 equals K = 1;
   CF256's scenarios equal the fused curve driver's, every rank
   launching ``fused_mr_round`` W_local x its rounds and nothing else,
   and kernel 2 at fanout 2 under ``churn_heal``'s alive, cut and
   threshold operands equals its plain round for 8 rounds; that
   instantiation's time and the fanout-1 one's (FPCH's) under the same
   operands, each with its operand-counted bound, shared memory and
   resident blocks per SM.  One line a run: rounds to the target, the
   batch's ms a round beside S x the solo run's, the threefry draw's
   share, peaks, collectives, launches;
21. ``roofline_checks`` and ``roofline``  the three calibration
   microkernels (``csrc/calibrate.cu``) against their plain versions on
   the card, bitwise, at rows n_rows(10M) = 2448 and 8, on the stream at
   i = 0, 3 and 2^31 - 1 and under injected zero and random bits; their
   SASS instruction counts, recounted from the build, against
   ``SASS_PER_WORD``, every opcode in a pipe list; their times, plain
   times and bounds; then ``python -m gossip_tpu_torch.tools.roofline``
   at N = 10M and 100M (its document on one line each, also written to
   ``chiprun_out/``), counts set to 0 just before and read just after,
   with hard checks: every kernel launched as often as the tool issued,
   the stream beyond L2 and each microkernel's ALU and FMA pipe rates at
   most 105% of the datasheet and its instructions at most 105% of two
   pipes' issue, no microkernel faster than its bound, and each measured
   round (single rumor at plane sharing 1 and 2, the value round, the
   staged round) at least 95% of its calibrated floor.

Then the ``kernels`` line (each round kernel with its calibrated floor
``floor_ms`` from the 10M document), and last ``{"ok": true, "device":
...}``.  Any failed check raises, and the exit code is not 0.  Without a
CUDA device, or without the repository around it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N = 10_000_000
SEED = 0
CHECK_ROUND = 3           # a round other than 0, so the key's k1 is not 0
INFECTED = 0.03           # share of nodes infected in the checks' table
TIMED_LAUNCHES = 20       # launches per timed batch
TIMED_BATCHES = 9         # batches; the median batch is reported
RUMORS = 32
N_SMALL = 1_000_000       # the second size of the route comparison
N_REPLAY = 100_000        # the packed loops held card against CPU (cut
                          # for the card's host, which runs them slowly)
N_BIG = 100_000_000       # the roofline's second size
ROUTE_ROUNDS = 10         # rounds per timed route batch
# (rounds, coverage, msgs) of the JAX package's XLA engine, jax 0.9.0 on
# the CPU: run_simulation('jax-tpu', ProtocolConfig(mode='pull',
# fanout=1), TopologyConfig(family='complete', n=N), RunConfig(
# engine='xla', seed=0, target_coverage=0.99)), meta.engine
# 'bit-packed'.  Threefry does not depend on the platform, so the port
# must print the same on the card.
XLA_10M = (27, 0.9992427229881287, 540000000.0)
XLA_1M = (23, 0.9972720146179199, 46000000.0)
# The same for the packed pull loop under the JAX package's churn_heal
# fault program (gossip_tpu_torch/bench.heal_fault; its bench.py
# run_churn_families), through models/si_packed.simulate_until_packed,
# pull, fanout 1, seed 0, target 0.99, max_rounds 128, jax 0.9.0 on the
# CPU.  Under a program the run report's coverage is of the eventual alive
# set (node 2 never recovers).
HEAL_10M = (31, 0.9948086738586426, 506505408.0)
HEAL_1M = (27, 0.9948830008506775, 43450920.0)
N_MIXED = 10_000          # the bool churn runs held card against CPU
# (rounds, coverage, msgs) of the JAX package's sharded drivers on its
# 2-device CPU mesh, jax 0.9.0: `python -m gossip_tpu run --devices 2
# --mode pull --rumors 32 --n 10000000 --engine xla` (BASELINE.json's
# configuration 5 on the packed sharded while-loop, meta.engine
# 'bit-packed'), and `python -m gossip_tpu run --devices 2 --mode pull
# --n 10000000 --engine xla --curve --max-rounds 30` (the dense sharded
# scan) with its curve.  At K = 1 the sharded loop prints XLA_10M.
MESH_CFG5 = (30, 0.9967684745788574, 600000000.0)
MESH_CURVE_ROUNDS = 30
MESH_CURVE = (27, 1.0, 600000000.0)
MESH_CURVE_VALUES = [
    1.0000000116860974e-07, 2.0000000233721948e-07, 4.0000000467443897e-07,
    9.000000318337698e-07, 1.500000053056283e-06, 2.7999999474559445e-06,
    5.8999999055231456e-06, 1.3300000318849925e-05, 2.769999991869554e-05,
    5.539999983739108e-05, 0.00011130000348202884, 0.00021919999562669545,
    0.0004346999921835959, 0.0008762000361457467, 0.0017433000029996037,
    0.003514900105074048, 0.0070189000107347965, 0.013964700512588024,
    0.027675800025463104, 0.0545882023870945, 0.10630229860544205,
    0.20125950872898102, 0.362029105424881, 0.593006432056427,
    0.8343884944915771, 0.9725527167320251, 0.9992427229881287,
    0.999998927116394, 1.0, 1.0]
# (rounds, coverage, msgs) of the JAX package's SWIM and rumor runs, jax
# 0.9.0 on the CPU, through its run_simulation('jax-tpu', ...) with
# engine 'auto' (its `run` command lines below).  SW1 is BASELINE.json's
# configuration 4 and also the JAX package's TPU run
# (artifacts/swim_ab_r04.json).  SWIM: power-law table, 1M nodes, k=3,
# degree cap 256, fanout 2, 8 subjects, 3 proxies, suspicion 24 rounds,
# max_rounds 80, the default scenario (node 1 fails at round 2).
N_SWIM = 1_000_000
SWIM_CASES = {
    "SW1": ({}, None, (31, 0.9953849911689758, 163843776.0)),
    "SW2": ({"swim_diss": "pack"}, None,
            (31, 0.9953849911689758, 163843776.0)),
    "SW3": ({"swim_rng": "packed"}, None,
            (31, 0.9953460097312927, 163877280.0)),
    # --churn-event 1:2 --churn-event 3:1:6 --drop-ramp 0:4:0:0.05
    "SW4": ({}, "churn", (31, 0.9953849911689758, 184213936.0)),
}
# Rumor mongering at 10M, fanout 1, rumor_k 2, max_rounds 128; RM3 under
# the churn_heal program (bench.heal_fault, the cut at n / 2).
RUMOR_CASES = {
    "RM1": ("feedback", None, (41, 0.9518542885780334, 30345156.0)),
    "RM2": ("blind", None, (62, 0.7967361807823181, 15934724.0)),
    "RM3": ("feedback", "heal", (48, 0.9507429003715515, 30120180.0)),
}
N_MODELS_SMALL = 10_000   # the SWIM and rumor runs held card against CPU
# The CRDT payloads and the replicated logs: the JAX package's `crdt` and
# `log` command lines (its documents' deployments: CR1 and LG2
# docs/WORKLOADS.md:117 and :224, CR2 README.md:291, CR3
# docs/WORKLOADS.md:126, CR4 README.md:290 with n cut from 100,000 to
# 65,536 so that two int32[n, n] states fit the card, BZ1
# docs/ROBUSTNESS.md:373 with and without --defend, BZ2 CR3's deployment
# with BZ1's liars, LG1 README.md:300, LG3 docs/WORKLOADS.md:228) and
# their (rounds, value_conv or log_conv, truth_value or truth, msgs),
# jax 0.9.0 on the CPU.  Threefry does not depend on the platform, so the
# port must print the same on the card.
_BYZ = ["--byz", "3:2:inflate:5", "--byz", "11:0:corrupt:1048576"]
_BZ1 = ["crdt", "--type", "gcounter", "--n", "16", "--fanout", "3",
        "--max-rounds", "100", "--churn-event", "4:6:12", *_BYZ]
_BZ2 = ["crdt", "--type", "orset", "--elements", "256", "--set-remove",
        "5:3", "--n", "65536", "--fanout", "3", *_BYZ]
_HEAL = ["--churn-event", "3:2:5", "--drop-ramp", "1:4:0.0:0.3"]
CRDT_LOG_CASES = {
    "CR1": (["crdt", "--type", "gcounter", "--n", "4096", "--partition",
             "0:6:2048", *_HEAL, "--curve"], (24, 1.0, 16381, 705870.0)),
    "CR2": (["crdt", "--type", "pncounter", "--n", "4096", *_HEAL],
            (20, 1.0, 3, 243652.0)),
    "CR3": (["crdt", "--type", "orset", "--elements", "256", "--set-remove",
             "5:3", "--n", "65536"], (16, 1.0, 255, 4194304.0)),
    "CR4": (["crdt", "--type", "gcounter", "--n", "65536", "--partition",
             "0:6:32768"], (21, 1.0, 262139, 4720758.0)),
    "BZ1d": ([*_BZ1, "--defend"], (26, 1.0, 59, 2460.0)),
    "BZ1u": (_BZ1, (100, 0.0, 59, 9564.0)),
    "BZ2u": (_BZ2, (64, 0.0, 255, 25165824.0)),
    "BZ2d": ([*_BZ2, "--defend"], (64, 0.0, 255, 25165824.0)),
    "LG1": (["log", "--n", "100000", "--keys", "8", "--partition",
             "0:6:50000"], (20, 1.0, {"lens": [4] * 8, "committed": [2] * 8,
                                      "total_entries": 32}, 6799524.0)),
    "LG2": (["log", "--n", "4096", "--keys", "4", "--capacity", "16",
             "--partition", "0:8:2048", *_HEAL],
            (24, 1.0, {"lens": [4, 4, 4, 4], "committed": [2, 2, 0, 2],
                       "total_entries": 16}, 236676.0)),
    "LG3": (["log", "--n", "64", "--keys", "2", "--send", "0:0:0:9",
             "--send", "1:0:1:4", "--commit", "2:0:3:1"],
            (8, 1.0, {"lens": [2, 0], "committed": [1, 0],
                      "total_entries": 2}, 2048.0)),
}
# the ids whose final state on the card must equal the port's CPU run
CRDT_LOG_REPLAYS = ("CR1", "CR2", "CR3", "LG2", "BZ1d", "BZ1u", "BZ2u",
                    "BZ2d")
# the curves the runs must print
PAYLOAD_CURVES = {
    "CR1": [0.0] * 16 + [0.004638671875, 0.1904296875, 0.649169921875,
                         0.927001953125, 0.991943359375, 0.998046875,
                         0.999755859375] + [1.0] * 41,
    "TX1": [0.0] * 14 + [5e-05, 0.00329, 0.06239, 0.41504, 0.87444,
                         0.99807] + [1.0] * 44,
    "TX3": [0.0] * 10 + [0.0009765625, 0.0146484375, 0.1201171875,
                         0.541015625, 0.935546875] + [1.0] * 49,
}
# The LWW registers: the JAX package's `txn` command lines (TX1
# README.md:340, TX2 docs/WORKLOADS.md:392, TX3 docs/WORKLOADS.md:397,
# TX4 README.md:342, TXB1 README.md:353 with and without --defend, TXB2
# BZ1's program of docs/ROBUSTNESS.md:373 on registers, TXB3 the other
# liar kinds with inflate past int32, TX10M the defaults of
# docs/WORKLOADS.md:404 at the north star's N on one device, TX10Mh
# TX2's program at N = 10M with the cut at n / 2) and their (rounds,
# txn_conv, truth, msgs), jax 0.9.0 on the CPU.
_T8 = {"values": [71, 62, 68, 12, 0, 0, 0, 1],
       "ts_round": [7, 5, 4, 7, -1, -1, -1, 2],
       "ts_owner": [0, 5, 10, 15, -1, -1, -1, 35], "written_keys": 5}
_T6 = {"values": [71, 62, 58, 12, 0, 76], "ts_round": [7, 5, 3, 7, -1, 2],
       "ts_owner": [0, 5, 10, 15, -1, 9], "written_keys": 5}
_TXB = ["txn", "--n", "16", "--keys", "6", "--fanout", "3", "--max-rounds",
        "100"]
_TXB23 = [*_TXB, "--churn-event", "4:6:12"]
_TX2 = ["--partition", "0:8:2048", *_HEAL]
TXN_CASES = {
    "TX1": (["txn", "--n", "100000", "--keys", "8", "--partition",
             "0:6:50000", "--curve"], (21, 1.0, _T8, 24399524.0)),
    "TX2": (["txn", "--n", "4096", "--keys", "8", *_TX2],
            (23, 1.0, _T8, 225172.0)),
    "TX3": (["txn", "--n", "1024", "--zipf-alpha", "1.4", "--hot-key", "0.5",
             "--load", "diurnal", "--curve"],
            (16, 1.0, {"values": [71, 62, 1, 0, 0, 0, 87, 0],
                       "ts_round": [6, 5, 7, -1, -1, -1, 2, -1],
                       "ts_owner": [1, 5, 10, -1, -1, -1, 30, -1],
                       "written_keys": 4}, 262144.0)),
    "TX4": (["txn", "--n", "16", "--keys", "2", "--write", "3:0:1:9",
             "--write", "5:0:1:7"],
            (4, 1.0, {"values": [7, 0], "ts_round": [1, -1],
                      "ts_owner": [5, -1], "written_keys": 1}, 256.0)),
    "TXB1d": ([*_TXB, "--byz", "11:0:corrupt:1048576", "--defend"],
              (32, 1.0, _T6, 3072.0)),
    "TXB1u": ([*_TXB, "--byz", "11:0:corrupt:1048576"],
              (100, 0.0, _T6, 9600.0)),
    "TXB2d": ([*_TXB23, *_BYZ, "--defend"], (32, 1.0, _T6, 3036.0)),
    "TXB2u": ([*_TXB23, *_BYZ], (100, 0.0, _T6, 9564.0)),
    "TXB3u": ([*_TXB23, "--byz", "3:2:inflate:200000000", "--byz",
               "7:1:equivocate", "--byz", "9:0:replay"],
              (100, 0.0, _T6, 9564.0)),
    "TXB3d": ([*_TXB23, "--byz", "3:2:inflate:200000000", "--byz",
               "7:1:equivocate", "--byz", "9:0:replay", "--defend"],
              (100, 0.0625, _T6, 9564.0)),
    "TX10M": (["txn", "--n", str(N), "--keys", "8"],
              (24, 1.0, _T8, 960000000.0)),
    "TX10Mh": (["txn", "--n", str(N), "--keys", "8", "--partition",
                f"0:8:{N // 2}", *_HEAL], (33, 1.0, _T8, 829985856.0)),
}
TXN_REPLAYS = ("TX1", "TX2", "TX3", "TX4", "TXB1d", "TXB1u", "TXB2d",
               "TXB2u", "TXB3u", "TXB3d")
# (rounds, coverage or convergence, [truth,] msgs) of the JAX package's
# sharded drivers on its 2-device CPU mesh, jax 0.9.0:
# XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu
# python -m gossip_tpu <command> --devices 2 with, for
#   MESH_SW1: run --mode swim --n 1000000 --family power_law --k 3
#     --degree-cap 256 --fanout 2 --swim-subjects 8 --swim-proxies 3
#     --swim-suspect-rounds 24 --max-rounds 80 (msgs differ from SW1's:
#     the mesh adds the two shards' float32 partials);
#   MESH_RM1: run --mode rumor --n 10000000 --fanout 1 --rumor-k 2
#     --max-rounds 128;
#   MESH_CR3: crdt --type orset --elements 256 --set-remove 5:3 --n 65536;
#   MESH_BZ2D: BZ2d's command (crdt --type orset --elements 256
#     --set-remove 5:3 --n 65536 --fanout 3 --byz 3:2:inflate:5 --byz
#     11:0:corrupt:1048576 --defend);
#   MESH_LG1: log --n 100000 --keys 8 --partition 0:6:50000;
#   MESH_TX1: txn --n 100000 --keys 8 --partition 0:6:50000 --curve (its
#     curve is PAYLOAD_CURVES["TX1"]);
#   MESH_TX10M: txn --n 10000000 --keys 8.
MESH_SW1 = (31, 0.9953849911689758, 163843728.0)
MESH_RM1 = (41, 0.9518542885780334, 30345156.0)
MESH_CR3 = (16, 1.0, 255, 4194304.0)
MESH_BZ2D = (64, 0.0, 255, 25165824.0)
MESH_LG1 = (20, 1.0, {"lens": [4] * 8, "committed": [2] * 8,
                      "total_entries": 32}, 6799524.0)
MESH_TX1 = (21, 1.0, _T8, 24399524.0)
MESH_TX10M = (24, 1.0, _T8, 960000000.0)

# The sparse and halo exchanges' deployments at K = 2 (each command line
# plus --devices 2 --share-card) and the JAX package's values for them on
# its 2-device CPU mesh, jax 0.9.0: XLA_FLAGS=
# --xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu python -m
# gossip_tpu run --devices 2 with, for
#   MESH_SP5 (BASELINE.json configuration 5): --mode pull --rumors 32
#     --n 10000000 --engine xla --exchange sparse;
#   MESH_SPCH (the churn_heal program on the sparse exchange): --mode
#     pull --n 10000000 --drop 0.02 --churn-event 1:1:4 --churn-event 2:2
#     --partition 0:6:5000000 --drop-ramp 0:4:0:0.1 --exchange sparse;
#   MESH_SPAE (the sparse_antientropy family, __graft_entry__.py:889):
#     --mode antientropy --fanout 2 --rumors 33 --period 2 --n 1000000
#     --exchange sparse;
#   MESH_TS3 (BASELINE.json configuration 3, with its overflow and bucket
#     cap): --mode antientropy --n 100000 --family watts_strogatz --k 6
#     --p 0.1 --period 2 --exchange sparse;
#   MESH_HL1 (README.md's halo ring): --mode pushpull --family ring --k 6
#     --n 1000000 --exchange halo (no target reached in 256 rounds).
MESH_SP5 = (28, 0.9989855289459229, 560000000.0)
MESH_SPCH = (32, 0.9954994916915894, 524506432.0)
MESH_SPAE = (21, 0.9999989867210388, 66000000.0)
MESH_TS3 = (53, 0.9946500062942505, 8100000.0)
MESH_TS3_OVERFLOW, MESH_TS3_CAP = 0.0, 48523
MESH_HL1 = (256, 0.0009120000177063048, 512116608.0)
N_AE, N_TS3, N_HALO = 1_000_000, 100_000, 1_000_000
_HEAL_CUT = ["--drop-prob", "0.02", "--churn-event", "1:1:4",
             "--churn-event", "2:2", "--partition", f"0:6:{N // 2}",
             "--drop-ramp", "0:4:0:0.1"]
_TS3 = ["--mode", "antientropy", "--n", str(N_TS3), "--family",
        "watts_strogatz", "--k", "6", "--p", "0.1", "--period", "2"]
_HL1 = ["--mode", "pushpull", "--family", "ring", "--k", "6", "--n",
        str(N_HALO)]
EXCHANGE_CASES = {
    "SP5": (["--mode", "pull", "--rumors", str(RUMORS), "--n", str(N),
             "--engine", "xla", "--exchange", "sparse"], MESH_SP5),
    "SPCH": (["--mode", "pull", "--n", str(N), *_HEAL_CUT, "--exchange",
              "sparse"], MESH_SPCH),
    "SPAE": (["--mode", "antientropy", "--fanout", "2", "--rumors", "33",
              "--period", "2", "--n", str(N_AE), "--exchange", "sparse"],
             MESH_SPAE),
    "TS3": ([*_TS3, "--exchange", "sparse"], MESH_TS3),
    "HL1": ([*_HL1, "--exchange", "halo"], MESH_HL1),
}


# The fused rumor planes at the README's deployment (README.md:367: run
# --mode pull --n 10000000 --rumors 256 --engine fused --devices 8, here
# on the card's ranks): FP256 as it is, FPD with static deaths and drops,
# FPCH under the churn_heal program; each at K = 2 ranks sharing the card
# (--devices 2 --share-card) and at K = 1 under NCCL.
FP_RUMORS = 256
_FP = ["--mode", "pull", "--n", str(N), "--rumors", str(FP_RUMORS),
       "--engine", "fused"]
FP_CASES = {"FP256": _FP, "FPD": [*_FP, "--death", "0.1", "--drop", "0.05"],
            "FPCH": [*_FP, *_HEAL_CUT]}
# the cases replayed with the plain round, and their rounds: FPD's
# first two; FPCH's first eight, through every change of its program (a
# crash at 1 and 2, a recovery and the ramp's end at 4, the cut's at 6)
FP_REPLAY = {"FPD": 2, "FPCH": 8}
# what the planes refuse, before any rank starts, and a phrase of each
# refusal (the reference's words)
FP_REFUSED = {
    "push": (["--mode", "push"], "implements pull rounds only"),
    "erdos_renyi": (["--family", "erdos_renyi", "--p", "0.000001"],
                    "implicit complete topology only"),
    "sparse": (["--exchange", "sparse"], "implements no exchange"),
    "dead_nodes": (["--dead-nodes", "3", "--fail-round", "1"],
                   "does not implement scripted dead_nodes"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def kernel_ms(launch, graph: bool = False) -> float:
    """Median time of one launch on the card: batches of launches queued
    behind a device sleep (so the host's enqueue is off the clock), timed
    with CUDA events (``utils.timing.timed_chain``; ``graph``: a batch
    of many small torch launches, captured as one CUDA graph)."""
    from gossip_tpu_torch.utils.timing import timed_chain
    return 1e3 * timed_chain(lambda i, carry: launch(), None, TIMED_LAUNCHES,
                             "cuda", TIMED_BATCHES, graph)


def phase_checks(dev, n: int):
    """Kernel against plain on the card, bitwise, at n and n - 37, once
    for every instantiation the launcher can pick.  Returns the cases'
    results, their largest absolute difference, and the table at n."""
    import numpy as np
    import torch
    from gossip_tpu_torch.config import FaultConfig
    from gossip_tpu_torch.ops import fused_round as FR

    rng = np.random.default_rng(SEED)
    thr = FR.drop_threshold_for(FaultConfig(drop_prob=0.05))
    rows = FR.n_rows(n)
    inject = (
        rng.integers(0, 2**32, size=(8, FR.LANES), dtype=np.uint32),
        rng.integers(0, 2**32, size=(FR.BITS, rows, FR.LANES),
                     dtype=np.uint32))
    # every draw's coin field exactly at the threshold or one below it
    coin = np.where(rng.random(inject[1].shape) < 0.5, thr, thr - 1)
    boundary = (inject[0], (coin.astype(np.uint32) << np.uint32(12))
                | (inject[1] & np.uint32(0xFFF)))
    # (name, fanout, sharing, drop, alive, cut, inject): fanout 1,
    # sharing 1 on the stream takes the straight-line instantiation of its
    # operand set; the rest take the generic one of their plane sharing
    cases = [(f"f1_s1{'_drop' * d}{'_alive' * a}{'_cut' * c}" if d or a or c
              else "f1_s1", 1, 1, d, a, c, None)
             for d in (False, True) for a in (False, True)
             for c in (False, True)]
    cases += [("f2_s1", 2, 1, False, False, False, None),
              ("f1_s2", 1, 2, False, False, False, None),
              ("f2_s2", 2, 2, False, False, False, None),
              ("f2_s1_drop_alive_cut", 2, 1, True, True, True, None),
              ("inject", 1, 1, False, False, False, inject),
              ("inject_coin_boundary", 1, 1, True, False, False, boundary)]
    results, max_err, tables = [], 0, {}
    for m in (n, n - 37):
        tables[m] = FR.node_pack(
            torch.from_numpy(rng.random(m) < INFECTED).to(dev))
        alive = FR.node_pack(torch.from_numpy(rng.random(m) < 0.9).to(dev))
        cut = FR.render_cut_bits(m // 3, m, dev)
        for name, fanout, sharing, d, a, c, bits in cases:
            table = tables[m]
            t, a, c = thr if d else 0, alive if a else None, cut if c else None
            pop = torch.zeros(1, dtype=torch.int32, device=dev)
            got = FR.fused_pull_round(table, SEED, CHECK_ROUND, m, fanout,
                                      inject_bits=bits, drop_threshold=t,
                                      alive_table=a, plane_sharing=sharing,
                                      cut_words=c, pop=pop)
            want = FR.fused_pull_round_plain(table, SEED, CHECK_ROUND, m,
                                             fanout, bits, t, a, sharing, c)
            err = int((FR.to_words(got) - FR.to_words(want)).abs().max())
            equal = bool(torch.equal(got, want))
            pop_ok = int(pop.item()) == FR.popcount(want)
            grew = FR.popcount(want) - FR.popcount(table)
            results.append({
                "case": name, "n": m, "fanout": fanout, "sharing": sharing,
                "instantiation": ("straight line" if fanout == sharing == 1
                                  and bits is None else "generic"),
                "bitwise_equal": equal, "max_abs_err": err,
                "popcount_equal": pop_ok, "newly_infected": grew})
            check(equal and pop_ok and grew > 0,
                  f"kernel vs plain, {name} at n={m}")
            max_err = max(max_err, err)
    return results, max_err, tables[n]


def round_sass(kernel) -> dict:
    """The static SASS counts by pipe of the named instantiations in
    ``kernel``'s build (``tools/roofline.ROUND_SASS_TAGS``); their loop
    bodies run once a word."""
    from gossip_tpu_torch.tools import roofline as R
    return R.sass_counts(kernel.library(), R.ROUND_SASS_TAGS)


def random_mr_table(rng, n: int, dev):
    """A one-word-per-node table at n with every rumor bit set at rate
    1/32 (the AND of five random words), phantom words zero."""
    import numpy as np
    import torch
    from gossip_tpu_torch.ops import fused_mr_round as MR
    words = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    for _ in range(4):
        words &= rng.integers(0, 2**32, size=n, dtype=np.uint32)
    flat = np.zeros(MR.mr_rows(n) * MR.LANES, np.uint32)
    flat[:n] = words
    return torch.from_numpy(flat.view(np.int32).reshape(-1, MR.LANES)).to(dev)


def _words_err(a, b) -> int:
    from gossip_tpu_torch.ops.fused_round import to_words
    return int((to_words(a) - to_words(b)).abs().max())


def phase_mr_checks(dev, n: int):
    """Both multi-rumor kernels against their plain versions on the card,
    bitwise: the lane-major kernel against the lane-major plain round,
    the public round and the staged route against the plain value round.
    Returns the cases' results, each kernel's largest absolute
    difference, and the table at n."""
    import numpy as np
    import torch
    from gossip_tpu_torch.config import FaultConfig
    from gossip_tpu_torch.ops import _kernels, philox
    from gossip_tpu_torch.ops import fused_mr_round as MR
    from gossip_tpu_torch.ops.fused_round import drop_threshold_for

    rng = np.random.default_rng(SEED + 1)
    thr = drop_threshold_for(FaultConfig(drop_prob=0.05))
    rows = MR.mr_rows(n)
    inject = {f: (rng.integers(0, 2**32, size=(f, 8, MR.LANES),
                               dtype=np.uint32),
                  rng.integers(0, 2**32, size=(f, rows, MR.LANES),
                               dtype=np.uint32)) for f in (1, 2, 4, 5)}
    # every draw's coin field exactly at the threshold or one below it
    coin = np.where(rng.random(inject[1][1].shape) < 0.5, thr, thr - 1)
    boundary = (inject[1][0], (coin.astype(np.uint32) << np.uint32(12))
                | (inject[1][1] & np.uint32(0xFFF)))
    inject = {f: tuple(torch.from_numpy(b.view(np.int32)).to(dev)
                       for b in bits) for f, bits in inject.items()}
    boundary = tuple(torch.from_numpy(np.ascontiguousarray(b).view(np.int32))
                     .to(dev) for b in boundary)
    # (name, fanout, drop, alive, cut, inject): every operand combination
    # at fanout 1 to 5 (each instantiation of the operand path: fanout 1,
    # the one-Philox-call class 2-4, and the general one past 4, whose
    # fifth draw takes a second call), then injected (the general one)
    cases = [(f"f{f}{'_drop' * d}{'_alive' * a}{'_cut' * c}", f, d, a, c,
              None)
             for f in (1, 2, 3, 4, 5) for d in (False, True)
             for a in (False, True) for c in (False, True)]
    cases += [("inject_f1", 1, False, False, False, inject[1]),
              ("inject_f2_drop_alive_cut", 2, True, True, True, inject[2]),
              ("inject_f4_drop_alive_cut", 4, True, True, True, inject[4]),
              ("inject_f5_drop_alive_cut", 5, True, True, True, inject[5]),
              ("inject_coin_boundary", 1, True, False, False, boundary)]
    key = philox.round_key(SEED, CHECK_ROUND, philox.MR_SALT)
    results, tables = [], {}
    err = {"fused_mr_round": 0, "mr_gather": 0}
    for m in (n, n - 37):
        tables[m] = random_mr_table(rng, m, dev)
        alive = MR.render_alive_words(
            torch.from_numpy(rng.random(m) < 0.9).to(dev), m)
        cut = MR.render_cut_words(m // 3, m, dev)
        for name, fanout, d, a, c, bits in cases:
            table = tables[m]
            t, a, c = thr if d else 0, alive if a else None, cut if c else None
            want = MR.fused_mr_round_plain(table, SEED, CHECK_ROUND, m,
                                           fanout, bits, t, a, c)
            counts = MR.rumor_counts(want, RUMORS).to(torch.int32)
            pops = [torch.zeros(RUMORS, dtype=torch.int32, device=dev)
                    for _ in range(3)]
            # the loops' launch: lane-major in, lane-major out
            lanes_bits = None if bits is None else MR.lanes_bits(bits, dev)
            lanes_args = (MR.to_lanes(table), SEED, CHECK_ROUND, m, fanout,
                          lanes_bits, t, MR.to_lanes(a), MR.to_lanes(c))
            lanes = MR.fused_mr_round_lanes(*lanes_args, rumors=RUMORS,
                                            pop=pops[0])
            lanes_want = MR.fused_mr_round_lanes_plain(*lanes_args)
            value = MR.fused_multirumor_pull_round(
                table, SEED, CHECK_ROUND, m, fanout, bits, t, a, c, RUMORS,
                pop=pops[1])
            staged = MR.fused_mr_round_big(table, SEED, CHECK_ROUND, m,
                                           fanout, bits, t, a, c, RUMORS,
                                           pop=pops[2])
            # the gather kernel alone against its plain version, draw 0
            if bits is None:
                shifts = philox.shift_words(*key, fanout, dev)[0]
                rb, rb_kernel = philox.draw_words(*key, rows, 1, dev)[0], None
            else:
                shifts, rb = bits[0][0, 0], bits[1][0]
                rb_kernel = rb
            src = table & a if a is not None else table
            rot = MR.rotate_rows(src, shifts)
            rot_cut = MR.rotate_rows(c, shifts) if c is not None else None
            g_kernel = MR.mr_gather(table, rot, m, 0, key, t, RUMORS,
                                    rbits=rb_kernel, alive_words=a,
                                    rot_cut=rot_cut, cut_words=c)
            g_plain = MR.mr_gather_plain(table, rot, rb, m, t, a, rot_cut, c)
            e_value = max(_words_err(lanes, lanes_want),
                          _words_err(value, want))
            e_gather = max(_words_err(g_kernel, g_plain),
                           _words_err(staged, want))
            ok = {"lanes_equal": bool(torch.equal(lanes, lanes_want)),
                  "lanes_plain_is_value_plain": bool(torch.equal(
                      MR.from_lanes(lanes_want), want)),
                  "value_equal": bool(torch.equal(value, want)),
                  "staged_equal": bool(torch.equal(staged, want)),
                  "gather_equal": bool(torch.equal(g_kernel, g_plain)),
                  "counts_equal": all(bool(torch.equal(p, counts))
                                      for p in pops)}
            grew = int(MR.rumor_counts(want, RUMORS).sum()
                       - MR.rumor_counts(table, RUMORS).sum())
            results.append({"case": name, "n": m, "fanout": fanout, **ok,
                            "max_abs_err": max(e_value, e_gather),
                            "newly_informed": grew,
                            **_kernels.fused_mr_occupancy(
                                fanout, a is not None, c is not None,
                                bits is not None, t)})
            check(all(ok.values()) and grew > 0,
                  f"multi-rumor kernels vs plain, {name} at n={m}: {ok}")
            err["fused_mr_round"] = max(err["fused_mr_round"], e_value)
            err["mr_gather"] = max(err["mr_gather"], e_gather)
    return results, err, tables[n]


def route_ms(dev, fn) -> float:
    """Milliseconds per round of ``fn`` as a run loop pays them (the
    host's enqueue included): ROUTE_ROUNDS calls between two synchronizes,
    timed with CUDA events, after a warm-up; the median of three."""
    from gossip_tpu_torch.utils.timing import steady_timed

    def batch():
        for _ in range(ROUTE_ROUNDS):
            fn()
    batch()
    return 1e3 * statistics.median(
        steady_timed(dev, batch)[1] for _ in range(3)) / ROUTE_ROUNDS


def phase_mr_routes(dev, big_table):
    """Both routes per round at 10M x 32 and 1M x 32, fanout 1 and 2, in
    turns (value, staged, staged, value), and the rule the times give."""
    import numpy as np
    import torch
    from gossip_tpu_torch.ops import fused_mr_round as MR

    tables = {N: big_table,
              N_SMALL: random_mr_table(np.random.default_rng(SEED + 2),
                                       N_SMALL, dev)}
    rows = []
    for m, table in tables.items():
        out = torch.empty_like(table)
        lanes = MR.to_lanes(table)
        lanes_out = torch.empty_like(lanes)
        pop = torch.zeros(RUMORS, dtype=torch.int32, device=dev)
        for fanout in (1, 2):
            def value():
                MR.fused_mr_round_lanes(
                    lanes, SEED, CHECK_ROUND, m, fanout, rumors=RUMORS,
                    out=lanes_out, pop=pop)

            def staged():
                MR.fused_mr_round_big(table, SEED, CHECK_ROUND, m, fanout,
                                      rumors=RUMORS, out=out, pop=pop)
            v1, s1, s2, v2 = (route_ms(dev, value), route_ms(dev, staged),
                              route_ms(dev, staged), route_ms(dev, value))
            v, st = statistics.median([v1, v2]), statistics.median([s1, s2])
            rows.append({"n": m, "fanout": fanout, "value_ms": [v1, v2],
                         "staged_ms": [s1, s2],
                         "value_kernel_ms": kernel_ms(value),
                         "faster": "staged" if st < v else "value"})
    return rows


MR_PARTS = {0: "replaced generic", 1: "replaced generic, no Philox",
            2: "replaced generic, no pulled tile",
            4: "redesign, no Philox",
            5: "redesign, own words read in the epilogue"}


def phase_mr_parts(dev, smi: str) -> dict:
    """Kernel 2's operand path broken down by part at CF256's operand
    set: 10M x 32 rumors under ``churn_heal``'s round-1 operands (a
    crash's alive words, the open cut, the ramp's drop threshold), on a
    table with every rumor bit at 1/32.  The replaced generic
    instantiation (``csrc/fused_mr_parts.cu`` variant 0) and the
    redesign as shipped,
    each beside its variants with a part knocked out at compile time
    (``MR_PARTS``), each operand set apart at fanout 2, both at fanout
    1 (FPCH's), and each on a table of whole waves (the tail wave).  ms
    a launch (``kernel_ms``) with each instantiation's dynamic shared
    memory and resident blocks per SM; the variants that keep the
    function are held to the shipped kernel's output, bitwise."""
    import numpy as np
    import torch
    from gossip_tpu_torch import cli
    from gossip_tpu_torch.ops import _kernels, philox
    from gossip_tpu_torch.ops import fused_mr_round as MR
    from gossip_tpu_torch.parallel import sharded_fused as SF
    from gossip_tpu_torch.tools.roofline import mr_round_bound

    heal = cli.churn_sweep_configs(_parsed(
        "churn-sweep", [*CF_ARGS, "--scenario", CS10M_SCENARIOS[0],
                        "--drop", "0.02"]))
    n = heal[1].n
    args = SF._Operands(n, heal[3][0], 0, dev).round_args(1)
    thr, alive, cut = (args["drop_threshold"], args["alive_lanes"],
                       args["cut_lanes"])
    check(thr > 0 and alive is not None and cut is not None,
          f"churn_heal's round 1 has no threshold, alive or cut: {args}")
    key = philox.round_key(SEED, 1, philox.MR_SALT)
    full = MR.to_lanes(random_mr_table(np.random.default_rng(SEED + 3), n,
                                       dev))
    rows = full.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pop = torch.zeros(RUMORS, dtype=torch.int32, device=dev)

    def operands(ops, cols=None):
        a, c = (alive if "alive" in ops else None,
                cut if "cut" in ops else None)
        if cols is None:
            return a, c
        return tuple(None if x is None else x[:, :cols].contiguous()
                     for x in (a, c))

    def time_case(variant, fanout, ops="thr+alive+cut", cols=None):
        table = full if cols is None else full[:, :cols].contiguous()
        a, c = operands(ops, cols)
        m = min(n, table.shape[1] * MR.LANES)
        out = torch.empty_like(table)

        def launch():
            return _kernels.fused_mr_round(
                table, m, fanout, key, thr if "thr" in ops else 0, RUMORS,
                alive_lanes=a, cut_lanes=c, out=out, pop=pop,
                variant=variant)
        occ = (_kernels.fused_mr_occupancy(fanout, a is not None,
                                           c is not None, False, thr)
               if variant is None else
               _kernels.fused_mr_parts_occupancy(variant, fanout,
                                                 a is not None,
                                                 c is not None))
        return {"ms": kernel_ms(launch), "rows": table.shape[1], **occ}, \
            launch

    rows_out, results = {}, {}
    for design, v in (("replaced", 0), ("redesign", None)):
        for fanout in (2, 1):
            key_ = f"{design}_f{fanout}"
            rows_out[key_], launch = time_case(v, fanout)
            results[key_] = launch().clone()
        for ops in ("thr", "thr+alive", "thr+cut"):
            rows_out[f"{design}_f2_{ops}"] = time_case(v, 2, ops)[0]
        # FPD's operand set: deaths and drops, no cut
        rows_out[f"{design}_f1_thr+alive"] = time_case(v, 1, "thr+alive")[0]
        per_wave = (sms * rows_out[f"{design}_f2"]["blocks_per_sm"]
                    * (64 if v == 0 else 32))
        cols = rows // per_wave * per_wave
        rows_out[f"{design}_f2_whole_waves"] = time_case(v, 2,
                                                         cols=cols)[0]
    same = {f"replaced_f{f}": torch.equal(results[f"replaced_f{f}"],
                                          results[f"redesign_f{f}"])
            for f in (1, 2)}
    for v in (1, 2, 4, 5):
        for fanout in ((2,) if v == 2 else (2, 1)):
            rows_out[f"v{v}_f{fanout}"], launch = time_case(v, fanout)
            if v == 5:
                same[f"v5_f{fanout}"] = torch.equal(
                    launch(), results[f"redesign_f{fanout}"])

    def parts(design, no_philox):
        ms = {k[len(design) + 1:]: v["ms"] for k, v in rows_out.items()
              if k.startswith(design + "_")}
        whole = rows_out[f"{design}_f2_whole_waves"]
        out = {"fanout2_ms": ms["f2"], "fanout1_ms": ms["f1"],
               "philox_ms": ms["f2"] - rows_out[f"v{no_philox}_f2"]["ms"],
               "philox_f1_ms": ms["f1"] - rows_out[f"v{no_philox}_f1"]["ms"],
               "alive_staging_ms": ms["f2_thr+alive"] - ms["f2_thr"],
               "cut_staging_ms": ms["f2_thr+cut"] - ms["f2_thr"],
               "second_draw_ms": ms["f2"] - ms["f1"],
               "tail_wave_ms": ms["f2"] - whole["ms"] * rows / whole["rows"]}
        return out
    breakdown = {"replaced": parts("replaced", 1),
                 "redesign": parts("redesign", 4)}
    breakdown["replaced"]["pulled_tile_ms"] = (rows_out["replaced_f2"]["ms"]
                                               - rows_out["v2_f2"]["ms"])
    for f in (1, 2):
        breakdown["redesign"][f"own_prefetch_f{f}_ms"] = (
            rows_out[f"redesign_f{f}"]["ms"] - rows_out[f"v5_f{f}"]["ms"])
    bound = {f"f{f}": mr_round_bound(n, f, alive=True, cut=True)
             for f in (1, 2)}
    line = {"n": n, "rumors": RUMORS, "operands": "churn_heal round 1: "
            "alive, cut and threshold", "threshold": thr, "sms": sms,
            "variants": MR_PARTS, "cases": rows_out, "breakdown": breakdown,
            "bound_ms": {k: b[0] for k, b in bound.items()},
            "bound_by": {k: b[1] for k, b in bound.items()},
            "time_over_bound": {
                d: {f"f{f}": rows_out[f"{d}_f{f}"]["ms"] / bound[f"f{f}"][0]
                    for f in (1, 2)} for d in ("replaced", "redesign")},
            "equal_to_redesign": same, "card": smi}
    emit("mr_parts", **line)
    check(all(same.values()), "a variant that keeps the function differs "
          f"from the redesign: {same}")
    return line


def phase_mr(dev, smi: str):
    """Phases 6 to 10, the multi-rumor path; returns its two kernels'
    entries of the ``kernels`` line."""
    import numpy as np
    import torch
    from gossip_tpu_torch.backend import run_simulation
    from gossip_tpu_torch.config import (ProtocolConfig, RunConfig,
                                         TopologyConfig)
    from gossip_tpu_torch.ops import _kernels, philox
    from gossip_tpu_torch.ops import fused_mr_round as MR
    from gossip_tpu_torch.tools.roofline import mr_gather_bound, mr_round_bound
    from gossip_tpu_torch.utils.timing import steady_timed

    # 6. build reports of the multi-rumor kernels
    mr = (_kernels.FUSED_MR_ROUND, _kernels.MR_GATHER)
    emit("mr_build", kernels={k.name: {
        "build_s": k.build_s,
        "sources": [p.name for p in k.sources()],
        "ptxas": [ln.strip() for ln in k.ptxas.splitlines()
                  if "registers" in ln or "spill" in ln]} for k in mr})

    # 7. kernels against plain, then times at the main path's shape
    results, err, table = phase_mr_checks(dev, N)
    key = philox.round_key(SEED, CHECK_ROUND, philox.MR_SALT)
    out = torch.empty_like(table)
    pop = torch.zeros(RUMORS, dtype=torch.int32, device=dev)
    # the value kernel as the loops launch it: lane-major buffers
    lanes = MR.to_lanes(table)
    lanes_out = torch.empty_like(lanes)
    value_ms = kernel_ms(lambda: MR.fused_mr_round_lanes(
        lanes, SEED, CHECK_ROUND, N, rumors=RUMORS, out=lanes_out, pop=pop))
    shifts = philox.shift_words(*key, 1, dev)[0]
    rot = MR.rotate_rows(table, shifts)
    gather_ms = kernel_ms(lambda: MR.mr_gather(table, rot, N, 0, key,
                                               rumors=RUMORS, out=out,
                                               pop=pop))
    rotation_ms = kernel_ms(lambda: MR.rotate_rows(table, shifts))
    shift_ms = kernel_ms(lambda: philox.shift_words(*key, 1, dev),
                         graph=True)
    rb = philox.draw_words(*key, MR.mr_rows(N), 1, dev)[0]
    value_plain_ms = 1e3 * statistics.median(
        steady_timed(dev, MR.fused_mr_round_lanes_plain, lanes, SEED,
                     CHECK_ROUND, N)[1] for _ in range(3))
    gather_plain_ms = 1e3 * statistics.median(
        steady_timed(dev, MR.mr_gather_plain, table, rot, rb, N)[1]
        for _ in range(3))
    value_bound = mr_round_bound(N, 1)
    gather_bound = mr_gather_bound(N)
    emit("mr_checks", cases=results, max_abs_err=err, tolerance=0,
         rumors=RUMORS, value_kernel_ms=value_ms,
         value_plain_ms=value_plain_ms, value_bound_ms=value_bound[0],
         value_bound_by=value_bound[1], gather_kernel_ms=gather_ms,
         gather_plain_ms=gather_plain_ms, gather_bound_ms=gather_bound[0],
         gather_bound_by=gather_bound[1], rotation_ms=rotation_ms,
         shift_words_ms=shift_ms,
         value_sass_static=round_sass(_kernels.FUSED_MR_ROUND), card=smi)

    # 8. the two routes, and the rule their times give
    routes = phase_mr_routes(dev, table)
    staged_faster = [(r["n"], r["fanout"]) for r in routes
                     if r["faster"] == "staged"]
    emit("mr_routes", rows=routes, rule=(
        "staged where faster: " + str(staged_faster) if staged_faster
        else "value at every measured size"), code_route="value", card=smi)
    check(not staged_faster, "the loops take the value route at every "
          f"size, but the staged route was faster at {staged_faster}")

    # 9. the main path, counts from 0
    proto = ProtocolConfig(mode="pull", fanout=1, rumors=RUMORS)
    for k in _kernels.KERNELS:
        k.launches = 0
    report = run_simulation(proto, TopologyConfig(family="complete", n=N),
                            RunConfig(seed=SEED, target_coverage=0.99,
                                      engine="fused"),
                            device="cuda")
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    rounds = report.rounds
    check(rounds > 0 and report.coverage >= np.float32(0.99),
          f"coverage {report.coverage} after {rounds} rounds")
    check(report.msgs == float(np.float32(2 * N * rounds)),
          f"msgs {report.msgs} != 2*n*rounds")
    check(report.meta["route"] == "value"
          and launches["fused_mr_round"] == rounds
          and sum(launches.values()) == rounds,
          f"route {report.meta['route']}, launches {launches} for {rounds} "
          "rounds")

    # the same loop, round by round through the plain version
    final, _ = MR.until_fused_multirumor(N, RUMORS, SEED, device=dev)
    plain = MR.init_multirumor_state(N, RUMORS, 0, dev).table
    for r in range(final.round):
        plain = MR.fused_mr_round_plain(plain, SEED, r, N)
    check(final.round == rounds and torch.equal(final.table, plain),
          "multi-rumor main path vs its plain replay")
    until_s = statistics.median(
        steady_timed(dev, MR.until_fused_multirumor, N, RUMORS, SEED,
                     device=dev)[1] for _ in range(5))
    curve_s = statistics.median(
        steady_timed(dev, MR.curve_fused_multirumor, N, RUMORS, SEED,
                     max_rounds=rounds, device=dev)[1] for _ in range(5))
    emit("mr_main_path", report=report.to_dict(), launches=launches,
         plain_replay_equal=True, until_ms=until_s * 1e3,
         curve_ms=curve_s * 1e3,
         host_read_ms_per_round=(until_s - curve_s) * 1e3 / rounds,
         node_rounds_per_s=N * rounds / until_s,
         kernel_share_of_until=rounds * value_ms / (until_s * 1e3),
         kernel_share_of_curve=rounds * value_ms / (curve_s * 1e3),
         card=smi)

    # 10. the main path's rounds through the staged round, counts from 0
    staged = MR.init_multirumor_state(N, RUMORS, 0, dev).table
    spare = torch.empty_like(staged)
    pops = torch.zeros(rounds, RUMORS, dtype=torch.int32, device=dev)
    for k in _kernels.KERNELS:
        k.launches = 0
    for r in range(rounds):
        staged, spare = MR.fused_mr_round_big(staged, SEED, r, N,
                                              rumors=RUMORS, out=spare,
                                              pop=pops[r]), staged
    staged_launches = {k.name: k.launches for k in _kernels.KERNELS}
    staged_cov = MR.coverage_words(staged, N, RUMORS)
    check(torch.equal(staged, final.table)
          and staged_cov == report.coverage
          and torch.equal(pops[-1], MR.rumor_counts(staged, RUMORS)
                          .to(torch.int32))
          and staged_launches["mr_gather"] == rounds
          and sum(staged_launches.values()) == rounds,
          f"staged path: coverage {staged_cov}, launches {staged_launches} "
          f"for {rounds} rounds")
    emit("mr_staged_path", rounds=rounds, coverage=staged_cov,
         launches=staged_launches, same_table_as_value_route=True, card=smi)

    library_note = "no single PyTorch call computes this round"
    return [{"name": "fused_mr_round", "route": "cuda",
             "source": "gossip_tpu_torch/csrc/fused_mr_round.cu",
             "replaces": "gossip_tpu/ops/pallas_round.py:558",
             "launches": launches["fused_mr_round"],
             "max_abs_err": err["fused_mr_round"], "bitwise_equal": True,
             "ms": value_ms, "plain_ms": value_plain_ms,
             "bound_ms": value_bound[0], "bound_by": value_bound[1],
             "library_ms": None, "library_note": library_note,
             "path": "mr_main_path", "card": smi},
            {"name": "mr_gather", "route": "cuda",
             "source": "gossip_tpu_torch/csrc/mr_gather.cu",
             "replaces": "gossip_tpu/ops/pallas_round.py:667",
             "launches": staged_launches["mr_gather"],
             "max_abs_err": err["mr_gather"], "bitwise_equal": True,
             "ms": gather_ms, "plain_ms": gather_plain_ms,
             "bound_ms": gather_bound[0], "bound_by": gather_bound[1],
             "library_ms": None, "library_note": library_note,
             "path": "mr_staged_path", "card": smi}]


def phase_sampler_checks(dev, smi: str):
    """The sampling kernel against its plain version on the card,
    bitwise, then the stream's chi-square and the times.  Returns the
    kernel's entry of the ``kernels`` line (launches filled in later)."""
    import numpy as np
    import torch
    from gossip_tpu_torch.ops import _kernels
    from gossip_tpu_torch.ops import fast_sampling as FS
    from gossip_tpu_torch.tools.roofline import sampler_bound
    from gossip_tpu_torch.utils.timing import steady_timed

    rng = np.random.default_rng(SEED + 3)
    seeds = (0, FS.round_seed(123456789, 7), 2**31 - 1)
    check(seeds[1] < 0, "the wrapped round seed is negative")
    results, max_err = [], 0

    def compare(name, m, k, excl, seed, bits=None):
        nonlocal max_err
        got = FS.sample_targets(seed, m, m, k, excl, inject_bits=bits,
                                device=dev)
        want = FS.sample_targets_plain(seed, m, m, k, excl,
                                       inject_bits=bits, device=dev)
        err = int((got.long() - want.long()).abs().max())
        equal = bool(torch.equal(got, want))
        results.append({"case": name, "n": m, "k": k, "exclude_self": excl,
                        "seed": seed, "bitwise_equal": equal,
                        "max_abs_err": err})
        check(equal, f"sampler vs plain, {name}")
        if excl:
            check(not bool((got == torch.arange(m, device=dev)[:, None])
                           .any()), f"sampler drew a node itself, {name}")
        check(int(got.min()) >= 0 and int(got.max()) < m,
              f"sampler out of range, {name}")
        max_err = max(max_err, err)

    for m in (N, N - 37):
        for k in (1, 3):
            for excl in (True, False):
                for seed in seeds:
                    compare("stream", m, k, excl, seed)
    for m, k, excl in ((N, 1, True), (N - 37, 3, False)):
        for fill, bits in (
                ("zeros", np.zeros((m, k), np.uint32)),
                ("ones", np.full((m, k), 2**32 - 1, np.uint32)),
                ("random", rng.integers(0, 2**32, (m, k), np.uint32))):
            compare(f"inject_{fill}", m, k, excl, seeds[0],
                    torch.from_numpy(bits.view(np.int32)).to(dev))
    # uniformity of the 10M-draw stream: n = 64 (no modulo bias), 16
    # buckets, the chi-square bound of tests/test_pallas.py
    t = FS.sample_targets(11, N, 64, 1, False, device=dev)[:, 0]
    counts = torch.bincount(t.long() * 16 // 64, minlength=16).double()
    expected = N / 16
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    check(chi2 < 60, f"sampler stream chi-square {chi2}")

    out = torch.empty(N, 1, dtype=torch.int32, device=dev)
    seed = FS.round_seed(SEED, CHECK_ROUND)
    ms = kernel_ms(lambda: _kernels.sampler(out, N, True, seed))
    plain_ms = 1e3 * statistics.median(
        steady_timed(dev, FS.sample_targets_plain, seed, N, N, 1, True,
                     device=dev)[1] for _ in range(3))
    library_ms = kernel_ms(lambda: torch.randint(
        0, N, (N, 1), dtype=torch.int32, device=dev))
    bound_ms, bound_by = sampler_bound(N, 1)
    emit("sampler_checks", cases=results, max_abs_err=max_err, tolerance=0,
         chi_square=chi2, kernel_ms=ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
         library="torch.randint(0, n, (n, 1), int32)", card=smi)
    return {"name": "sampler", "route": "cuda",
            "source": "gossip_tpu_torch/csrc/sampler.cu",
            "replaces": "gossip_tpu/ops/pallas_sampling.py:51",
            "launches": None, "max_abs_err": max_err, "bitwise_equal": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_note": "torch.randint draws the same distribution "
                            "without self-exclusion, on another stream",
            "path": "xla_sampler_path", "card": smi}


def _median_ms(dev, fn, *args, **kwargs) -> float:
    """Median of five timed calls after a warm-up, in ms, as a loop pays
    them (host enqueue and waits included; CUDA events)."""
    from gossip_tpu_torch.utils.timing import steady_timed
    fn(*args, **kwargs)
    return 1e3 * statistics.median(
        steady_timed(dev, fn, *args, **kwargs)[1] for _ in range(5))


def _xla_packed(n: int, dev, mode: str = "pull", fault=None):
    """(rounds, coverage, msgs, final state) of the XLA engine's packed
    loop, fanout 1, seed 0, target 0.99, on ``dev``."""
    from gossip_tpu_torch.config import ProtocolConfig, RunConfig
    from gossip_tpu_torch.models.si_packed import simulate_until_packed
    from gossip_tpu_torch.topology import generators as G
    return simulate_until_packed(
        ProtocolConfig(mode=mode, fanout=1), G.complete(n),
        RunConfig(seed=SEED, target_coverage=0.99, engine="xla"), fault,
        device=dev)


def phase_xla_main_path(dev, smi: str):
    """``engine='xla'`` at N = 10M and 1M on the card against the JAX
    package's values, the card's states against the port's CPU runs at
    ``N_REPLAY``,
    and the round's time split.  Returns the packed bench loop's ms per
    round."""
    import torch
    from gossip_tpu_torch import bench
    from gossip_tpu_torch.backend import run_simulation
    from gossip_tpu_torch.config import (FaultConfig, ProtocolConfig,
                                         RunConfig, TopologyConfig)
    from gossip_tpu_torch.models import si as si_mod
    from gossip_tpu_torch.models.si_packed import (init_packed_state,
                                                   pull_merge_packed)
    from gossip_tpu_torch.ops import _kernels, threefry
    from gossip_tpu_torch.ops.bitpack import coverage_packed
    from gossip_tpu_torch.ops.sampling import sample_peers
    from gossip_tpu_torch.topology import generators as G

    proto = ProtocolConfig(mode="pull", fanout=1)
    run = RunConfig(seed=SEED, target_coverage=0.99, engine="xla")
    reports = {}
    for n in (N, N_SMALL):
        for k in _kernels.KERNELS:
            k.launches = 0
        reports[n] = run_simulation(
            proto, TopologyConfig(family="complete", n=n), run, device=dev)
        launches = {k.name: k.launches for k in _kernels.KERNELS}
        rep = reports[n]
        got = (rep.rounds, rep.coverage, rep.msgs)
        want = XLA_10M if n == N else XLA_1M
        check(got == want and rep.meta["engine"] == "bit-packed"
              and sum(launches.values()) == 0,
              f"xla at n={n}: {got} {rep.meta['engine']} {launches}, "
              f"want {want}")
    # card against CPU at N_REPLAY, bitwise: pull, anti-entropy, and pull with
    # drops and deaths
    cpu = torch.device("cpu")
    same = {}
    for name, mode, fault in (
            ("pull", "pull", None), ("antientropy", "antientropy", None),
            ("pull_drop_death", "pull",
             FaultConfig(drop_prob=0.05, node_death_rate=0.1))):
        card = _xla_packed(N_REPLAY, dev, mode, fault)
        host = _xla_packed(N_REPLAY, cpu, mode, fault)
        ok = (card[:3] == host[:3]
              and torch.equal(card[3].seen.cpu(), host[3].seen)
              and card[3].msgs.item() == host[3].msgs.item())
        same[name] = {"rounds": card[0], "coverage": card[1],
                      "msgs": card[2], "card_equals_cpu": ok}
        check(ok, f"card vs CPU at {N_REPLAY}, {name}: {card[:3]} "
              f"{host[:3]}")
    report = reports[N]

    # time split of one 10M round: threefry draw, gather, request count,
    # coverage count with its host read
    topo = G.complete(N)
    st = init_packed_state(run, proto, N, dev)
    ids = torch.arange(N, dtype=torch.int64, device=dev)
    qkey = threefry.fold_in(threefry.fold_in(st.key, CHECK_ROUND),
                            si_mod.PULL_TAG)

    partners = sample_peers(qkey, ids, topo, 1)
    split = {"threefry_ms": _median_ms(dev, sample_peers, qkey, ids, topo,
                                       1),
             "gather_ms": _median_ms(dev, pull_merge_packed, st.seen,
                                     partners, N),
             "requests_ms": _median_ms(
                 dev, lambda: si_mod.f32((partners < N).sum())),
             "coverage_read_ms": _median_ms(dev, coverage_packed, st.seen,
                                            1)}
    b_rounds, seconds = bench.run_xla_packed(N, dev)
    check(b_rounds == report.rounds, f"xla bench ran {b_rounds} rounds")
    round_ms = seconds * 1e3 / b_rounds
    emit("xla_main_path", report=report.to_dict(), want=XLA_10M,
         small=reports[N_SMALL].to_dict(), want_small=XLA_1M,
         card_vs_cpu=same, n_replay=N_REPLAY, ms_per_round=round_ms,
         **split,
         threefry_share=split["threefry_ms"] / round_ms,
         line=bench.measurement_line(N, b_rounds, seconds, bench.card_info(),
                                     "bit-packed threefry"),
         card=smi)
    return round_ms


def phase_xla_sampler_path(dev, smi: str, threefry_round_ms: float):
    """``compiled_until_packed(sampler="kernel")`` at N = 10M, counts set
    to 0 just before and read just after; replayed with the plain
    sampler; and its time per round against the threefry loop's."""
    import numpy as np
    import torch
    from gossip_tpu_torch import bench
    from gossip_tpu_torch.config import ProtocolConfig, RunConfig
    from gossip_tpu_torch.models.si_packed import (compiled_until_packed,
                                                   pull_merge_packed)
    from gossip_tpu_torch.ops import _kernels
    from gossip_tpu_torch.ops import fast_sampling as FS
    from gossip_tpu_torch.ops.bitpack import coverage_packed
    from gossip_tpu_torch.topology import generators as G

    proto = ProtocolConfig(mode="pull", fanout=1)
    run = RunConfig(seed=SEED, target_coverage=0.99, max_rounds=128)
    loop, init = compiled_until_packed(proto, G.complete(N), run,
                                       sampler="kernel", device=dev)
    for k in _kernels.KERNELS:
        k.launches = 0
    final = loop(init)
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    rounds = final.round
    cov = coverage_packed(final.seen, 1)
    check(launches["sampler"] == rounds and sum(launches.values()) == rounds,
          f"sampler path: launches {launches} for {rounds} rounds")
    check(25 <= rounds <= 30 and cov >= np.float32(0.99),
          f"sampler path: {rounds} rounds, coverage {cov}")
    check(final.msgs.item() == np.float32(2 * N * rounds),
          f"sampler path msgs {final.msgs.item()}")
    # replay round by round with the plain sampler on the card
    seen = init.seen.clone()
    for r in range(rounds):
        partners = FS.sample_targets_plain(FS.round_seed(SEED, r), N, N, 1,
                                           True, device=dev)
        seen = seen | pull_merge_packed(seen, partners, N)
    check(torch.equal(seen, final.seen), "sampler path vs plain replay")
    b_rounds, seconds = bench.run_xla_packed(N, dev, "kernel")
    check(b_rounds == rounds, f"kernel bench ran {b_rounds} rounds")
    # time split of one round: the sampler call (allocation and launch),
    # the gather, the request count, the coverage count and its host read
    split = {"sampler_call_ms": _median_ms(
                 dev, FS.sample_peers_fast, SEED, CHECK_ROUND, N, N,
                 device=dev),
             "gather_ms": _median_ms(dev, pull_merge_packed, final.seen,
                                     partners, N),
             "requests_ms": _median_ms(
                 dev, lambda: (partners < N).sum().to(torch.float32)),
             "coverage_read_ms": _median_ms(dev, coverage_packed,
                                            final.seen, 1)}
    emit("xla_sampler_path", rounds=rounds, coverage=cov, launches=launches,
         plain_replay_equal=True, ms_per_round=seconds * 1e3 / rounds,
         **split, threefry_ms_per_round=threefry_round_ms,
         line=bench.measurement_line(N, rounds, seconds, bench.card_info(),
                                     "bit-packed kernel-sampler"),
         card=smi)
    return launches["sampler"]


def _loop_ms(dev, fn, *args, **kwargs) -> float:
    """Median of three steady runs of a run loop, in ms."""
    from gossip_tpu_torch.utils.timing import steady_timed
    return 1e3 * statistics.median(
        steady_timed(dev, fn, *args, **kwargs)[1] for _ in range(3))


def phase_fused_deaths(dev, smi: str):
    """One single-rumor and one 32-rumor fused run with node_death_rate
    0.1 at N = 10M against their plain replays, bitwise; the stop test's
    coverage, read from the kernels' counters, against a recount of the
    final table; and each loop's ms per round."""
    import torch
    from gossip_tpu_torch.config import FaultConfig
    from gossip_tpu_torch.models.state import alive_mask
    from gossip_tpu_torch.ops import _kernels
    from gossip_tpu_torch.ops import fused_mr_round as MR
    from gossip_tpu_torch.ops import fused_round as FR

    fault = FaultConfig(node_death_rate=0.1)
    rows = {}
    for k in _kernels.KERNELS:
        k.launches = 0
    final, cov = FR.until_fused(N, SEED, fault=fault, device=dev)
    alive, _ = FR.fault_masks_node_packed(fault, N, 0, dev)
    plain = FR.init_fused_state(N, 0, dev).table
    for r in range(final.round):
        plain = FR.fused_pull_round_plain(plain, SEED, r, N,
                                          alive_table=alive)
    rows["single"] = {"rounds": final.round, "coverage": cov,
                      "launches": _kernels.FUSED_ROUND.launches,
                      "until_ms_per_round": _loop_ms(
                          dev, FR.until_fused, N, SEED, fault=fault,
                          device=dev) / final.round}
    check(torch.equal(final.table, plain) and cov >= 0.99
          and cov == FR.coverage_node_packed_alive(final.table, alive)
          and rows["single"]["launches"] == final.round,
          f"fused deaths, one rumor: {rows['single']}")
    # 32 rumors from the first run of 32 alive nodes (a rumor started at
    # a dead node never spreads)
    a = alive_mask(fault, N, 0, dev)
    origin = int(torch.nonzero(a.unfold(0, RUMORS, 1).all(dim=1))[0])
    for k in _kernels.KERNELS:
        k.launches = 0
    final, cov = MR.until_fused_multirumor(N, RUMORS, SEED, origin=origin,
                                           fault=fault, device=dev)
    words, _ = MR.fault_masks_word(fault, N, origin, dev)
    plain = MR.init_multirumor_state(N, RUMORS, origin, dev).table
    for r in range(final.round):
        plain = MR.fused_mr_round_plain(plain, SEED, r, N,
                                        alive_words=words)
    launches = _kernels.FUSED_MR_ROUND.launches
    rows["rumors32"] = {"rounds": final.round, "coverage": cov,
                        "origin": origin, "launches": launches,
                        "until_ms_per_round": _loop_ms(
                            dev, MR.until_fused_multirumor, N, RUMORS, SEED,
                            origin=origin, fault=fault,
                            device=dev) / final.round}
    check(torch.equal(final.table, plain) and cov >= 0.99
          and cov == MR.coverage_words_alive(final.table, words, RUMORS)
          and launches == final.round,
          f"fused deaths, 32 rumors: {rows['rumors32']}")
    emit("fused_deaths", runs=rows, plain_replay_equal=True, card=smi)


def _churn_replay(dev, n: int, fault, rounds: int, seed: int = SEED):
    """The kernel-sampler churn loop's rounds composed by hand on
    ``dev``: the plain sampler's partners, the threefry coin at the
    schedule's probability, the cut, the round's alive rows, the gather
    and the requests.  Returns the final packed table and msgs."""
    import torch
    from gossip_tpu_torch.models.si import PULL_DROP_TAG
    from gossip_tpu_torch.models.si_packed import pull_merge_packed
    from gossip_tpu_torch.ops import fast_sampling as FS
    from gossip_tpu_torch.ops import nemesis as NE
    from gossip_tpu_torch.ops import threefry
    from gossip_tpu_torch.ops.sampling import apply_drop

    sched = NE.build(fault, n, device=dev)
    base = NE.base_alive_or_ones(fault, n, 0, dev)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    key = threefry.key(seed, dev)
    seen = torch.zeros(n, 1, dtype=torch.int32, device=dev)
    seen[0] = 1
    msgs = torch.zeros((), dtype=torch.float32, device=dev)
    for r in range(rounds):
        alive = NE.alive_rows(sched, base, r)
        p = FS.sample_targets_plain(FS.round_seed(seed, r), n, n, 1, True,
                                    device=dev)
        p = apply_drop(threefry.fold_in(key, r), PULL_DROP_TAG, ids, p,
                       NE.drop_at(sched, r), n, force=True)
        p = NE.partition_targets(NE.cut_at(sched, r), ids, p, n)
        vis = torch.where(alive[:, None], seen, 0)
        seen = seen | torch.where(alive[:, None],
                                  pull_merge_packed(vis, p, n), 0)
        p = torch.where(alive[:, None], p, n)
        msgs = msgs + 2.0 * (p < n).sum().to(torch.float32)
    return seen, msgs


def phase_churn_path(dev, smi: str, n: int = N, n_small: int = N_SMALL,
                     n_mixed: int = N_MIXED, want: dict = None):
    """The nemesis on the XLA engine (the JAX package's ``churn_heal``
    program, ``bench.heal_fault``):
    ``run_simulation`` at n and n_small with ``engine='xla'`` and
    ``'auto'`` against the JAX package's values, ``'fused'`` refused; the
    card against the CPU, bitwise; the partition's stall at 10M; the
    kernel-sampler churn loop, counts set to 0 just before and read just
    after, and its plain replay; the loops' ms per round and the split of
    one round.  Returns the sampler's launches on the kernel loop."""
    import numpy as np
    import torch
    from gossip_tpu_torch import bench
    from gossip_tpu_torch.backend import run_simulation
    from gossip_tpu_torch.config import (ProtocolConfig, RunConfig,
                                         TopologyConfig)
    from gossip_tpu_torch.models import si_packed as P
    from gossip_tpu_torch.models.si import PULL_DROP_TAG, PULL_TAG
    from gossip_tpu_torch.models.state import init_state
    from gossip_tpu_torch.ops import _kernels, threefry
    from gossip_tpu_torch.ops import fast_sampling as FS
    from gossip_tpu_torch.ops import nemesis as NE
    from gossip_tpu_torch.ops.bitpack import coverage_packed
    from gossip_tpu_torch.ops.sampling import apply_drop, sample_peers
    from gossip_tpu_torch.runtime.simulator import simulate_until
    from gossip_tpu_torch.topology import generators as G

    want = {N: HEAL_10M, N_SMALL: HEAL_1M} if want is None else want
    proto = ProtocolConfig(mode="pull", fanout=1)
    reports, wall_s, t0 = {}, {}, time.perf_counter()
    for m in (n, n_small):
        fault = bench.heal_fault(m)
        for engine in ("xla", "auto"):
            for k in _kernels.KERNELS:
                k.launches = 0
            rep = run_simulation(
                proto, TopologyConfig(family="complete", n=m),
                RunConfig(seed=SEED, target_coverage=0.99, max_rounds=128,
                          engine=engine), fault, device=dev)
            launches = {k.name: k.launches for k in _kernels.KERNELS}
            got = (rep.rounds, rep.coverage, rep.msgs)
            check(got == want[m] and rep.meta["engine"] == "bit-packed"
                  and "engine_auto" not in rep.meta
                  and sum(launches.values()) == 0,
                  f"churn_heal at n={m}, engine {engine}: {got} "
                  f"{rep.meta.get('engine')} {launches}, want {want[m]}")
            reports[f"{m}_{engine}"] = {
                "rounds": rep.rounds, "coverage": rep.coverage,
                "msgs": rep.msgs, "engine": rep.meta["engine"],
                "steady_wall_s": rep.meta["steady_wall_s"]}
        try:
            run_simulation(proto, TopologyConfig(family="complete", n=m),
                           RunConfig(engine="fused"), fault, device=dev)
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "does not run churn" in refused,
              f"engine='fused' ran a churn program at n={m}")

    wall_s["run_simulation"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the card against the CPU, bitwise: the packed pull at N_REPLAY under
    # the program; the bool push-pull and anti-entropy (period 2) under
    # the four mixed scenario shapes at n_mixed
    cpu = torch.device("cpu")
    same = {}
    heal_small = bench.heal_fault(N_REPLAY)
    run = RunConfig(seed=SEED, target_coverage=0.99, max_rounds=128)
    card = P.simulate_until_packed(proto, G.complete(N_REPLAY), run,
                                   heal_small, dev)
    host = P.simulate_until_packed(proto, G.complete(N_REPLAY), run,
                                   heal_small, cpu)
    same["packed_pull_heal"] = (card[:3] == host[:3] and torch.equal(
        card[3].seen.cpu(), host[3].seen))
    wall_s["card_vs_cpu_packed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mixed = NE.mixed_scenarios(4, n_mixed, drop_prob=0.02, seed=SEED)
    for mode, period in (("pushpull", 1), ("antientropy", 2)):
        mp = ProtocolConfig(mode=mode, fanout=1, period=period)
        mrun = RunConfig(seed=SEED, target_coverage=0.99, max_rounds=48)
        for i, fault in enumerate(mixed):
            a = simulate_until(mp, G.complete(n_mixed), mrun, fault, dev)
            b = simulate_until(mp, G.complete(n_mixed), mrun, fault, cpu)
            same[f"{mode}_{i}"] = (
                (a.rounds, a.coverage, a.msgs) == (b.rounds, b.coverage,
                                                   b.msgs)
                and torch.equal(a.state.seen.cpu(), b.state.seen))
    check(all(same.values()), f"churn card vs CPU: {same}")

    wall_s["card_vs_cpu_bool"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the partition stalls the rumor at the cut until it closes (round 6)
    heal = bench.heal_fault(n)
    cut = heal.churn.partitions[0][2]
    step = NE.drop_lost(P.make_packed_round(proto, G.complete(n), heal,
                                            device=dev), heal.churn)
    st = P.init_packed_state(run, proto, n, dev)
    beyond = []
    for _ in range(bench.HEAL_END + 1):
        st = step(st)
        beyond.append(int(torch.count_nonzero(st.seen[cut:])))
    check(beyond[:bench.HEAL_END] == [0] * bench.HEAL_END and beyond[-1] > 0,
          f"nodes beyond the cut holding the rumor after each round: "
          f"{beyond}")

    # the kernel-sampler churn loop, counts from 0, and its plain replay
    loop, init = P.compiled_until_packed(proto, G.complete(n), run, heal,
                                         sampler="kernel", device=dev)
    for k in _kernels.KERNELS:
        k.launches = 0
    final = loop(init)
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    rounds = final.round
    cov = coverage_packed(final.seen, 1, NE.metric_alive(heal, n, 0, dev))
    check(launches["sampler"] == rounds and sum(launches.values()) == rounds,
          f"churn sampler path: launches {launches} for {rounds} rounds")
    check(abs(rounds - want[n][0]) <= 2 and cov >= np.float32(0.99),
          f"churn sampler path: {rounds} rounds, coverage {cov}")
    seen, msgs = _churn_replay(dev, n, heal, rounds)
    check(torch.equal(seen, final.seen) and msgs.item() == final.msgs.item(),
          "churn sampler path vs its plain replay")

    wall_s["stall_and_kernel_loop"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # time: each loop's ms per round, and the parts of one round
    loop_ms = {}
    for sampler in ("threefry", "kernel"):
        b_rounds, _, _, seconds = bench.run_churn_heal(n, dev, sampler)
        check(b_rounds == (want[n][0] if sampler == "threefry" else rounds),
              f"churn bench ({sampler}) ran {b_rounds} rounds")
        loop_ms[sampler] = {"rounds": b_rounds, "ms": seconds * 1e3,
                            "ms_per_round": seconds * 1e3 / b_rounds,
                            "line": bench.measurement_line(
                                n, b_rounds, seconds, bench.card_info(),
                                f"bit-packed {sampler}, churn_heal")}
    sched = NE.build(heal, n, device=dev)
    base = NE.base_alive_or_ones(heal, n, 0, dev)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    topo = G.complete(n)
    st = init_state(run, proto, n, dev)
    rkey = threefry.fold_in(st.key, CHECK_ROUND)
    qkey = threefry.fold_in(rkey, PULL_TAG)
    partners = sample_peers(qkey, ids, topo, 1)
    dp = NE.drop_at(sched, CHECK_ROUND)
    alive = NE.alive_rows(sched, base, CHECK_ROUND)
    eventual = NE.metric_alive(heal, n, 0, dev)

    def masks():
        a = NE.alive_rows(sched, base, CHECK_ROUND)
        p = NE.partition_targets(NE.cut_at(sched, CHECK_ROUND), ids,
                                 partners, n)
        return torch.where(a[:, None], final.seen, 0), torch.where(
            a[:, None], p, n)

    split = {
        "threefry_draw_ms": _median_ms(dev, sample_peers, qkey, ids, topo, 1),
        "kernel_draw_ms": _median_ms(dev, FS.sample_peers_fast, SEED,
                                     CHECK_ROUND, n, n, device=dev),
        "coin_ms": _median_ms(dev, apply_drop, rkey, PULL_DROP_TAG, ids,
                              partners, dp, n, force=True),
        "schedule_masks_ms": _median_ms(dev, masks),
        "gather_ms": _median_ms(dev, P.pull_merge_packed, final.seen,
                                partners, n),
        "lost_count_ms": _median_ms(dev, NE.lost_count, partners, partners,
                                    alive, n),
        "coverage_read_ms": _median_ms(dev, coverage_packed, final.seen, 1,
                                       eventual, True)}
    wall_s["timing"] = time.perf_counter() - t0
    emit("churn_path", program="churn_heal: events (1,1,4), (2,2,-1); "
         "partition [0,6) at n//2; ramp 0->0.1 over [0,4); drop 0.02",
         reports=reports, want={str(k): v for k, v in want.items()},
         fused_refused=True, card_vs_cpu=same, n_mixed=n_mixed,
         beyond_cut_after_round=beyond,
         kernel_sampler={"rounds": rounds, "coverage": cov,
                         "msgs": final.msgs.item(), "launches": launches,
                         "plain_replay_equal": True},
         loops=loop_ms, split=split, phase_wall_s=wall_s, card=smi)
    return launches["sampler"]


def _swim_proto(**over):
    from gossip_tpu_torch.config import ProtocolConfig
    return ProtocolConfig(mode="swim", fanout=2, swim_subjects=8,
                          swim_proxies=3, swim_suspect_rounds=24, **over)


def _swim_fault(kind):
    from gossip_tpu_torch.config import ChurnConfig, FaultConfig
    if kind is None:
        return None
    return FaultConfig(churn=ChurnConfig(events=((1, 2, -1), (3, 1, 6)),
                                         ramp=(0, 4, 0.0, 0.05)))


def _port_lines(*commands) -> list:
    """Every JSON line of each command line of ``python -m
    gossip_tpu_torch`` in ``commands`` (argument lists), run one after
    another in one process from this checkout (one start-up for all):
    a list of line lists, in order."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    driver = ("import json, sys\n"
              "from gossip_tpu_torch import cli\n"
              "for argv in json.loads(sys.argv[1]):\n"
              "    rc = cli.main(argv)\n"
              "    print(json.dumps({'_rc': rc}), flush=True)\n")
    proc = subprocess.run([sys.executable, "-c", driver,
                           json.dumps([list(c) for c in commands])],
                          capture_output=True, text=True, cwd=root, env=env,
                          timeout=900)
    check(proc.returncode == 0, f"{commands}: {proc.stderr}")
    out, cur = [], []
    for ln in proc.stdout.strip().splitlines():
        row = json.loads(ln)
        if "_rc" in row:
            check(row["_rc"] == 0, f"{commands[len(out)]}: exit "
                  f"{row['_rc']}: {proc.stderr}")
            out.append(cur)
            cur = []
        else:
            cur.append(row)
    return out


def _same_fields(a, b, fields) -> bool:
    import torch
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in fields)


def phase_swim_rumor_path(dev, smi: str, n_swim: int = N_SWIM, n: int = N,
                          n_small: int = N_MODELS_SMALL):
    """The card against the CPU at 10,000 nodes, every state field equal
    (SWIM at SW1's shape on a power-law table, SWIM with the rotating
    window and the packed rng under drops, rumor under the four mixed
    scenario shapes); then SWIM at 1M on the power-law table (SW1-SW4)
    and rumor mongering at 10M (RM1-RM3) through ``run_simulation`` with
    ``engine='auto'``, each against the JAX package's rounds, coverage
    and msgs, every launch count 0 (the models run no kernel of the
    port); SW1 and RM1 again through the command line; the runs' ms a
    round and node-rounds/s, and one SWIM round's parts at SW1's
    shape."""
    import torch
    from gossip_tpu_torch import bench
    from gossip_tpu_torch.backend import run_simulation
    from gossip_tpu_torch.config import (FaultConfig, ProtocolConfig,
                                         RunConfig, TopologyConfig)
    from gossip_tpu_torch.models import rumor as RM
    from gossip_tpu_torch.models import swim as SW
    from gossip_tpu_torch.ops import _kernels, threefry
    from gossip_tpu_torch.ops import nemesis as NE
    from gossip_tpu_torch.ops.sampling import sample_peers
    from gossip_tpu_torch.runtime import simulator as TS
    from gossip_tpu_torch.topology import generators as G

    wall_s, t0 = {}, time.perf_counter()
    swim_topo = TopologyConfig(family="power_law", n=n_swim, k=3,
                               degree_cap=256)
    runs = {}

    # the card against the CPU at n_small, every state field; first, so
    # the full-size runs below find both paths warm
    cpu = torch.device("cpu")
    same = {}
    small_topo = TopologyConfig(family="power_law", n=n_small, k=3,
                                degree_cap=256)
    (ra, da, pa, sa), (rb, db, pb, sb) = (TS.simulate_swim_until(
        _swim_proto(), n_small, 80, 0.99, dead_nodes=(1,), fail_round=2,
        topo=G.build(small_topo, d), seed=SEED, device=d)
        for d in (dev, cpu))
    same["swim_power_law"] = bool(
        (ra, da, pa) == (rb, db, pb)
        and _same_fields(sa, sb, ("wire", "timer", "msgs")))
    proto = _swim_proto(swim_rotate=True, swim_rng="packed")
    epoch = SW.resolve_epoch_rounds(proto, n_small)
    # node 11 is watched in the second epoch, which the run enters
    (fa, sa), (fb, sb) = (TS.simulate_swim_curve(
        proto, n_small, epoch + 10, dead_nodes=(11,), fail_round=0,
        fault=FaultConfig(drop_prob=0.05, seed=SEED), seed=SEED, device=d)
        for d in (dev, cpu))
    same["swim_rotating_packed"] = bool(
        (fa == fb).all() and _same_fields(sa, sb, ("wire", "timer", "msgs"))
        and sa.round == sb.round)
    mixed = NE.mixed_scenarios(4, n_small, drop_prob=0.02, seed=SEED)
    rproto = ProtocolConfig(mode="rumor", fanout=1, rumor_k=2)
    rrun = RunConfig(seed=SEED, max_rounds=64)
    for i, fault in enumerate(mixed):
        a = RM.simulate_until_rumor(rproto, G.complete(n_small), rrun, fault,
                                    dev)
        b = RM.simulate_until_rumor(rproto, G.complete(n_small), rrun, fault,
                                    cpu)
        same[f"rumor_mixed_{i}"] = (
            a[:4] == b[:4] and _same_fields(a[4], b[4], ("seen", "hot",
                                                         "cnt", "msgs")))
    check(all(same.values()), f"SWIM / rumor card vs CPU: {same}")
    wall_s["card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    def record(name, rep, want, launches):
        got = (rep.rounds, rep.coverage, rep.msgs)
        check(got == want and sum(launches.values()) == 0,
              f"{name}: {got} {launches}, want {want}")
        steady = rep.meta["steady_wall_s"]
        runs[name] = {"rounds": rep.rounds, "coverage": rep.coverage,
                      "msgs": rep.msgs, "launches": launches,
                      "steady_wall_s": steady,
                      "ms_per_round": steady * 1e3 / rep.rounds,
                      "node_rounds_per_s": rep.n * rep.rounds / steady,
                      "topo_build_s": rep.meta["topo_build_s"],
                      "meta": {k: rep.meta[k] for k in rep.meta
                               if k not in ("launches", "device")}}

    for name, (over, fault, want) in SWIM_CASES.items():
        for k in _kernels.KERNELS:
            k.launches = 0
        rep = run_simulation(_swim_proto(**over), swim_topo,
                             RunConfig(max_rounds=80, engine="auto"),
                             _swim_fault(fault), device=dev)
        record(name, rep, want,
               {k.name: k.launches for k in _kernels.KERNELS})
        check(rep.meta["swim_diss_effective"] == over.get("swim_diss",
                                                          "sort")
              and rep.meta["dead_subjects"] == [1],
              f"{name}: meta {rep.meta}")
    wall_s["swim_1m"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, (variant, fault, want) in RUMOR_CASES.items():
        for k in _kernels.KERNELS:
            k.launches = 0
        rep = run_simulation(
            ProtocolConfig(mode="rumor", fanout=1, rumor_k=2,
                           rumor_variant=variant),
            TopologyConfig(family="complete", n=n),
            RunConfig(max_rounds=128, engine="auto"),
            bench.heal_fault(n) if fault else None, device=dev)
        record(name, rep, want,
               {k.name: k.launches for k in _kernels.KERNELS})
        check(rep.meta["terminated"], f"{name}: did not die out")
    wall_s["rumor_10m"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # the command line, the JAX package's spelling
    sw1, rm1 = _port_lines(
        ["run", "--mode", "swim", "--n", str(n_swim), "--family",
         "power_law", "--k", "3", "--degree-cap", "256", "--fanout", "2",
         "--swim-subjects", "8", "--swim-proxies", "3",
         "--swim-suspect-rounds", "24", "--max-rounds", "80"],
        ["run", "--mode", "rumor", "--n", str(n), "--fanout", "1",
         "--rumor-k", "2", "--rumor-variant", "feedback", "--max-rounds",
         "128"])
    cli = {"SW1": sw1[-1], "RM1": rm1[-1]}
    for name, out in cli.items():
        want = (SWIM_CASES.get(name) or RUMOR_CASES[name])[2]
        got = (out["rounds"], out["coverage"], out["msgs"])
        check(got == want and out["meta"]["device"] != "cpu",
              f"{name} command line: {got} on {out['meta']['device']}, "
              f"want {want}")
    wall_s["command_line"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # one SWIM round's parts at SW1's shape, twenty rounds in
    topo = G.build(swim_topo, dev)
    proto = _swim_proto()
    step = SW.make_swim_round(proto, n_swim, (1,), 2, None, topo,
                              max_rounds=80, device=dev)
    st = SW.init_swim_state(n_swim, 8, SEED, dev)
    for _ in range(20):
        st = step(st)
    ids = torch.arange(n_swim, dtype=torch.int64, device=dev)
    rkey = threefry.fold_in(st.base_key, st.round)
    dkey = threefry.fold_in(rkey, SW._DISS_TAG)
    targets = sample_peers(dkey, ids, topo, 2)
    observers = SW.observer_alive(n_swim, (1,), None, dev)
    window = SW.subject_window(st.round - 1, 8, n_swim, False, 1, dev)
    split = {
        "round_ms": _median_ms(dev, step, st),
        "probe_draws_ms": _median_ms(dev, SW.probe_draws, rkey, ids, 8,
                                     n_swim, 3, 0.0),
        "peer_draws_ms": _median_ms(dev, sample_peers, dkey, ids, topo, 2),
        "packed_draws_ms": _median_ms(
            dev, SW.packed_round_draws, rkey, ids, 8, n_swim, 3, 2, 0.0,
            nbrs=topo.nbrs, deg=topo.deg, sentinel=n_swim),
        "detection_read_ms": _median_ms(
            dev, lambda: SW.detection_quotient(*SW.detection_counts(
                st.wire, (1,), observers, window)))}
    for impl in ("scatter", "sort", "pack"):
        split[f"diss_{impl}_ms"] = _median_ms(
            dev, SW.disseminate_max, targets, st.wire, n_swim, impl, 80)
    wall_s["timing"] = time.perf_counter() - t0
    emit("swim_rumor_path",
         swim_config="BASELINE.json config 4: power_law n=1M k=3 cap 256, "
         "fanout 2, 8 subjects, 3 proxies, suspicion 24, max_rounds 80",
         runs=runs, command_line={k: (v["rounds"], v["coverage"], v["msgs"])
                                  for k, v in cli.items()},
         card_vs_cpu=same, n_small=n_small, swim_round_split=split,
         phase_wall_s=wall_s, card=smi)
    return runs


def state_digests(state, fields, k: int):
    """SHA-256 of each of ``k`` row windows of ``state``'s ``fields``, the
    rows padded with zeros to a multiple of ``k`` (the node mesh's
    windows: a rank's padded rows)."""
    import hashlib

    import torch
    n = getattr(state, fields[0]).shape[0]
    n_pad = -(-n // k) * k
    nl = n_pad // k
    out = []
    for r in range(k):
        h = hashlib.sha256()
        for f in fields:
            t = getattr(state, f)
            if n_pad != n:
                t = torch.cat([t, t.new_zeros((n_pad - n,)
                                              + tuple(t.shape[1:]))])
            h.update(t[r * nl:(r + 1) * nl].contiguous().cpu().view(
                torch.uint8).numpy().data)
        out.append(h.hexdigest())
    return out


def _payload_key(rep: dict):
    """(rounds, convergence, truth, msgs) of a crdt, log or txn report."""
    if rep["mode"] == "crdt":
        return (rep["rounds"], rep["value_conv"], rep["truth_value"],
                rep["msgs"])
    conv = "log_conv" if rep["mode"] == "log" else "txn_conv"
    return rep["rounds"], rep[conv], rep["truth"], rep["msgs"]


def _payload_runs(dev, cases, replays, digest_ids=()):
    """Every id of ``cases`` through ``cli.run_payload`` on ``dev``, each
    against the JAX package's (rounds, convergence, truth, msgs) and its
    curve in ``PAYLOAD_CURVES``, no kernel launched and (on a card)
    nothing on the CPU; the ``replays`` run again on the CPU, every final
    state field equal.  Returns ``(runs, card_vs_cpu, wall_s)``: each
    run's ms a round and node-rounds/s (a curve's over its rounds), and
    for the ``digest_ids`` the final state's digests at K = 2
    (``state_digests``), which the mesh phase holds its runs to."""
    import torch
    from gossip_tpu_torch import cli
    from gossip_tpu_torch.ops import _kernels

    wall_s, runs, same = {}, {}, {}
    on_card = dev.type == "cuda"
    for name, (args, want) in cases.items():
        t0 = time.perf_counter()
        if on_card:
            torch.cuda.empty_cache()
        for k in _kernels.KERNELS:
            k.launches = 0
        rep, result = cli.run_payload([*args, "--device", dev.type])
        launches = {k.name: k.launches for k in _kernels.KERNELS}
        got = _payload_key(rep)
        check(got == want and sum(launches.values()) == 0
              and (rep["device"] != "cpu") == on_card,
              f"{name}: {got} on {rep['device']}, {launches}, want {want}")
        if name in PAYLOAD_CURVES:
            check(rep["curve"] == PAYLOAD_CURVES[name],
                  f"{name} curve {rep['curve']}")
        steady = rep["steady_wall_s"]
        rounds = len(rep["curve"]) if "curve" in rep else rep["rounds"]
        runs[name] = {"rounds": rep["rounds"], "result": list(got[1:]),
                      "launches": launches, "steady_wall_s": steady,
                      "ms_per_round": steady * 1e3 / rounds,
                      "node_rounds_per_s": rep["n"] * rounds / steady,
                      "peak_mem_bytes": rep["peak_mem_bytes"]}
        if name in digest_ids:
            runs[name]["digests"] = state_digests(result[-2], ("val",), 2)
        if name in replays:
            _, res_cpu = cli.run_payload([*args, "--device", "cpu"])
            a, b = result[-2], res_cpu[-2]
            same[name] = bool(
                torch.equal(a.val.cpu(), b.val) and a.round == b.round
                and torch.equal(a.base_key.cpu(), b.base_key)
                and torch.equal(a.msgs.cpu(), b.msgs))
        del result
        wall_s[name] = time.perf_counter() - t0
    check(all(same.values()), f"payload card vs CPU: {same}")
    return runs, same, wall_s


def _crdt_round_split(dev, n: int, kind: str = "gcounter", **cfg) -> dict:
    """One CRDT round's parts at n nodes under CR4's program (the cut at
    n / 2 for rounds [0, 6)), eight rounds in: the whole round, the
    partner draw, the drop coin (drawn every round under a program), the
    round's own blocked exchange (``step.exchange``, with the program's
    alive row, as the round calls it) and the converged count with its
    host read."""
    import torch
    from gossip_tpu_torch.config import (ChurnConfig, CrdtConfig,
                                         FaultConfig, ProtocolConfig,
                                         RunConfig)
    from gossip_tpu_torch.models import crdt as CM
    from gossip_tpu_torch.models.si import PULL_DROP_TAG, PULL_TAG
    from gossip_tpu_torch.ops import crdt as CR
    from gossip_tpu_torch.ops import nemesis as NE
    from gossip_tpu_torch.ops import threefry
    from gossip_tpu_torch.ops.sampling import drop_mask, sample_peers
    from gossip_tpu_torch.topology import generators as G

    cfg = CrdtConfig(kind=kind, **cfg)
    fault = FaultConfig(churn=ChurnConfig(partitions=((0, 6, n // 2),)))
    topo = G.complete(n)
    step = CM.make_crdt_round(cfg, ProtocolConfig(mode="pull", fanout=2),
                              topo, fault, device=dev)
    state = CM.init_crdt_state(RunConfig(), cfg, n, dev)
    for _ in range(8):
        state, _ = step(state, donate=True)
    truth = CR.ground_truth(cfg, CR.inject_args(cfg, n, dev), fault, n, 0,
                            dev)
    eventual = CR.eventual_alive_crdt(fault, n, 0, dev)
    ids = torch.arange(n, device=dev)
    rkey = threefry.fold_in(state.base_key, state.round)
    # past the cut, with no drop: the round's final partners are the draw
    partners = sample_peers(threefry.fold_in(rkey, PULL_TAG), ids, topo, 2)
    alive = NE.base_alive_or_ones(fault, n, 0, dev)
    return {
        "n": n, "kind": kind,
        "block_rows": CR.block_rows_for(CR.state_width(cfg, n), 2),
        "round_ms": _median_ms(dev, lambda: step(state)[0].round),
        "partner_draw_ms": _median_ms(
            dev, sample_peers, threefry.fold_in(rkey, PULL_TAG), ids, topo,
            2),
        "coin_ms": _median_ms(dev, drop_mask, rkey, PULL_DROP_TAG, ids, 2,
                              0.0),
        "exchange_ms": _median_ms(
            dev, lambda: step.exchange(state.val, partners, state.round,
                                       alive).shape),
        "converged_count_ms": _median_ms(
            dev, lambda: int(CR.converged_count(state.val, truth,
                                                eventual)))}


def phase_crdt_log_path(dev, smi: str, cases=None, replays=CRDT_LOG_REPLAYS,
                        command_ids=("CR1", "LG1")):
    """The CRDT payloads (with the byzantine liar program) and the
    replicated logs through the port's ``crdt`` and ``log`` command lines
    (``cli.run_payload``: the command's parse, run and report in this
    process), every id of ``CRDT_LOG_CASES`` against the JAX package's
    rounds, convergence, truth and msgs (CR1's curve too), no kernel
    launched and nothing on the CPU; ``command_ids`` again through
    ``python -m gossip_tpu_torch``; the ``replays`` run again on the
    CPU, every final state field equal to the card's; CR4 through
    ``simulate_until_crdt`` with its peak of allocated memory; each run's
    ms a round and node-rounds/s."""
    import torch

    cases = CRDT_LOG_CASES if cases is None else cases
    on_card = dev.type == "cuda"
    runs, same, wall_s = _payload_runs(dev, cases, replays, ("BZ2d",))
    cr4 = None
    if "CR4" in cases:
        from gossip_tpu_torch.config import (ChurnConfig, CrdtConfig,
                                             FaultConfig, ProtocolConfig,
                                             RunConfig)
        from gossip_tpu_torch.models.crdt import simulate_until_crdt
        from gossip_tpu_torch.topology import generators as G
        from gossip_tpu_torch.utils.timing import steady_timed
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        n = 65536
        out, steady = steady_timed(
            dev, simulate_until_crdt, CrdtConfig(kind="gcounter"),
            ProtocolConfig(mode="pull", fanout=2), G.complete(n),
            RunConfig(target_coverage=1.0, max_rounds=64),
            FaultConfig(churn=ChurnConfig(partitions=((0, 6, n // 2),))),
            device=dev)
        check((out[0], out[1], out[4], out[2]) == CRDT_LOG_CASES["CR4"][1],
              f"CR4 through simulate_until_crdt: {out[:3]} {out[4]}")
        state_bytes = out[3].val.numel() * 4
        del out
        peak = torch.cuda.max_memory_allocated(dev)
        cr4 = {"rounds": 21, "steady_wall_s": steady,
               "ms_per_round": steady * 1e3 / 21, "peak_mem_bytes": peak,
               "state_bytes": state_bytes,
               "peak_over_two_states": peak / (2 * state_bytes)}
        # a round holds the state, its successor and one block
        for got in (peak, runs["CR4"]["peak_mem_bytes"]):
            check(got <= 2.1 * state_bytes,
                  f"CR4 peak {got} B over two states of {state_bytes} B")
        wall_s["cr4_direct"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    split = {}
    if on_card:
        torch.cuda.empty_cache()
        split["CR4"] = _crdt_round_split(dev, 65536)
        split["CR3"] = _crdt_round_split(dev, 65536, "orset", elements=256)
        torch.cuda.empty_cache()
    wall_s["round_split"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = _port_lines(*(cases[name][0] for name in command_ids))
    for name, lines_out in zip(command_ids, outs):
        want, out = cases[name][1], lines_out[-1]
        check(_payload_key(out) == want
              and (out["device"] != "cpu") == on_card,
              f"{name} command line: {_payload_key(out)} on "
              f"{out['device']}, want {want}")
    wall_s["command_line"] = time.perf_counter() - t0
    emit("crdt_log_path", runs=runs, card_vs_cpu=same, cr4_direct=cr4,
         round_split=split, command_line=list(command_ids),
         phase_wall_s=wall_s, card=smi)
    return runs, cr4


def _txn_fault(n: int, heal: bool):
    """TX10Mh's program at n (a cut at n / 2 for rounds [0, 8), node 3
    down for rounds [2, 5), the drop rate ramped 0 -> 0.3 over [1, 4)),
    or None for TX10M."""
    from gossip_tpu_torch.config import ChurnConfig, FaultConfig
    if not heal:
        return None
    return FaultConfig(churn=ChurnConfig(
        events=((3, 2, 5),), partitions=((0, 8, n // 2),),
        ramp=(1, 4, 0.0, 0.3)))


def _txn_round_split(dev, n: int, heal: bool) -> dict:
    """One register round's parts at n nodes (TX10M's deployment, or
    TX10Mh's with ``heal``), eight rounds in, past the writes and the
    cut: the whole round, the partner draw, the drop coin (drawn every
    round under a program), the round's own blocked exchange
    (``step.exchange``, with the program's alive row) and the converged
    count with its host read."""
    import torch
    from gossip_tpu_torch.config import ProtocolConfig, RunConfig, TxnConfig
    from gossip_tpu_torch.models import register as RM
    from gossip_tpu_torch.models.si import PULL_DROP_TAG, PULL_TAG
    from gossip_tpu_torch.ops import crdt as CR
    from gossip_tpu_torch.ops import nemesis as NE
    from gossip_tpu_torch.ops import registers as RG
    from gossip_tpu_torch.ops import threefry
    from gossip_tpu_torch.ops.sampling import drop_mask, sample_peers
    from gossip_tpu_torch.topology import generators as G

    cfg, fault, topo = TxnConfig(keys=8), _txn_fault(n, heal), G.complete(n)
    raw = RM.make_register_round(cfg, ProtocolConfig(mode="pull", fanout=2),
                                 topo, fault, device=dev)
    step = NE.drop_lost(raw, NE.get(fault))
    state = RM.init_reg_state(RunConfig(), cfg, n, dev)
    for _ in range(8):
        state = step(state, donate=True)
    truth = RG.ground_truth(cfg, RG.inject_args(cfg, n, dev), fault, n, 0)
    eventual = RG.eventual_alive_crdt(fault, n, 0, dev)
    ids = torch.arange(n, device=dev)
    rkey = threefry.fold_in(state.base_key, state.round)
    partners = sample_peers(threefry.fold_in(rkey, PULL_TAG), ids, topo, 2)
    alive = NE.base_alive_or_ones(fault, n, 0, dev) if heal else None
    split = {
        "n": n, "program": "TX10Mh" if heal else "TX10M",
        "block_rows": CR.block_rows_for(RG.state_width(cfg), 2),
        "round_ms": _median_ms(dev, lambda: step(state).round),
        "partner_draw_ms": _median_ms(
            dev, sample_peers, threefry.fold_in(rkey, PULL_TAG), ids, topo,
            2),
        "exchange_ms": _median_ms(
            dev, lambda: raw.exchange(state.val, partners, state.round,
                                      alive).shape),
        "converged_count_ms": _median_ms(
            dev, lambda: int(CR.converged_count(state.val, truth,
                                                eventual)))}
    if heal:
        split["coin_ms"] = _median_ms(dev, drop_mask, rkey, PULL_DROP_TAG,
                                      ids, 2, 0.3)
    return split


def _draw_peak(dev, n: int) -> int:
    """Bytes one bare partner draw at n nodes (fanout 2, the complete
    graph) allocates at its peak above what was allocated before it."""
    import torch
    from gossip_tpu_torch.models.si import PULL_TAG
    from gossip_tpu_torch.ops import threefry
    from gossip_tpu_torch.ops.sampling import sample_peers
    from gossip_tpu_torch.topology import generators as G
    ids = torch.arange(n, device=dev)
    key = threefry.fold_in(threefry.fold_in(threefry.key(SEED, dev), 3),
                           PULL_TAG)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    partners = sample_peers(key, ids, G.complete(n), 2)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - before
    del partners
    return peak


def phase_txn_path(dev, smi: str, cases=None, replays=TXN_REPLAYS,
                   command_ids=("TX1", "TX10M"), n: int = N):
    """The LWW registers and the txn workload (with the liar program and
    the owner/clamp defense) through the port's ``txn`` command line
    (``cli.run_payload``), every id of ``TXN_CASES`` against the JAX
    package's rounds, txn_conv, truth and msgs (TX1's and TX3's curves
    too), no kernel launched and nothing on the CPU; the ``replays`` run
    again on the CPU, every final state field equal to the card's;
    ``command_ids`` again through ``python -m gossip_tpu_torch txn``;
    TX10M through ``simulate_until_txn`` with its peak of allocated
    memory beside the state's bytes and a bare partner draw's peak; one
    round's parts at TX10M's and TX10Mh's deployments; each run's ms a
    round and node-rounds/s."""
    import torch

    cases = TXN_CASES if cases is None else cases
    on_card = dev.type == "cuda"
    runs, same, wall_s = _payload_runs(dev, cases, replays)
    memory = None
    if on_card and "TX10M" in cases:
        from gossip_tpu_torch.config import (ProtocolConfig, RunConfig,
                                             TxnConfig)
        from gossip_tpu_torch.models.register import simulate_until_txn
        from gossip_tpu_torch.topology import generators as G
        from gossip_tpu_torch.utils.timing import steady_timed
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        out, steady = steady_timed(
            dev, simulate_until_txn, TxnConfig(keys=8),
            ProtocolConfig(mode="pull", fanout=2), G.complete(n),
            RunConfig(target_coverage=1.0, max_rounds=64), None, device=dev)
        want = TXN_CASES["TX10M"][1]
        check((out[0], out[1], out[4], out[2]) == want,
              f"TX10M through simulate_until_txn: {out[:3]} {out[4]}")
        state_bytes = out[3].val.numel() * 4
        peak = torch.cuda.max_memory_allocated(dev)
        digests = {f"digests_k{k}": state_digests(out[3], ("val",), k)
                   for k in (1, 2)}
        del out
        torch.cuda.empty_cache()
        draw = _draw_peak(dev, n)
        memory = {"rounds": want[0], "steady_wall_s": steady,
                  "ms_per_round": steady * 1e3 / want[0],
                  "peak_mem_bytes": peak, "state_bytes": state_bytes,
                  "draw_peak_bytes": draw,
                  "peak_over_two_states": peak / (2 * state_bytes),
                  "peak_beyond_two_states_over_draw":
                      (peak - 2 * state_bytes) / draw, **digests}
        wall_s["tx10m_direct"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    split = {}
    if on_card:
        torch.cuda.empty_cache()
        split["TX10M"] = _txn_round_split(dev, n, False)
        split["TX10Mh"] = _txn_round_split(dev, n, True)
        torch.cuda.empty_cache()
    wall_s["round_split"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = _port_lines(*(cases[name][0] for name in command_ids))
    for name, lines_out in zip(command_ids, outs):
        want, out = cases[name][1], lines_out[-1]
        check(_payload_key(out) == want
              and (out["device"] != "cpu") == on_card,
              f"{name} command line: {_payload_key(out)} on "
              f"{out['device']}, want {want}")
    wall_s["command_line"] = time.perf_counter() - t0
    emit("txn_path", runs=runs, card_vs_cpu=same, tx10m_memory=memory,
         round_split=split, command_line=list(command_ids),
         phase_wall_s=wall_s, card=smi)
    return runs, memory


def _mesh_rank(n: int, group):
    """One rank of the library-API mesh runs at ``n`` nodes: configuration
    5 (32 rumors) on the packed sharded loop and the dense sharded curve
    (one rumor), each with this rank's final rows."""
    from gossip_tpu_torch.config import ProtocolConfig, RunConfig
    from gossip_tpu_torch.parallel import sharded as SH
    from gossip_tpu_torch.parallel import sharded_packed as SP
    from gossip_tpu_torch.topology import generators as G
    topo = G.complete(n)
    packed = SP.simulate_until_packed_sharded(
        ProtocolConfig(mode="pull", rumors=RUMORS), topo,
        RunConfig(seed=SEED, target_coverage=0.99, engine="xla"), group)
    curve = SH.simulate_curve_sharded(
        ProtocolConfig(mode="pull"), topo,
        RunConfig(seed=SEED, max_rounds=MESH_CURVE_ROUNDS, engine="xla"),
        group)
    return packed, curve


def _mesh_numbers(rep: dict, rounds: int) -> dict:
    """ms a round, the all_gather's ms a round and every rank's peak
    allocated memory of a sharded run's report."""
    meta = rep["meta"]
    return {"ms_per_round": meta["steady_wall_s"] * 1e3 / rounds,
            "all_gather_ms_per_round":
                meta["collective_ms"]["all_gather"]["ms"] / rounds,
            "collective_ms": meta["collective_ms"],
            "rank_peak_mem_bytes": meta["rank_peak_mem_bytes"],
            "process_group": meta["process_group"]}


def phase_mesh_path(dev, smi: str):
    """The node-sharded drivers on the card: (a) K = 1 under NCCL through
    the library API, packed and dense, at N = 10M, which must print
    ``XLA_10M`` and end in the single-device port's state; (b) K = 2
    ranks on this one card under gloo through ``python -m
    gossip_tpu_torch run --devices 2 --share-card``: configuration 5
    (10M x 32) and the dense 10M curve, which must print the JAX
    package's values (``MESH_CFG5``, ``MESH_CURVE``), and the same two
    runs through the library API, whose final states must equal the
    single-device port runs'; (c) each run's ms a round, its all_gather's
    ms a round and every rank's peak allocated memory."""
    import torch
    from gossip_tpu_torch.config import ProtocolConfig, RunConfig
    from gossip_tpu_torch.models.si_packed import simulate_until_packed
    from gossip_tpu_torch.parallel import group as GR
    from gossip_tpu_torch.parallel import sharded as SH
    from gossip_tpu_torch.parallel import sharded_packed as SP
    from gossip_tpu_torch.runtime.simulator import simulate_curve
    from gossip_tpu_torch.topology import generators as G
    from gossip_tpu_torch.utils.timing import steady_timed

    t_phase = time.perf_counter()
    topo = G.complete(N)
    pull = ProtocolConfig(mode="pull", fanout=1)
    run = RunConfig(seed=SEED, target_coverage=0.99, engine="xla")
    one = _xla_packed(N, dev)[3].seen
    k1 = {}
    with GR.local(dev) as g:
        check(g.backend == "nccl" and g.size == 1, f"K = 1 group {g}")
        for name, fn in (("packed", SP.simulate_until_packed_sharded),
                         ("dense", SH.simulate_until_sharded)):
            g.collective_ms(reset=True)
            torch.cuda.reset_peak_memory_stats(dev)
            res, steady = steady_timed(dev, fn, pull, topo, run, g)
            coll = g.collective_ms()
            seen = res[3].seen
            same = (torch.equal(seen, one) if name == "packed"
                    else torch.equal(seen[:, 0], (one[:, 0] & 1).bool()))
            check(res[:3] == XLA_10M and same,
                  f"K = 1 {name}: {res[:3]}, want {XLA_10M}; state equal "
                  f"{same}")
            k1[name] = {"result": list(res[:3]), "state_equals_single":
                        same, "ms_per_round": steady * 1e3 / res[0],
                        "all_gather_ms_per_round":
                            coll["all_gather"]["ms"] / res[0],
                        "collective_ms": coll,
                        "peak_mem_bytes": torch.cuda.max_memory_allocated(
                            dev)}
    emit("mesh_k1", process_group="nccl", runs=k1, want=XLA_10M, card=smi)

    base = ["--devices", "2", "--share-card", "--mode", "pull", "--n",
            str(N), "--engine", "xla"]
    cfg5, curve = (out[-1] for out in _port_lines(
        ["run", *base, "--rumors", str(RUMORS)],
        ["run", *base, "--curve", "--max-rounds", str(MESH_CURVE_ROUNDS)]))
    got = (cfg5["rounds"], cfg5["coverage"], cfg5["msgs"])
    check(got == MESH_CFG5 and cfg5["meta"]["engine"] == "bit-packed"
          and cfg5["meta"]["devices"] == 2
          and cfg5["meta"]["process_group"] == "gloo",
          f"configuration 5 at K = 2: {got} {cfg5['meta']}, want "
          f"{MESH_CFG5}")
    got_c = (curve["rounds"], curve["coverage"], curve["msgs"])
    check(got_c == MESH_CURVE and curve["curve"] == MESH_CURVE_VALUES
          and "engine" not in curve["meta"],
          f"dense curve at K = 2: {got_c}, want {MESH_CURVE}")

    ranks = GR.launch(_mesh_rank, 2, N, device=dev, shared_card=True)
    single5, s5 = steady_timed(
        dev, simulate_until_packed, ProtocolConfig(mode="pull",
                                                    rumors=RUMORS),
        topo, run, None, dev)
    words = torch.cat([r[0][3].seen for r in ranks])[:N]
    same5 = torch.equal(words, single5[3].seen.cpu())
    check(ranks[0][0][:3] == MESH_CFG5 and same5,
          f"library configuration 5: {ranks[0][0][:3]}, state equal {same5}")
    single_c, sc = steady_timed(dev, simulate_curve, pull, topo, RunConfig(
        seed=SEED, max_rounds=MESH_CURVE_ROUNDS, engine="xla"), None, dev)
    seen = torch.cat([r[1][2].seen for r in ranks])[:N]
    same_c = torch.equal(seen, single_c.state.seen.cpu())
    check(ranks[0][1][0].tolist() == MESH_CURVE_VALUES and same_c,
          f"library dense curve: state equal {same_c}")
    emit("mesh_path",
         cfg5={"command": base + ["--rumors", str(RUMORS)],
               "result": list(got), "want": MESH_CFG5,
               **_mesh_numbers(cfg5, cfg5["rounds"])},
         curve={"command": base + ["--curve", "--max-rounds",
                                   str(MESH_CURVE_ROUNDS)],
                "result": list(got_c), "want": MESH_CURVE,
                **_mesh_numbers(curve, MESH_CURVE_ROUNDS)},
         single_device_ms_per_round={
             "cfg5": s5 * 1e3 / single5[0],
             "curve": sc * 1e3 / MESH_CURVE_ROUNDS},
         states_equal_single_device={"cfg5": same5, "curve": same_c},
         phase_s=time.perf_counter() - t_phase, card=smi)
    return _mesh_numbers(cfg5, cfg5["rounds"])["ms_per_round"]


SWIM_FIELDS, RUMOR_FIELDS = ("wire", "timer"), ("seen", "hot", "cnt")


def _swim_args(n_swim: int):
    return ["--mode", "swim", "--n", str(n_swim), "--family", "power_law",
            "--k", "3", "--degree-cap", "256", "--fanout", "2",
            "--swim-subjects", "8", "--swim-proxies", "3",
            "--swim-suspect-rounds", "24", "--max-rounds", "80"]


def _launch_counts() -> dict:
    from gossip_tpu_torch.ops import _kernels
    return {k.name: k.launches for k in _kernels.KERNELS}


def _check_no_launches(what: str, rank_launches) -> None:
    """Every rank of a mesh run launched no kernel of the port (the mesh
    drivers draw through threefry)."""
    check(rank_launches is not None
          and all(sum(r.values()) == 0 for r in rank_launches),
          f"{what}: the ranks launched {rank_launches}")


def _timed_group(group, fn, *args, **kwargs):
    """``(result, numbers)`` of one library-API run on this rank: its
    steady seconds, each collective's calls and ms, every rank's peak
    allocated memory, and this rank's kernel launches in the run."""
    import torch
    from gossip_tpu_torch.parallel import group as GR
    from gossip_tpu_torch.utils.timing import steady_timed
    dev = group.device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    group.collective_ms(reset=True)
    before = _launch_counts()
    out, steady = steady_timed(dev, fn, *args, group=group, **kwargs)
    after = _launch_counts()
    coll = group.collective_ms()
    return out, {"steady_s": steady, "collective_ms": coll,
                 "rank_peak_mem_bytes": GR.peak_memory(group),
                 "launches": {k: after[k] - before[k] for k in after}}


def _mesh_models_rank(n: int, n_swim: int, group):
    """One rank of the library-API runs of the model and payload drivers
    at K ranks: TX10M, BZ2d, SW1 and RM1, each with its result, this
    rank's SHA-256 of its padded final rows (never the rows: a 10M-node
    state stays on the card) and its numbers."""
    from gossip_tpu_torch.config import (ByzConfig, CrdtConfig, FaultConfig,
                                         ProtocolConfig, RunConfig,
                                         TopologyConfig, TxnConfig)
    from gossip_tpu_torch.parallel import sharded_crdt as SC
    from gossip_tpu_torch.parallel import sharded_register as SRG
    from gossip_tpu_torch.parallel import sharded_rumor as SRU
    from gossip_tpu_torch.runtime import simulator as TS
    from gossip_tpu_torch.topology import generators as G
    out = {}
    res, nums = _timed_group(
        group, SRG.simulate_until_txn_sharded, TxnConfig(keys=8),
        ProtocolConfig(mode="pull", fanout=2), G.complete(n),
        RunConfig(target_coverage=1.0, max_rounds=64))
    out["TX10M"] = ((res[0], res[1], res[4], res[2]),
                    state_digests(res[3], ("val",), 1)[0], nums)
    del res
    liars = ((3, 2, "inflate", 5), (11, 0, "corrupt", 1048576))
    res, nums = _timed_group(
        group, SC.simulate_until_crdt_sharded,
        CrdtConfig(kind="orset", elements=256, set_removes=((5, 3),)),
        ProtocolConfig(mode="pull", fanout=3), G.complete(65536),
        RunConfig(target_coverage=1.0, max_rounds=64),
        fault=FaultConfig(byz=ByzConfig(liars=liars)), defend=True)
    out["BZ2d"] = ((res[0], res[1], res[4], res[2]),
                   state_digests(res[3], ("val",), 1)[0], nums)
    topo = G.build(TopologyConfig(family="power_law", n=n_swim, k=3,
                                  degree_cap=256), group.device)
    res, nums = _timed_group(
        group, TS.simulate_swim_until, _swim_proto(), n_swim, 80, 0.99,
        dead_nodes=(1,), fail_round=2, topo=topo, seed=SEED)
    out["SW1"] = ((res[0], res[1], float(res[3].msgs)),
                  state_digests(res[3], SWIM_FIELDS, 1)[0], nums)
    res, nums = _timed_group(
        group, SRU.simulate_until_rumor_sharded,
        ProtocolConfig(mode="rumor", fanout=1, rumor_k=2), G.complete(n),
        RunConfig(max_rounds=128))
    out["RM1"] = ((res[0], res[1], res[3]),
                  state_digests(res[4], RUMOR_FIELDS, 1)[0], nums)
    return out


def _mesh_run_numbers(meta: dict, rounds: int) -> dict:
    """ms a round, each collective's ms a round, every rank's peak
    allocated memory and every rank's kernel launches, of a mesh run's
    report keys."""
    return {"rounds_run": rounds,
            "ms_per_round": meta["steady_wall_s"] * 1e3 / rounds,
            "collective_ms_per_round": {
                k: c["ms"] / rounds for k, c in meta["collective_ms"].items()},
            "rank_peak_mem_bytes": meta["rank_peak_mem_bytes"],
            "rank_launches": meta["rank_launches"],
            "process_group": meta["process_group"]}


def phase_mesh_models(dev, smi: str, single_runs: dict,
                      n: int = N, n_swim: int = N_SWIM):
    """The node-sharded SWIM, rumor and payload drivers on the card:
    (a) K = 2 ranks sharing it under gloo through the port's command
    lines (``--devices 2 --share-card``): SW1, RM1, CR3, LG1 and TX1,
    each against the JAX package's values on its 2-device mesh
    (``MESH_*``, TX1's curve too); (b) K = 2 through the library API in
    one spawn: TX10M, BZ2d, SW1 and RM1, each against the same values
    and each rank's digest of its padded final rows against the
    single-device port run's (TX10M's and BZ2d's from the earlier
    phases, in ``single_runs``; SW1's and RM1's run here); (c) K = 1 under NCCL: CR4 (the
    65,536-node G-counter, its peak allocated memory at most 4.1 states)
    and TX10M, against the single-device values and, for TX10M, state.
    Each run's ms a round, each collective's ms a round and every rank's
    peak allocated memory, beside the single-device run's ms a round."""
    import torch
    from gossip_tpu_torch.config import (ChurnConfig, CrdtConfig,
                                         FaultConfig, ProtocolConfig,
                                         RunConfig, TopologyConfig,
                                         TxnConfig)
    from gossip_tpu_torch.models import rumor as RM
    from gossip_tpu_torch.ops import _kernels
    from gossip_tpu_torch.parallel import group as GR
    from gossip_tpu_torch.parallel import sharded_crdt as SC
    from gossip_tpu_torch.parallel import sharded_register as SRG
    from gossip_tpu_torch.runtime import simulator as TS
    from gossip_tpu_torch.topology import generators as G
    from gossip_tpu_torch.utils.timing import steady_timed

    t_phase, wall_s = time.perf_counter(), {}
    for k in _kernels.KERNELS:
        k.launches = 0
    torch.cuda.empty_cache()

    # (a) the command lines, two ranks on this card
    share = ["--devices", "2", "--share-card"]
    commands = {
        "SW1": (["run", *_swim_args(n_swim)], MESH_SW1),
        "RM1": (["run", "--mode", "rumor", "--n", str(n), "--fanout", "1",
                 "--rumor-k", "2", "--max-rounds", "128"], MESH_RM1),
        "CR3": (CRDT_LOG_CASES["CR3"][0], MESH_CR3),
        "LG1": (CRDT_LOG_CASES["LG1"][0], MESH_LG1),
        "TX1": (TXN_CASES["TX1"][0], MESH_TX1),
    }
    cli_runs = {}
    # every command line in one process (one start-up for the five)
    t0 = time.perf_counter()
    outs = _port_lines(*([*args, *share] for args, _ in commands.values()))
    wall_s["cli"] = time.perf_counter() - t0
    for (name, (args, want)), lines_out in zip(commands.items(), outs):
        out = lines_out[-1]
        if args[0] == "run":
            got = (out["rounds"], out["coverage"], out["msgs"])
            meta, rounds = out["meta"], out["rounds"]
        else:
            got, meta = _payload_key(out), out
            rounds = len(out["curve"]) if "curve" in out else out["rounds"]
        ok = (got == want and meta["devices"] == 2
              and meta["process_group"] == "gloo")
        if args[0] != "run":
            ok = ok and out["engine"] == f"{args[0]}-sharded"
        check(ok, f"{name} at K = 2: {got}, want {want}; {meta}")
        _check_no_launches(f"{name} at K = 2", meta["rank_launches"])
        if name in PAYLOAD_CURVES:
            check(out["curve"] == PAYLOAD_CURVES[name],
                  f"{name} curve at K = 2: {out['curve']}")
        cli_runs[name] = {"command": [*args, *share], "result": list(got),
                          **_mesh_run_numbers(meta, rounds),
                          "single_device_ms_per_round":
                              single_runs.get(name, {}).get("ms_per_round")}

    # (b) the library API, one spawn of two ranks on this card
    t0 = time.perf_counter()
    ranks = GR.launch(_mesh_models_rank, 2, n, n_swim, device=dev,
                      shared_card=True)
    wall_s["library_spawn"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    swim_topo = G.build(TopologyConfig(family="power_law", n=n_swim, k=3,
                                       degree_cap=256), dev)
    digests = {"TX10M": single_runs["TX10M_direct"]["digests_k2"],
               "BZ2d": single_runs["BZ2d"]["digests"]}
    (r, det, _, sw), s_sw = steady_timed(
        dev, TS.simulate_swim_until, _swim_proto(), n_swim, 80, 0.99,
        dead_nodes=(1,), fail_round=2, topo=swim_topo, seed=SEED,
        device=dev)
    digests["SW1"] = state_digests(sw, SWIM_FIELDS, 2)
    del sw, swim_topo
    rm, s_rm = steady_timed(dev, RM.simulate_until_rumor, ProtocolConfig(
        mode="rumor", fanout=1, rumor_k=2), G.complete(n),
        RunConfig(max_rounds=128), None, dev)
    digests["RM1"] = state_digests(rm[4], RUMOR_FIELDS, 2)
    del rm
    wall_s["single_device_sw1_rm1"] = time.perf_counter() - t0
    single_ms = {"SW1": s_sw * 1e3 / r, "RM1": s_rm * 1e3 / MESH_RM1[0]}
    wants = {"TX10M": MESH_TX10M, "BZ2d": MESH_BZ2D, "SW1": MESH_SW1,
             "RM1": MESH_RM1}
    library = {}
    for name, want in wants.items():
        got = ranks[0][name][0]
        got_d = [rk[name][1] for rk in ranks]
        check(tuple(got) == tuple(want) and got_d == digests[name],
              f"{name} library K = 2: {got}, want {want}; digests "
              f"{got_d} vs single {digests[name]}")
        nums = ranks[0][name][2]
        rank_launches = [rk[name][2]["launches"] for rk in ranks]
        _check_no_launches(f"{name} library K = 2", rank_launches)
        rounds = got[0]
        library[name] = {
            "result": list(got), "digests_equal_single": True,
            "ms_per_round": nums["steady_s"] * 1e3 / rounds,
            "collective_ms_per_round": {
                k: c["ms"] / rounds for k, c in nums["collective_ms"].items()},
            "rank_peak_mem_bytes": nums["rank_peak_mem_bytes"],
            "rank_launches": rank_launches,
            "single_device_ms_per_round": single_ms.get(name) or
            single_runs.get(name, {}).get("ms_per_round")}

    # (c) K = 1 under NCCL: CR4 and TX10M
    t0 = time.perf_counter()
    k1 = {}
    with GR.local(dev) as g:
        check(g.backend == "nccl" and g.size == 1, f"K = 1 group {g}")
        m = 65536
        cr4, nums = _timed_group(
            g, SC.simulate_until_crdt_sharded, CrdtConfig(kind="gcounter"),
            ProtocolConfig(mode="pull", fanout=2), G.complete(m),
            RunConfig(target_coverage=1.0, max_rounds=64),
            fault=FaultConfig(churn=ChurnConfig(
                partitions=((0, 6, m // 2),))))
        got = (cr4[0], cr4[1], cr4[4], cr4[2])
        state_bytes = cr4[3].val.numel() * 4
        del cr4
        peak = nums["rank_peak_mem_bytes"][0]
        check(got == CRDT_LOG_CASES["CR4"][1] and peak <= 4.1 * state_bytes,
              f"CR4 at K = 1: {got}, peak {peak} B over a state of "
              f"{state_bytes} B")
        k1["CR4"] = {"result": list(got), "state_bytes": state_bytes,
                     "peak_over_state": peak / state_bytes,
                     "ms_per_round": nums["steady_s"] * 1e3 / got[0],
                     "collective_ms_per_round": {
                         k: c["ms"] / got[0]
                         for k, c in nums["collective_ms"].items()},
                     "rank_peak_mem_bytes": nums["rank_peak_mem_bytes"],
                     "single_device_ms_per_round":
                         single_runs.get("CR4", {}).get("ms_per_round")}
        tx, nums = _timed_group(
            g, SRG.simulate_until_txn_sharded, TxnConfig(keys=8),
            ProtocolConfig(mode="pull", fanout=2), G.complete(n),
            RunConfig(target_coverage=1.0, max_rounds=64))
        got = (tx[0], tx[1], tx[4], tx[2])
        same = (state_digests(tx[3], ("val",), 1)
                == single_runs["TX10M_direct"]["digests_k1"])
        state_bytes = tx[3].val.numel() * 4
        del tx
        check(got == TXN_CASES["TX10M"][1] and same,
              f"TX10M at K = 1: {got}, state equal {same}")
        k1["TX10M"] = {"result": list(got), "state_bytes": state_bytes,
                       "state_equals_single": True,
                       "peak_over_state":
                           nums["rank_peak_mem_bytes"][0] / state_bytes,
                       "ms_per_round": nums["steady_s"] * 1e3 / got[0],
                       "collective_ms_per_round": {
                           k: c["ms"] / got[0]
                           for k, c in nums["collective_ms"].items()},
                       "rank_peak_mem_bytes": nums["rank_peak_mem_bytes"],
                       "single_device_ms_per_round":
                           single_runs.get("TX10M", {}).get(
                               "ms_per_round")}
    wall_s["k1_nccl"] = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    check(sum(launches.values()) == 0, f"mesh models launched {launches}")
    # the largest G-counter n: a rank of the gather design holds its rows,
    # the gathered table and its rows' successor, 4 n^2 (1 + 2 / K) bytes
    # (measured at K = 1: CR4's peak over its state); the single-device
    # loop holds the state and its successor
    card = torch.cuda.get_device_properties(dev).total_memory
    ratios = {"single_device_loop": (single_runs.get("CR4_direct") or {})
              .get("peak_over_two_states", 1.05) * 2,
              "k1_measured": k1["CR4"]["peak_over_state"]}
    ratios.update({f"k{k}_model": 1 + 2 / k for k in (2, 4, 8)})
    n_max = {name: int((card / (4 * r)) ** 0.5) for name, r in ratios.items()}
    emit("mesh_models", cli_k2=cli_runs, library_k2=library, k1_nccl=k1,
         gcounter_n_max={"card_bytes": card, "peak_over_state": ratios,
                         "n": n_max},
         launches=launches, phase_wall_s=wall_s,
         phase_s=time.perf_counter() - t_phase, card=smi)


def _exchange_configs(name: str):
    """``(proto, topology config, run, fault)`` of an exchange case, as
    its command line in ``EXCHANGE_CASES`` builds them."""
    from gossip_tpu_torch import cli
    return cli.run_configs(cli.build_parser().parse_args(
        ["run", *EXCHANGE_CASES[name][0]]))


def _exchange_rank(group):
    """One rank of the library-API exchange runs at K ranks: each case's
    result, this rank's SHA-256 of its padded final rows and its numbers;
    then the dense exchange's runs of TS3 and HL1 (their numbers, and
    HL1's result, which the halo's trajectory equals)."""
    from gossip_tpu_torch.parallel import halo as HL
    from gossip_tpu_torch.parallel import sharded as SH
    from gossip_tpu_torch.parallel import sharded_packed as SP
    from gossip_tpu_torch.parallel import sharded_sparse as SS
    from gossip_tpu_torch.topology import generators as G
    out = {}
    for name in EXCHANGE_CASES:
        proto, tc, run, fault = _exchange_configs(name)
        topo = G.build(tc, group.device)
        if name == "HL1":
            res, nums = _timed_group(group, HL.simulate_until_halo, proto,
                                     topo, run, fault=fault)
        elif name == "TS3":
            res, nums = _timed_group(group, SS.simulate_until_topo_sparse,
                                     proto, topo, run, fault=fault)
        else:
            res, nums = _timed_group(group, SS.simulate_until_sparse, proto,
                                     tc.n, run, fault=fault)
        out[name] = (res[:3], state_digests(res[3], ("seen",), 1)[0], nums)
        del res, topo
    for name, fn in (("TS3", SP.simulate_until_packed_sharded),
                     ("HL1", SH.simulate_until_sharded)):
        proto, tc, run, fault = _exchange_configs(name)
        topo = G.build(tc, group.device)
        res, nums = _timed_group(group, fn, proto, topo, run, fault=fault)
        out[f"{name}_dense"] = (res[:3], None, nums)
    return out


def _twin_digests(dev, name: str, rounds: int):
    """``(digests, ms a round)`` of a case's single-device state on the
    card, in the two ranks' windows: the sparse cases' twin at p = 2
    stepped ``rounds`` times, HL1's single-device XLA run (the halo
    trajectory is the single-device one)."""
    import torch
    from gossip_tpu_torch.ops import nemesis as NE
    from gossip_tpu_torch.parallel import sharded_sparse as SS
    from gossip_tpu_torch.runtime.simulator import simulate_until
    from gossip_tpu_torch.topology import generators as G
    from gossip_tpu_torch.utils.timing import steady_timed
    proto, tc, run, fault = _exchange_configs(name)
    topo = G.build(tc, dev)
    if name == "HL1":
        res, steady = steady_timed(dev, simulate_until, proto, topo, run,
                                   fault, dev)
        check(res.state.round == rounds,
              f"HL1 single device: {res.state.round} rounds")
        return state_digests(res.state, ("seen",), 2), steady * 1e3 / rounds

    def twin():
        state = SS.init_sparse_state(run, proto, tc.n, p=2, device=dev)
        if name == "TS3":
            step = SS.sparse_topo_pull_round_reference(proto, topo, 2, fault,
                                                       device=dev)
            ovf = torch.zeros((), device=dev)
            for _ in range(rounds):
                state, ovf = step(state, ovf)
            return state
        step = NE.drop_lost(SS.sparse_pull_round_reference(
            proto, tc.n, 2, fault, device=dev), NE.get(fault))
        for _ in range(rounds):
            state = step(state)
        return state

    state, steady = steady_timed(dev, twin)
    return state_digests(state, ("seen",), 2), steady * 1e3 / rounds


def phase_mesh_exchanges(dev, smi: str, cfg5_dense_ms=None):
    """The sparse and halo exchanges at K = 2 ranks on this card under
    gloo: (a) each of ``EXCHANGE_CASES`` through ``python -m
    gossip_tpu_torch run --devices 2 --share-card``, which must print the
    JAX package's values on its 2-device mesh (TS3 with its overflow and
    bucket cap) and the exchange's meta; (b) the same runs through the
    library API in one spawn, each rank's SHA-256 of its padded final
    rows against the window of the single-device state (the sparse twin
    at p = 2, HL1's XLA run) on the card; the dense exchange's TS3 and
    HL1 in that spawn; (c) each run's ms a round, each collective's ms a
    round by name, the report's ``ici_bytes_per_round`` and every rank's
    peak allocated memory, beside the dense exchange's ms a round
    (configuration 5's from ``mesh_path``) and the twin's.  Every rank
    of every run launches no kernel of the port (the exchanges draw
    through threefry): the command lines' ranks count theirs in the
    report's ``rank_launches``, the library's ranks each run's in
    :func:`_timed_group`; the single-device twins, run here, are counted
    apart."""
    import torch
    from gossip_tpu_torch.parallel import group as GR

    t_phase, wall_s = time.perf_counter(), {}
    torch.cuda.empty_cache()
    share = ["--devices", "2", "--share-card"]
    cli_runs = {}
    # every command line in one process (one start-up for the five)
    t0 = time.perf_counter()
    outs = _port_lines(*(["run", *args, *share]
                         for args, _ in EXCHANGE_CASES.values()))
    wall_s["cli"] = time.perf_counter() - t0
    for (name, (args, want)), lines_out in zip(EXCHANGE_CASES.items(), outs):
        out = lines_out[-1]
        got = (out["rounds"], out["coverage"], out["msgs"])
        meta = out["meta"]
        exchange = args[-1]
        ok = (got == want and meta["devices"] == 2
              and meta["process_group"] == "gloo"
              and meta["exchange"] == exchange)
        if name == "TS3":
            ok = ok and (meta["overflow_dropped_requests"],
                         meta["bucket_cap"]) == (MESH_TS3_OVERFLOW,
                                                 MESH_TS3_CAP)
        check(ok, f"{name} at K = 2: {got}, want {want}; {meta}")
        _check_no_launches(f"{name} at K = 2", meta["rank_launches"])
        cli_runs[name] = {
            "command": [*args, *share], "result": list(got),
            **{k: meta[k] for k in ("ici_bytes_per_round",
                                    "overflow_dropped_requests",
                                    "bucket_cap", "band") if k in meta},
            **_mesh_run_numbers(meta, out["rounds"])}

    t0 = time.perf_counter()
    ranks = GR.launch(_exchange_rank, 2, device=dev, shared_card=True)
    wall_s["library_spawn"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    library = {}
    twin_before = _launch_counts()
    for name, (_, want) in EXCHANGE_CASES.items():
        got = tuple(ranks[0][name][0])
        digests, single_ms = _twin_digests(dev, name, want[0])
        got_d = [rk[name][1] for rk in ranks]
        check(got == want and got_d == digests,
              f"{name} library K = 2: {got}, want {want}; digests {got_d} "
              f"vs single device {digests}")
        nums = ranks[0][name][2]
        rank_launches = [rk[name][2]["launches"] for rk in ranks]
        _check_no_launches(f"{name} library K = 2", rank_launches)
        library[name] = {
            "result": list(got), "digests_equal_single": True,
            "ms_per_round": nums["steady_s"] * 1e3 / want[0],
            "collective_ms_per_round": {
                k: c["ms"] / want[0] for k, c in nums["collective_ms"].items()},
            "rank_peak_mem_bytes": nums["rank_peak_mem_bytes"],
            "rank_launches": rank_launches,
            "single_device_ms_per_round": single_ms}
    twin_after = _launch_counts()
    twin_launches = {k: twin_after[k] - twin_before[k] for k in twin_after}
    check(sum(twin_launches.values()) == 0,
          f"the single-device twins launched {twin_launches}")
    wall_s["single_device"] = time.perf_counter() - t0
    dense = {}
    for name in ("TS3", "HL1"):
        got, _, nums = ranks[0][f"{name}_dense"]
        rank_launches = [rk[f"{name}_dense"][2]["launches"] for rk in ranks]
        _check_no_launches(f"{name} dense K = 2", rank_launches)
        rounds = got[0]
        if name == "HL1":
            # the halo's trajectory is the dense one; the dense report
            # carries the quotient, the halo's the mean's product
            check((got[0], got[2]) == (MESH_HL1[0], MESH_HL1[2]),
                  f"HL1 dense at K = 2: {got}")
        dense[name] = {
            "result": list(got),
            "ms_per_round": nums["steady_s"] * 1e3 / rounds,
            "collective_ms_per_round": {
                k: c["ms"] / rounds for k, c in nums["collective_ms"].items()},
            "rank_peak_mem_bytes": nums["rank_peak_mem_bytes"],
            "rank_launches": rank_launches}
    dense["SP5"] = {"ms_per_round": cfg5_dense_ms,
                    "from": "mesh_path cfg5 (the same deployment, dense)"}
    emit("mesh_exchanges", cli_k2=cli_runs, library_k2=library,
         dense_k2=dense, twin_launches=twin_launches, phase_wall_s=wall_s,
         phase_s=time.perf_counter() - t_phase, card=smi)


def _planes_configs(name: str):
    """``(proto, topology config, run, fault)`` of a planes case, as its
    command line in ``FP_CASES`` builds them."""
    from gossip_tpu_torch import cli
    return cli.run_configs(cli.build_parser().parse_args(
        ["run", *FP_CASES[name]]))


def _plane_digests(planes) -> list:
    """SHA-256 of each plane of a stack ``[W, R, 128]``."""
    import hashlib

    import torch
    return [hashlib.sha256(p.contiguous().cpu().view(torch.uint8)
                           .numpy().data).hexdigest() for p in planes]


def _planes_rank(curve_rounds: int, group):
    """One rank of the library-API planes runs: each case of ``FP_CASES``
    to the target (its result, this rank's plane digests and numbers),
    FP256's curve of ``curve_rounds`` rounds, the replays of
    ``FP_REPLAY`` (:func:`_planes_replay`), and the PRNG invariant: it
    must hold on the Philox stream and raise when each rank takes its own
    seed."""
    import dataclasses

    from gossip_tpu_torch.parallel import sharded_fused as SF
    out = {}
    for name in FP_CASES:
        proto, tc, run, fault = _planes_configs(name)
        timing = {}
        res, nums = _timed_group(group, SF.simulate_until_sharded_fused,
                                 tc.n, proto.rumors, run, fanout=1,
                                 fault=fault, timing=timing)
        nums["loop_s"] = timing["steady_s"]
        nums["init_build_s"] = timing["init_build_s"]
        out[name] = (res[:3], _plane_digests(res[3]), nums)
        del res
    proto, tc, run, fault = _planes_configs("FP256")
    timing = {}
    res, nums = _timed_group(group, SF.simulate_curve_sharded_fused, tc.n,
                             proto.rumors, dataclasses.replace(
                                 run, max_rounds=curve_rounds),
                             fanout=1, fault=fault, timing=timing)
    nums["loop_s"] = timing["steady_s"]
    out["FP256_curve"] = (res[0], _plane_digests(res[1]), nums)
    del res
    for name, rounds in FP_REPLAY.items():
        out[f"{name}_replay_equal"] = _planes_replay(name, rounds, group)
    out["invariant"] = SF.assert_prng_invariant(N, group).tolist()
    try:
        SF.assert_prng_invariant(N, group, seed=group.rank)
        out["diverged"] = None
    except AssertionError as e:
        out["diverged"] = str(e).splitlines()[0]
    return out


def _planes_replay(name: str, rounds: int, group, fanout: int = 1,
                   configs=None) -> bool:
    """A planes case's first ``rounds`` rounds on this rank, on the card
    (``configs``: its ``(proto, topology config, run, fault)`` in place
    of ``FP_CASES[name]``'s), at ``fanout``:
    the curve loop (its final planes and its curve) and the loops' own
    round (``_round`` on ``_Operands.round_args``, each rumor's count of
    the coverage's nodes from the kernel's counters by
    ``_Operands.counts``), round by round, against the plain lane-major
    round on the same operands and a popcount of its planes at the
    coverage's nodes, the curve against that count's minimum over the
    ranks in plain float32.  True when all of it is equal."""
    import dataclasses

    import numpy as np
    import torch
    from gossip_tpu_torch.ops import fused_mr_round as MR
    from gossip_tpu_torch.parallel import sharded_fused as SF
    proto, tc, run, fault = configs or _planes_configs(name)
    n, dev = tc.n, group.device
    covs, final = SF.simulate_curve_sharded_fused(
        n, proto.rumors, dataclasses.replace(run, max_rounds=rounds), group,
        fanout, fault)
    ops = SF._Operands(n, fault, run.origin, dev)
    metric = ops.metric
    total = (None if metric is None
             else int((metric.reshape(-1) != 0).sum()))
    planes = SF.init_plane_state(n, proto.rumors, group, run.origin)
    ops.start(planes)
    lanes = planes.transpose(1, 2).contiguous()
    plain, spare = lanes.clone(), torch.empty_like(lanes)
    del planes
    same = True
    for r in range(rounds):
        args = ops.round_args(r)
        pop = torch.zeros(lanes.shape[0], 32, dtype=torch.int32, device=dev)
        lanes, spare = SF._round(lanes, spare, pop, run.seed, r, n, fanout,
                                 args)
        plain = torch.stack([MR.fused_mr_round_lanes_plain(
            p, run.seed, r, n, fanout, None, args["drop_threshold"],
            args["alive_lanes"], args.get("cut_lanes")) for p in plain])
        want = torch.stack([MR.rumor_counts(
            p.t() if metric is None else p.t() & metric, 32)
            for p in plain])
        least = int(group.all_reduce_min(want.min().reshape(1))[0])
        cov = (np.float32(least) * (np.float32(1) / np.float32(n))
               if total is None else np.float32(least) / np.float32(total))
        same = (same and torch.equal(lanes, plain)
                and torch.equal(ops.counts(pop, lanes), want)
                and covs[r] == float(cov))
    return same and torch.equal(plain.transpose(1, 2).contiguous(), final)


def _single_plane_digests(dev, name: str, rounds: int, w: int):
    """``(digests, rounds to the target)`` of the single-device
    multi-rumor loop on each plane p < w from origin 32p, ``rounds``
    rounds on the card: FP256 from a fresh state
    (``curve_fused_multirumor``), FPD from the plane's start words under
    the planes' alive words and threshold (the run's origin pins the
    alive set)."""
    from gossip_tpu_torch.ops import fused_mr_round as MR
    _, tc, run, fault = _planes_configs(name)
    digests, hits = [], []
    for p in range(w):
        if fault is None:
            final, covs = MR.curve_fused_multirumor(
                tc.n, 32, run.seed, max_rounds=rounds, origin=32 * p,
                device=dev)
            hits.append(next((i + 1 for i, c in enumerate(covs)
                              if c >= run.target_coverage), -1))
        else:
            final, _ = MR.until_fused_multirumor(
                tc.n, 32, run.seed, target_coverage=2.0, max_rounds=rounds,
                origin=run.origin, fault=fault, device=dev,
                state=MR.init_multirumor_state(tc.n, 32, 32 * p, dev))
        digests.append(_plane_digests(final.table[None])[0])
        del final
    return digests, hits


def phase_mesh_fused_planes(dev, smi: str):
    """The fused rumor planes at N = 10M x 256 rumors (8 planes):
    (a) ``python -m gossip_tpu_torch run --engine fused --devices 2
    --share-card`` for FP256, FPD and FPCH, each rank launching
    ``fused_mr_round`` exactly 4 x its rounds and no other kernel
    (``meta.rank_launches``); (b) the same through the library API in one
    spawn, FP256's curve beside them, each rank's plane digests, the
    replays of ``FP_REPLAY`` against the plain lane-major round, the PRNG
    invariant holding and failing on a rank keyed by another seed; (c)
    K = 1 under NCCL (8 planes on one rank), counts set to 0 just before
    and read just after, whose digests every K = 2 rank's must equal and
    whose coverage the final planes' least count gives in float32;
    (d) FP256's and FPD's planes against the single-device loop on each
    plane (FP256's rounds the planes' largest rounds to the target); (e)
    what the planes refuse.  Each run's ms a round, collectives by name,
    launches and peaks, beside the single-device loop's ms a round."""
    import numpy as np
    import torch
    from gossip_tpu_torch import cli
    from gossip_tpu_torch.backend import run_simulation
    from gossip_tpu_torch.config import MeshConfig
    from gossip_tpu_torch.ops import _kernels
    from gossip_tpu_torch.ops import fused_mr_round as MR
    from gossip_tpu_torch.parallel import group as GR
    from gossip_tpu_torch.parallel import sharded_fused as SF

    t_phase, wall_s = time.perf_counter(), {}
    torch.cuda.empty_cache()
    w = SF.plane_count(FP_RUMORS, 1)
    share = ["--devices", "2", "--share-card"]

    def rank_ok(what, rank_launches, rounds_run, w_local):
        check(rank_launches is not None and all(
            r == {**{k: 0 for k in r}, "fused_mr_round": w_local * rounds_run}
            for r in rank_launches),
            f"{what}: the ranks launched {rank_launches}, want "
            f"{w_local} x {rounds_run} fused_mr_round")

    # (c) K = 1 under NCCL: the oracle of every K = 2 rank's planes
    k1 = {}
    with GR.local(dev) as g:
        for name in FP_CASES:
            proto, tc, run, fault = _planes_configs(name)
            for k in _kernels.KERNELS:
                k.launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            g.collective_ms(reset=True)
            timing = {}
            t0 = time.perf_counter()
            rounds_run, cov, msgs, final = SF.simulate_until_sharded_fused(
                tc.n, proto.rumors, run, g, 1, fault, timing)
            wall_s[f"k1_{name}"] = time.perf_counter() - t0
            launches = {k.name: k.launches for k in _kernels.KERNELS}
            rank_ok(f"{name} at K = 1", [launches], rounds_run, w)
            # which rumors hold the minimum (over the coverage's nodes),
            # and the coverage from it in plain float32
            metric = SF._Operands(tc.n, fault, run.origin, dev).metric
            counts = torch.stack([MR.rumor_counts(
                p if metric is None else p & metric, 32)
                for p in final]).reshape(-1)
            least = torch.nonzero(counts == counts.min()).reshape(-1)
            c = np.float32(int(counts.min()))
            want = (c * (np.float32(1) / np.float32(tc.n)) if metric is None
                    else c / np.float32(int((metric.reshape(-1) != 0).sum())))
            check(cov == float(want),
                  f"{name} at K = 1: coverage {cov}, the final planes' "
                  f"least count {int(c)} gives {float(want)}")
            del metric
            k1[name] = {
                "result": [rounds_run, cov, msgs],
                "digests": _plane_digests(final),
                "ms_per_round": timing["steady_s"] * 1e3 / rounds_run,
                "init_build_s": timing["init_build_s"],
                "collective_ms_per_round": {
                    k: c["ms"] / rounds_run
                    for k, c in g.collective_ms().items()},
                "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                "launches": launches,
                "least_count": int(counts.min()),
                "least_rumors": least[:16].tolist(),
                "least_rumors_n": int(least.numel())}
            del final, counts
    fp256_launches = k1["FP256"]["launches"]["fused_mr_round"]

    # (d) the single-device loop on each plane, on the card
    t0 = time.perf_counter()
    single = {}
    for name in ("FP256", "FPD"):
        rounds_run = k1[name]["result"][0]
        digests, hits = _single_plane_digests(dev, name, rounds_run, w)
        check(digests == k1[name]["digests"],
              f"{name} at K = 1: the planes differ from the single-device "
              "loop on each plane")
        single[name] = {"digests_equal": True, "rounds_to_target": hits}
    check(k1["FP256"]["result"][0] == max(single["FP256"]["rounds_to_target"]),
          f"FP256 ran {k1['FP256']['result'][0]} rounds; the planes' "
          f"rounds to the target are {single['FP256']['rounds_to_target']}")
    # plane 0's loop alone: configuration 5's one-device run
    single_ms = _loop_ms(dev, MR.until_fused_multirumor, N, 32, SEED,
                         device=dev) / single["FP256"]["rounds_to_target"][0]
    wall_s["single_device"] = time.perf_counter() - t0

    # (a) the command lines at K = 2
    cli_runs = {}
    # every command line in one process (one start-up for the three)
    t0 = time.perf_counter()
    outs = _port_lines(*(["run", *args, *share]
                         for args in FP_CASES.values()))
    wall_s["cli"] = time.perf_counter() - t0
    for (name, args), lines_out in zip(FP_CASES.items(), outs):
        out = lines_out[-1]
        meta = out["meta"]
        got = (out["rounds"], out["coverage"], out["msgs"])
        want = tuple(k1[name]["result"])
        hit = want[1] >= np.float32(0.99)
        check(got == ((want[0] if hit else -1), want[1], want[2])
              and meta["devices"] == 2 and meta["process_group"] == "gloo"
              and meta["engine"] == "fused-cuda-planes"
              and meta["ici_bytes_per_round"] == 0.0
              and meta["layout"] == f"{w} rumor planes x one 32-rumor word "
              "per node",
              f"{name} at K = 2: {got}, K = 1 gave {want}; {meta}")
        rank_ok(f"{name} at K = 2", meta["rank_launches"], want[0], w // 2)
        cli_runs[name] = {"command": [*args, *share], "result": list(got),
                          **_mesh_run_numbers(meta, want[0])}

    # (b) the library API at K = 2, one spawn
    t0 = time.perf_counter()
    ranks = GR.launch(_planes_rank, 2, k1["FP256"]["result"][0], device=dev,
                      shared_card=True)
    wall_s["library_spawn"] = time.perf_counter() - t0
    library = {}
    for name in FP_CASES:
        got = tuple(ranks[0][name][0])
        rounds_run = k1[name]["result"][0]
        digests = [d for rk in ranks for d in rk[name][1]]
        check(got == tuple(k1[name]["result"])
              and digests == k1[name]["digests"],
              f"{name} library K = 2: {got} and its plane digests against "
              f"K = 1's {k1[name]['result']}")
        rank_launches = [rk[name][2]["launches"] for rk in ranks]
        rank_ok(f"{name} library K = 2", rank_launches, rounds_run, w // 2)
        nums = ranks[0][name][2]
        library[name] = {
            "result": list(got), "digests_equal_k1": True,
            "ms_per_round": nums["loop_s"] * 1e3 / rounds_run,
            "init_build_s": nums["init_build_s"],
            "collective_ms_per_round": {
                k: c["ms"] / rounds_run
                for k, c in nums["collective_ms"].items()},
            "rank_peak_mem_bytes": nums["rank_peak_mem_bytes"],
            "rank_launches": rank_launches}
    covs, _, nums = ranks[0]["FP256_curve"]
    curve_rounds = k1["FP256"]["result"][0]
    check(covs[-1] == k1["FP256"]["result"][1]
          and [d for rk in ranks for d in rk["FP256_curve"][1]]
          == k1["FP256"]["digests"],
          f"FP256 curve at K = 2: last {covs[-1]}, digests differ from K = 1")
    rank_ok("FP256 curve K = 2",
            [rk["FP256_curve"][2]["launches"] for rk in ranks],
            curve_rounds, w // 2)
    library["FP256_curve"] = {
        "rounds": curve_rounds, "last": covs[-1],
        "ms_per_round": nums["loop_s"] * 1e3 / curve_rounds,
        "collective_ms_per_round": {
            k: c["ms"] / curve_rounds
            for k, c in nums["collective_ms"].items()}}
    for name, rounds in FP_REPLAY.items():
        check(all(rk[f"{name}_replay_equal"] for rk in ranks),
              f"{name}'s first {rounds} rounds differ from the plain "
              "round's replay")
    inv = ranks[0]["invariant"]
    check(len(inv) == 2 and inv[0] == inv[1] and inv[0][0] > 0
          and all(rk["diverged"] is not None
                  and "VIOLATED" in rk["diverged"] for rk in ranks),
          f"the PRNG invariant: {inv}; diverged ranks: "
          f"{[rk['diverged'] for rk in ranks]}")

    # (e) refusals, before any rank starts
    refused = {}
    for what, (extra, phrase) in FP_REFUSED.items():
        a = cli.build_parser().parse_args(["run", *_FP, *extra])
        mesh = MeshConfig(n_devices=2, exchange=a.exchange, shared_card=True)
        try:
            run_simulation(*cli.run_configs(a), device=dev, mesh_cfg=mesh)
            refused[what] = None
        except ValueError as e:
            refused[what] = str(e)
        check(refused[what] is not None and phrase in refused[what],
              f"the planes ran {what}: {refused[what]}")
    emit("mesh_fused_planes", k1_nccl=k1, cli_k2=cli_runs,
         library_k2=library, single_device=single,
         single_device_ms_per_round=single_ms,
         invariant=inv, diverged=ranks[1]["diverged"], refused=refused,
         launches=fp256_launches, phase_wall_s=wall_s,
         phase_s=time.perf_counter() - t_phase, card=smi)
    return fp256_launches


# The sweep axis (phase ``sweeps``): the README's sweep commands at their
# widths (README.md:358-362, :368, :377, :383, :404-412, :431), the
# README's 8 devices cut to the card's ranks (K = 1 under NCCL, K = 2
# sharing it under gloo).  The round counts are the commands' own.
N_EN = 10_000             # EN32: run --mode pushpull --n 10000 --ensemble 32
N_SW = 100_000            # ES32, ER32: swim and rumor ensembles of 32
N_GRID = 4_096            # GR12 and GRP: grid's default n
N_GRF = 100_000           # GRF: the families grid
N_CS = 65_536             # CS8: the JAX bench's churn_sweep family
EN10M_SEEDS, EN10M_ROUNDS = 8, 32
GRID10M_ROUNDS = 40
CS10M_ROUNDS = 48
CF_RUMORS = 256
EN32_ARGS = ["--mode", "pushpull", "--n", str(N_EN), "--ensemble", "32"]
ES32_ARGS = ["--mode", "swim", "--n", str(N_SW), "--ensemble", "32"]
ER32_ARGS = ["--mode", "rumor", "--n", str(N_SW), "--rumor-k", "2",
             "--ensemble", "32"]
GR12_ARGS = ["--modes", "push", "pull", "pushpull", "--fanouts", "1", "2",
             "--drops", "0", "0.1"]
GRF_ARGS = ["--modes", "pull", "pushpull", "--fanouts", "1", "2",
            "--families", "erdos_renyi", "watts_strogatz", "power_law",
            "--n", str(N_GRF)]
GRP_ARGS = ["--modes", "push", "pull", "pushpull", "antientropy",
            "--fanouts", "1", "2"]
# CS10M: the churn_heal program (JAX bench.py run_churn_heal) and three
# one-fault programs at 10M
CS10M_SCENARIOS = (
    "event=1:1:4;event=2:2;partition=0:6:5000000;ramp=0:4:0:0.1",
    "event=3:1:4", "partition=0:3:5000000", "ramp=0:4:0.0:0.2")
CS10M_ARGS = ["--mode", "pull", "--fanout", "1", "--n", str(N), "--drop",
              "0.02", "--max-rounds", str(CS10M_ROUNDS)]
# CF256: README.md:412's four programs, their cuts scaled from n = 1024
# to 10M; churn-sweep's defaults (fanout 2, 64 rounds)
CF_SCENARIOS = ("event=3:1:4", "partition=0:3:5000000", "ramp=0:4:0.0:0.2",
                "event=9:1:-1;partition=1:4:2500000")
CF_ARGS = ["--engine", "fused", "--mode", "pull", "--n", str(N),
           "--rumors", str(CF_RUMORS)]
CF_REPLAY_ROUNDS = 8      # the fanout-2 replay: every change of churn_heal


def _scenario_args(scens) -> list:
    return [x for s in scens for x in ("--scenario", s)]


def _parsed(cmd: str, args):
    from gossip_tpu_torch import cli
    return cli.build_parser().parse_args([cmd, *args])


def _spec(fault) -> str:
    """A fault program as a ``--scenario`` spec."""
    ch = fault.churn
    items = [f"event={e[0]}:{e[1]}:{e[2]}" for e in ch.events]
    items += [f"partition={w[0]}:{w[1]}:{w[2]}" for w in ch.partitions]
    if ch.ramp is not None:
        items.append("ramp=" + ":".join(str(x) for x in ch.ramp))
    return ";".join(items)


def _cs8_faults(salt: int):
    from gossip_tpu_torch.ops import nemesis as NE
    return NE.mixed_scenarios(8, N_CS, salt=salt, drop_prob=0.01, seed=0,
                              ramp_to=0.09)


def _timed_run(dev, fn, *args, **kwargs):
    """``(result, numbers)`` of one library run on this device: its
    steady seconds, the peak allocated memory and the kernel launches."""
    import torch
    from gossip_tpu_torch.utils.timing import steady_timed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = _launch_counts()
    out, steady = steady_timed(dev, fn, *args, **kwargs)
    after = _launch_counts()
    return out, {"steady_s": steady,
                 "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                 "launches": {k: after[k] - before[k] for k in after}}


def _draw_ms(dev, s: int, n: int, k: int, coin: bool, peers=None) -> float:
    """One batched partner draw (and its drop coin) of S points at n,
    as a round pays it."""
    import torch
    from gossip_tpu_torch.ops import threefry
    from gossip_tpu_torch.ops.sampling import drop_mask, sample_peers_complete
    keys = torch.stack([threefry.key(i, dev) for i in range(s)])[:, None]
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    p = torch.full((s, 1, 1), 0.1, dtype=torch.float32, device=dev)

    def draw():
        t = (peers(keys) if peers is not None
             else sample_peers_complete(keys, ids, n, k, True))
        if coin:
            t = torch.where(drop_mask(keys, 3, ids, k, p), n, t)
        return t
    ms = _median_ms(dev, draw)
    torch.cuda.empty_cache()
    return ms


def _solo_si(dev, proto, topo, run, fault=None):
    """``(curve result, ms a round)`` of a point's solo run on the card."""
    from gossip_tpu_torch.runtime.simulator import simulate_curve
    from gossip_tpu_torch.utils.timing import steady_timed
    res, s = steady_timed(dev, simulate_curve, proto, topo, run, fault, dev)
    return res, s * 1e3 / run.max_rounds


def _held_si(what, curves, msgs, rtt, solo) -> None:
    import numpy as np
    check(np.array_equal(curves, solo.coverage)
          and np.array_equal(msgs, solo.msgs)
          and int(rtt) == solo.rounds_to_target,
          f"{what}: the batch point differs from its solo run "
          f"(rounds {rtt} / {solo.rounds_to_target}, last coverage "
          f"{curves[-1]} / {solo.coverage[-1]}, msgs {msgs[-1]} / "
          f"{solo.msgs[-1]})")


def _solo_trace(dev, proto, topo, run, fault):
    """A churn scenario's solo step, round by round: ``(exact counts,
    msgs, lost, ms a round)`` of ``make_si_round`` under its program (the
    solo run's trajectory, read with the churn sweep's count)."""
    import numpy as np
    from gossip_tpu_torch.models.si import coverage_count, make_si_round
    from gossip_tpu_torch.models.state import init_state
    from gossip_tpu_torch.ops import nemesis as NE
    from gossip_tpu_torch.utils.timing import steady_timed
    step = make_si_round(proto, topo, fault, run.origin, dev)
    alive = NE.metric_alive(fault, topo.n, run.origin, dev)

    def loop():
        state = init_state(run, proto, topo.n, dev)
        cnt, msgs, lost = [], [], []
        for _ in range(run.max_rounds):
            state, lo = step(state)
            cnt.append(coverage_count(state.seen, alive)[0])
            msgs.append(state.msgs)
            lost.append(lo)
        return (np.asarray(cnt), np.asarray([m.item() for m in msgs],
                                             np.float32),
                np.asarray([x.item() for x in lost], np.float32))
    out, s = steady_timed(dev, loop)
    return (*out, s * 1e3 / run.max_rounds)


def _sweep_line(name: str, nums: dict, rounds: int, points: int,
                rtt, solo_ms, draw=None, **fields) -> dict:
    """The phase's line of one run: rounds-to-target per point, the
    batch's ms a round beside S x the solo run's, the draw's share."""
    import numpy as np
    batch_ms = nums["steady_s"] * 1e3 / rounds
    line = {"run": name, "points": points, "rounds": rounds,
            "rounds_to_target": np.asarray(rtt).tolist(),
            "converged": int((np.asarray(rtt) >= 0).sum()),
            "batch_ms_per_round": batch_ms, "solo_ms_per_round": solo_ms,
            "s_x_solo_ms_per_round": (points * solo_ms
                                      if solo_ms is not None else None),
            "draw_ms_per_round": draw,
            "draw_share": draw / batch_ms if draw is not None else None,
            "peak_mem_bytes": nums.get("peak_mem_bytes"),
            "rank_peak_mem_bytes": nums.get("rank_peak_mem_bytes"),
            "collective_ms": nums.get("collective_ms"),
            "launches": nums.get("launches"), **fields}
    return line


def _sweeps_rank(group):
    """One rank of the K = 2 library runs, one spawn: ES32's ensemble
    (the seed axis), GRP on the 2 x 1 and 1 x 2 hybrid meshes, CF256's
    fused sweep (the plane axis) and each of its scenarios solo, with
    each run's numbers."""
    from gossip_tpu_torch import cli
    from gossip_tpu_torch.backend import run_ensemble
    from gossip_tpu_torch.parallel import multislice as MSL
    from gossip_tpu_torch.parallel import sharded_fused as SF
    from gossip_tpu_torch.parallel import sweep as SWP
    from gossip_tpu_torch.topology import generators as G
    out = {}
    a = _parsed("run", ES32_ARGS)
    proto, tc, run, fault = cli.run_configs(a)
    (ens, _), nums = _timed_group(group, run_ensemble, proto, tc, run, fault,
                                  count=32)
    out["ES32"] = (ens.curves, ens.msgs, nums)
    a = _parsed("grid", GRP_ARGS)
    points, _ = cli.grid_points(a)
    run = cli.RunConfig(max_rounds=a.max_rounds, seed=a.seed)
    for shape in ((2, 1), (1, 2)):
        mesh = MSL.make_hybrid_mesh(*shape, device=group.device)
        res, nums = _timed_group(
            mesh.inner, lambda group: SWP.config_sweep_curves_2d(
                points, G.complete(N_GRID), run, mesh))
        out[f"GRP{shape[0]}x{shape[1]}"] = (res.curves, res.msgs, nums)
    a = _parsed("churn-sweep", [*CF_ARGS, *_scenario_args(CF_SCENARIOS)])
    proto, tc, run, faults = cli.churn_sweep_configs(a)
    res, nums = _timed_group(group, SWP.fused_churn_sweep_curves, tc.n,
                             proto.rumors, run, faults,
                             fanout=proto.fanout)
    out["CF256"] = (res.curves, nums)
    solo = []
    for f in faults:
        covs, final = SF.simulate_curve_sharded_fused(
            tc.n, proto.rumors, run, group, proto.fanout, f)
        solo.append((covs, _plane_digests(final)))
        del final
    out["CF256_solo"] = solo
    return out


def phase_sweeps(dev, smi: str):
    """The sweep axis (``gossip_tpu_torch.parallel.sweep``) at the
    README's commands: EN32, EN10M, ES32, ER32 (seed ensembles), GR12 at
    n = 4096 and 10M, GRF, GRP (config grids), CS8, CS10M (XLA churn
    sweeps), CF256 (the fused churn sweep).  Every point of GR12's at
    4096 and CS8's batch against its solo run on the card, bitwise
    (curve, msgs, rounds to the target; the churn sweeps' exact counts
    and dropped counts against the solo step's); the first and last
    points of the others; the K = 2
    runs against K = 1; CF256's scenarios against the fused curve
    driver solo, every rank launching ``fused_mr_round`` W_local x
    its rounds and nothing else; kernel 2 at fanout 2 under the alive,
    cut and threshold operands replayed against its plain round at 10M.
    One line a run: rounds to the target per point, the batch's ms a
    round beside S x the solo run's, the threefry draw's share, peaks,
    collectives and launches.  Returns CF256's fused_mr_round launches
    at K = 1."""
    import dataclasses

    import numpy as np
    import torch
    from gossip_tpu_torch import bench
    from gossip_tpu_torch import cli
    from gossip_tpu_torch.backend import run_ensemble
    from gossip_tpu_torch.config import ProtocolConfig, RunConfig
    from gossip_tpu_torch.models.rumor import simulate_curve_rumor
    from gossip_tpu_torch.ops import _kernels
    from gossip_tpu_torch.ops import fused_mr_round as MR
    from gossip_tpu_torch.parallel import group as GR
    from gossip_tpu_torch.parallel import sharded_fused as SF
    from gossip_tpu_torch.parallel import sweep as SWP
    from gossip_tpu_torch.runtime.simulator import simulate_swim_curve
    from gossip_tpu_torch.tools.roofline import mr_round_bound
    from gossip_tpu_torch.topology import generators as G
    from gossip_tpu_torch.utils.timing import steady_timed

    t_phase, wall_s = time.perf_counter(), {}
    torch.cuda.empty_cache()
    lines = {}

    def put(name, line):
        """Keep a run's line and print it at once."""
        lines[name] = line
        emit("sweeps", **line, phase_s=time.perf_counter() - t_phase,
             card=smi)

    def no_kernels(what, nums):
        check(sum(nums["launches"].values()) == 0,
              f"{what} launched {nums['launches']}")

    # EN32 and EN10M: SI seed ensembles, every point / first and last
    t0 = time.perf_counter()
    for name, args in (("EN32", EN32_ARGS),
                       ("EN10M", ["--mode", "pull", "--n", str(N),
                                  "--ensemble", str(EN10M_SEEDS),
                                  "--max-rounds", str(EN10M_ROUNDS)])):
        a = _parsed("run", args)
        proto, tc, run, fault = cli.run_configs(a)
        (ens, _), nums = _timed_run(dev, run_ensemble, proto, tc, run, fault,
                                    count=a.ensemble, device=dev)
        no_kernels(name, nums)
        topo = G.build(tc, dev)
        # the first and last seeds (every seed on the CPU tests)
        held = (0, a.ensemble - 1)
        solo_ms = []
        for i in held:
            solo, ms = _solo_si(dev, proto, topo, dataclasses.replace(
                run, seed=run.seed + i), fault)
            _held_si(f"{name} seed {i}", ens.curves[i], ens.msgs[i],
                     ens.rounds_to_target[i], solo)
            solo_ms.append(ms)
        draws = 2 if proto.mode == "pushpull" else 1
        put(name, _sweep_line(
            name, nums, run.max_rounds, a.ensemble, ens.rounds_to_target,
            statistics.median(solo_ms),
            draws * _draw_ms(dev, a.ensemble, tc.n, proto.fanout, False),
            held=list(held), batch_chunks=ens.meta["batch_chunks"],
            summary=ens.summary()))
        del ens, topo
        wall_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # ES32 and ER32: SWIM and rumor ensembles (loops over the seeds)
    t0 = time.perf_counter()
    k1 = {}
    for name, args in (("ES32", ES32_ARGS), ("ER32", ER32_ARGS)):
        a = _parsed("run", args)
        proto, tc, run, fault = cli.run_configs(a)
        (ens, extra), nums = _timed_run(dev, run_ensemble, proto, tc, run,
                                        fault, count=32, device=dev)
        no_kernels(name, nums)
        k1[name] = ens
        solo_ms = []
        for i in (0, 31):
            if name == "ES32":
                (fr, final), s = steady_timed(
                    dev, simulate_swim_curve, proto, tc.n, run.max_rounds,
                    dead_nodes=extra["dead_subjects"],
                    fail_round=extra["fail_round"], fault=fault,
                    seed=run.seed + i, device=dev)
                ok = (np.array_equal(ens.curves[i], fr)
                      and ens.msgs[i, -1] == np.float32(final.msgs.item()))
                rtt = ens.rounds_to_target
            else:
                (covs, hots, msgs, _), s = steady_timed(
                    dev, simulate_curve_rumor, proto, G.build(tc, dev),
                    dataclasses.replace(run, seed=run.seed + i), fault, dev)
                ok = (np.array_equal(ens.curves[i], covs)
                      and np.array_equal(ens.hot[i], hots)
                      and np.array_equal(ens.msgs[i], msgs))
                rtt = ens.extinction_rounds
            check(ok, f"{name} seed {i}: the batch point differs from its "
                      "solo run")
            solo_ms.append(s * 1e3 / run.max_rounds)
        put(name, _sweep_line(
            name, nums, run.max_rounds, 32, rtt, statistics.median(solo_ms),
            held=[0, 31], summary=ens.summary()))
        wall_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # GR12 at n = 4096 (every point) and at 10M (first and last), GRF
    for name, args, every in (
            ("GR12", GR12_ARGS, True),
            ("GR12_10M", [*GR12_ARGS, "--n", str(N), "--max-rounds",
                          str(GRID10M_ROUNDS)], False),
            ("GRF", GRF_ARGS, False)):
        a = _parsed("grid", args)
        points, fam_n = cli.grid_points(a)
        run = RunConfig(target_coverage=a.target, max_rounds=a.max_rounds,
                        seed=a.seed)
        tb = time.perf_counter()
        topos = [G.build(cli.TopologyConfig(family=f, n=n, k=a.k, p=a.p,
                                            degree_cap=a.degree_cap,
                                            seed=a.seed), dev)
                 for f, n in fam_n]
        topo_build_s = time.perf_counter() - tb
        topo = topos if len(topos) > 1 else topos[0]
        res, nums = _timed_run(dev, SWP.config_sweep_curves_partitioned,
                               points, topo, run, device=dev)
        no_kernels(name, nums)
        held = range(len(points)) if every else (0, len(points) - 1)
        solo_ms = []
        for i in held:
            pt = points[i]
            fault = (cli.FaultConfig(drop_prob=pt.drop_prob)
                     if pt.drop_prob else None)
            solo, ms = _solo_si(dev, ProtocolConfig(
                mode=pt.mode, fanout=pt.fanout, period=pt.period),
                topos[pt.topo_idx], dataclasses.replace(run, seed=pt.seed),
                fault)
            _held_si(f"{name} point {i} {pt}", res.curves[i], res.msgs[i],
                     res.rounds_to_target[i], solo)
            solo_ms.append(ms)
        if len(topos) > 1:
            nbrs, deg = SWP._stack_topologies(topos, dev)
            tidx = torch.tensor([p.topo_idx for p in points], device=dev)
            ids = torch.arange(nbrs.shape[1], dtype=torch.int64, device=dev)
            # per bucket: 6 pull points, 6 push-pull points (two draws)
            tidx = tidx[:6]
            draw = 3 * _draw_ms(dev, 6, nbrs.shape[1], 2, False,
                                peers=lambda k: SWP._stack_peers(
                                    k, ids, nbrs, deg[tidx], tidx, 2,
                                    nbrs.shape[1]))
            del nbrs, deg
        else:
            # per bucket, as the partitioned batch draws: 4 push, 4 pull
            # and 4 push-pull points, k_max 2, coins drawn (drops 0.1)
            draw = 4 * _draw_ms(dev, 4, topos[0].n, 2, True)
        put(name, _sweep_line(
            name, nums, run.max_rounds, len(points), res.rounds_to_target,
            statistics.median(solo_ms), draw, held=list(held),
            topo_build_s=topo_build_s,
            batch_chunks=res.meta["batch_chunks"],
            mode_buckets=res.meta.get("mode_buckets", 1)))
        if name == "GR12":
            gr12 = res
        del res, topos, topo
        wall_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # CS8 (every scenario) and CS10M (first and last): XLA churn sweeps
    t0 = time.perf_counter()
    proto = ProtocolConfig(mode="pull", fanout=1)
    for name, n, faults, rounds, every in (
            ("CS8", N_CS, _cs8_faults(0), 32, True),
            ("CS10M", N, cli.churn_sweep_configs(_parsed(
                "churn-sweep", [*CS10M_ARGS,
                                *_scenario_args(CS10M_SCENARIOS)]))[3],
             CS10M_ROUNDS, False)):
        run = RunConfig(max_rounds=rounds, seed=0)
        topo = G.complete(n)
        res, nums = _timed_run(dev, SWP.churn_sweep_curves, proto, topo,
                               run, faults, device=dev)
        no_kernels(name, nums)
        held = range(len(faults)) if every else (0, len(faults) - 1)
        solo_ms = []
        for i in held:
            cnt, msgs, lost, ms = _solo_trace(dev, proto, topo, run,
                                              faults[i])
            check(np.array_equal(res.counts[i], cnt)
                  and np.array_equal(res.msgs[i], msgs)
                  and np.array_equal(res.dropped[i], lost),
                  f"{name} scenario {i}: counts, msgs or dropped differ "
                  "from the solo step's")
            solo_ms.append(ms)
        put(name, _sweep_line(
            name, nums, rounds, len(faults), res.rounds_to_target,
            statistics.median(solo_ms),
            _draw_ms(dev, len(faults), n, 1, True), held=list(held),
            batch_chunks=res.meta["batch_chunks"],
            dropped_total=res.dropped.sum(axis=1).tolist()))
        if name == "CS8":
            cs8 = res
        del res
        wall_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    # the bench family's two salts
    fam = bench.run_churn_sweep(N_CS, device=dev)
    check(np.array_equal(fam["first"].curves, cs8.curves),
          "the bench family's salt-0 batch differs from CS8's")
    emit("sweeps_bench", run="CS8", churn_sweep={
        k: v for k, v in fam.items() if k not in ("first", "warm")},
        card=smi)
    wall_s["CS8_cli_bench"] = time.perf_counter() - t0

    # CF256 at K = 1 under NCCL: the fused sweep, each scenario solo,
    # the fanout-2 replay under alive, cut and threshold
    t0 = time.perf_counter()
    a = _parsed("churn-sweep", [*CF_ARGS, *_scenario_args(CF_SCENARIOS)])
    proto, tc, run, faults = cli.churn_sweep_configs(a)
    w = SF.plane_count(CF_RUMORS, 1)
    with GR.local(dev) as g:
        res, nums = _timed_group(g, SWP.fused_churn_sweep_curves, tc.n,
                                 proto.rumors, run, faults,
                                 fanout=proto.fanout)
        want = w * run.max_rounds * len(faults)
        check(nums["launches"] == {**{k: 0 for k in nums["launches"]},
                                   "fused_mr_round": want},
              f"CF256 at K = 1 launched {nums['launches']}, want {want} "
              "fused_mr_round")
        cf_launches = nums["launches"]["fused_mr_round"]
        solo, solo_s = [], 0.0
        for f in faults:
            (covs, final), s = steady_timed(
                dev, SF.simulate_curve_sharded_fused, tc.n, proto.rumors,
                run, g, proto.fanout, f)
            solo.append((covs, _plane_digests(final)))
            solo_s += s
            del final
        check(all(np.array_equal(res.curves[k], solo[k][0])
                  for k in range(len(faults))),
              "CF256 at K = 1: a scenario's curve differs from the fused "
              "curve driver's")
        heal = cli.churn_sweep_configs(_parsed(
            "churn-sweep", [*CF_ARGS, "--scenario", CS10M_SCENARIOS[0],
                            "--drop", "0.02"]))
        check(_planes_replay("CF256_heal", CF_REPLAY_ROUNDS, g,
                             fanout=proto.fanout,
                             configs=(heal[0], heal[1], heal[2],
                                      heal[3][0])),
              "kernel 2 at fanout 2 under churn_heal's alive, cut and "
              "threshold operands differs from its plain round")
        # that instantiation's time on one plane at round 1 (a crash,
        # the cut open, the ramp's threshold), beside its plain round's
        ops = SF._Operands(tc.n, heal[3][0], 0, dev)
        lanes = SF.init_plane_state(tc.n, 32, g, 0).transpose(1, 2)[0]
        lanes = lanes.contiguous()
        args = ops.round_args(1)
        spare = torch.empty_like(lanes)
        pop = torch.zeros(32, dtype=torch.int32, device=dev)
        # and the fanout-1 instantiation under the same operands (FPCH's)
        flags = dict(alive=args.get("alive_lanes") is not None,
                     cut=args.get("cut_lanes") is not None)

        def k2_line(fanout):
            return {"ms": kernel_ms(lambda: MR.fused_mr_round_lanes(
                lanes, SEED, 1, tc.n, fanout, out=spare, pop=pop, **args)),
                "plain_ms": 1e3 * statistics.median(steady_timed(
                    dev, MR.fused_mr_round_lanes_plain, lanes, SEED, 1,
                    tc.n, fanout, None, args["drop_threshold"],
                    args["alive_lanes"], args.get("cut_lanes"))[1]
                    for _ in range(3)),
                "bound": mr_round_bound(tc.n, fanout, **flags),
                **_kernels.fused_mr_occupancy(
                    fanout, flags["alive"], flags["cut"], False,
                    args["drop_threshold"])}
        k2 = {**k2_line(2), "operands": sorted(args), "fanout1": k2_line(1)}
        del ops, lanes, spare
    put("CF256", _sweep_line(
        "CF256", nums, run.max_rounds * len(faults), len(faults),
        res.rounds_to_target, solo_s * 1e3 / (run.max_rounds * len(faults)),
        planes=w, fanout=proto.fanout,
        replay_fanout2_rounds=CF_REPLAY_ROUNDS, kernel2_fanout2=k2,
        note="ms a round: one scenario's round (8 planes); the batch "
             "runs the scenarios one after another"))
    cf_k1 = res
    wall_s["CF256_k1"] = time.perf_counter() - t0

    # the K = 2 runs: the library in one spawn, CF256 through the command
    t0 = time.perf_counter()
    ranks = GR.launch(_sweeps_rank, 2, device=dev, shared_card=True)
    r0 = ranks[0]
    check(np.array_equal(r0["ES32"][0], k1["ES32"].curves)
          and np.array_equal(r0["ES32"][1], k1["ES32"].msgs),
          "ES32 at K = 2 differs from K = 1")
    lines["ES32"]["k2"] = {"steady_s": r0["ES32"][2]["steady_s"],
                           "ms_per_round": r0["ES32"][2]["steady_s"] * 1e3
                           / _parsed("run", ES32_ARGS).max_rounds,
                           "collective_ms": r0["ES32"][2]["collective_ms"],
                           "rank_peak_mem_bytes":
                               r0["ES32"][2]["rank_peak_mem_bytes"],
                           "rank_launches": [rk["ES32"][2]["launches"]
                                             for rk in ranks]}
    _check_no_launches("ES32 at K = 2", lines["ES32"]["k2"]["rank_launches"])
    grp_rounds = _parsed("grid", GRP_ARGS).max_rounds
    a = _parsed("grid", GRP_ARGS)
    points, _ = cli.grid_points(a)
    one = SWP.config_sweep_curves(points, G.complete(N_GRID), RunConfig(
        max_rounds=a.max_rounds, seed=a.seed), device=dev)
    for shape in ("GRP2x1", "GRP1x2"):
        curves, msgs, nums = r0[shape]
        check(np.array_equal(curves, one.curves)
              and np.array_equal(msgs, one.msgs),
              f"{shape}: the pod sweep differs from the 1-D batch at K = 1")
        _check_no_launches(shape, [rk[shape][2]["launches"] for rk in ranks])
        put(shape, _sweep_line(
            shape, nums, grp_rounds, len(points), one.rounds_to_target,
            None, rank_launches=[rk[shape][2]["launches"] for rk in ranks]))
    curves, nums = r0["CF256"]
    check(np.array_equal(curves, cf_k1.curves),
          "CF256 at K = 2 differs from K = 1")
    for rk in ranks:
        got = rk["CF256"][1]["launches"]
        check(got == {**{k: 0 for k in got},
                      "fused_mr_round": (w // 2) * run.max_rounds
                      * len(faults)},
              f"CF256 at K = 2: a rank launched {got}")
    digests = [[d for rk in ranks for d in rk["CF256_solo"][k][1]]
               for k in range(len(faults))]
    check(digests == [s[1] for s in solo]
          and all(np.array_equal(r0["CF256_solo"][k][0], solo[k][0])
                  for k in range(len(faults))),
          "CF256 at K = 2: a scenario's planes differ from K = 1's")
    lines["CF256"]["k2"] = {
        "steady_s": nums["steady_s"],
        "ms_per_round": nums["steady_s"] * 1e3
        / (run.max_rounds * len(faults)),
        "collective_ms": nums["collective_ms"],
        "rank_peak_mem_bytes": nums["rank_peak_mem_bytes"],
        "rank_launches": [rk["CF256"][1]["launches"] for rk in ranks],
        "plane_digests_equal_k1": True}
    wall_s["k2_spawn"] = time.perf_counter() - t0
    # the command lines, one process: GR12 and CS8 against the
    # library's runs, CF256 at K = 2 sharing the card
    t0 = time.perf_counter()
    grid, cs8_cli, cf = _port_lines(
        ["grid", *GR12_ARGS],
        ["churn-sweep", "--mode", "pull", "--fanout", "1", "--n", str(N_CS),
         "--drop", "0.01", "--max-rounds", "32",
         *_scenario_args(_spec(f) for f in _cs8_faults(0))],
        ["churn-sweep", *CF_ARGS, *_scenario_args(CF_SCENARIOS),
         "--devices", "2", "--share-card"])
    check([(g["rounds_to_target"], g["final_coverage"], g["msgs_total"])
           for g in grid]
          == [(int(r), float(c[-1]), float(m[-1])) for r, c, m in zip(
              gr12.rounds_to_target, gr12.curves, gr12.msgs)],
          "grid GR12: the command's lines differ from the library's")
    check([(g["rounds_to_target"], g["final_coverage"], g["msgs_total"],
            g["dropped_total"]) for g in cs8_cli[-1]["churn_sweep"]]
          == [(s["rounds_to_target"], s["final_coverage"], s["msgs_total"],
               s["dropped_total"]) for s in cs8.summaries()],
          "churn-sweep CS8: the command's summaries differ from the "
          "library's")
    out = cf[-1]
    check([(s["rounds_to_target"], s["final_coverage"])
           for s in out["churn_sweep"]]
          == [(s["rounds_to_target"], s["final_coverage"])
              for s in cf_k1.summaries()]
          and all(r == {**{k: 0 for k in r}, "fused_mr_round": (w // 2)
                        * run.max_rounds * len(faults)}
                  for r in out["rank_launches"]),
          f"churn-sweep --engine fused --devices 2: {out['churn_sweep']}, "
          f"launches {out['rank_launches']}")
    lines["CF256"]["cli_k2"] = {"wall_s": out["wall_s"],
                                "rank_launches": out["rank_launches"]}
    wall_s["cli"] = time.perf_counter() - t0
    for name in ("ES32", "CF256"):
        emit("sweeps_k2", run=name, **{k: v for k, v in lines[name].items()
                                       if k in ("k2", "cli_k2")}, card=smi)
    emit("sweeps_phase", phase_wall_s=wall_s,
         phase_s=time.perf_counter() - t_phase, card=smi)
    return cf_launches


def _words(rng, shape, sparsity: int):
    """uint32 words, each bit set at rate 2^-sparsity (the AND of that
    many random words; 0: all bits random), as int32 bits."""
    import numpy as np
    words = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    for _ in range(sparsity - 1):
        words &= rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return words.view(np.int32)


def phase_roofline_checks(dev):
    """The three microkernels against their plain versions on the card,
    bitwise, at rows n_rows(10M) and 8: on the stream at i = 0, 3 and
    2^31 - 1, and under injected zero and random bits.  The table's bits
    are sparse (1/16), so the gathers and the chain show in the output;
    prng's output on the stream is all ones (32 ORed random words), and
    the stream's bits are pinned by prng_gather's lane picks.  Returns
    the cases and each kernel's largest absolute difference."""
    import numpy as np
    import torch
    from gossip_tpu_torch.ops import calibrate as CAL
    from gossip_tpu_torch.ops.fused_round import n_rows

    rng = np.random.default_rng(SEED + 4)
    kernels = (("cal_prng", CAL.prng_chain_step, CAL.prng_chain_step_plain),
               ("cal_prng_gather", CAL.prng_gather_step,
                CAL.prng_gather_step_plain))
    results, err = [], {"cal_prng": 0, "cal_prng_gather": 0, "cal_vpu": 0}

    def compare(name, rows, i, fill, got, want):
        e = _words_err(got, want)
        equal = bool(torch.equal(got, want))
        results.append({"kernel": name, "rows": rows, "i": i, "bits": fill,
                        "bitwise_equal": equal, "max_abs_err": e})
        check(equal, f"{name} vs plain, rows {rows}, i {i}, {fill}")
        err[name] = max(err[name], e)

    for rows in (n_rows(N), 8):
        table = torch.from_numpy(_words(rng, (rows, 128), 4)).to(dev)
        injected = {
            "zeros": torch.zeros(32, rows, 128, dtype=torch.int32,
                                 device=dev),
            "random": torch.from_numpy(_words(rng, (32, rows, 128), 0))
            .to(dev)}
        for i in (0, CHECK_ROUND, 2**31 - 1):
            for name, step, plain in kernels:
                compare(name, rows, i, "stream", step(i, table.clone()),
                        plain(i, table))
            compare("cal_vpu", rows, i, "none", CAL.vpu_step(i, table.clone()),
                    CAL.vpu_step_plain(i, table))
        for fill, bits in injected.items():
            for name, step, plain in kernels:
                compare(name, rows, CHECK_ROUND, fill,
                        step(CHECK_ROUND, table.clone(), bits),
                        plain(CHECK_ROUND, table, bits))
    return results, err


def check_roofline_doc(doc: dict, launches: dict):
    """The hard checks of one roofline document: every kernel launched
    as often as the tool's timed chains issued (a warm-up and
    ``CHAIN_REPEATS`` timed chains a measurement, and one more for each
    timing retried behind a longer sleep; the staged chain is a CUDA
    graph: its warm-up and capture only); the stream beyond L2 and every
    microkernel's ALU and FMA pipe rates at most 105% of the datasheet, and all its
    instructions at most 105% of the two pipes' issue; no microkernel
    faster than its bound; every measured round at least 95% of its
    calibrated floor."""
    from gossip_tpu_torch.tools import roofline as R
    chain = (R.CHAIN_REPEATS + 1) * doc["iters"]
    cal = doc["calibration"]
    want = {**cal["launches"], **doc["round_launches"], "sampler": 0}
    least = {**{name: chain for name in cal["launches"]},
             "fused_round": 2 * chain, "fused_mr_round": chain,
             "mr_gather": 2 * doc["iters"], "sampler": 0}
    check(launches == want and want["mr_gather"] == least["mr_gather"]
          and all(want[k] >= least[k] and want[k] % doc["iters"] == 0
                  for k in least),
          f"roofline launches {launches}, want {want} (at least {least})")
    stream = cal["hbm_beyond_l2"]["bytes_per_s"]
    check(stream <= 1.05 * R.HBM_BYTES_PER_S,
          f"stream beyond L2 {stream} B/s above the datasheet")
    for short in ("prng", "prng_gather", "vpu"):
        for pipe, most in (("alu", 1), ("fma", 1), ("sass", 2)):
            rate = cal[f"{short}_{pipe}_per_s"]
            check(rate <= 1.05 * most * R.INT32_OPS_PER_S,
                  f"{short} {pipe} at {rate} instructions/s: above the "
                  "datasheet, so the compiler removed work")
        bound_ms = R.cal_bound(f"cal_{short}", cal["shape"][0])[0]
        check(cal[f"t_{short}_ms"] >= bound_ms,
              f"{short} at {cal[f't_{short}_ms']} ms beats its bound "
              f"{bound_ms} ms")
    sr = doc["single_rumor"]
    for what, actual, floor in (
            ("single", sr["actual_ms_per_round"], sr["floor_overlap_ms"]),
            ("single, plane sharing 2", sr["actual_ms_plane_sharing2"],
             sr["floor_overlap_ms_plane_sharing2"]),
            ("value", doc["mr_value"]["actual_ms_per_round"],
             doc["kernels"]["fused_mr_round"]["floor_ms"]),
            ("staged", doc["mr_staged"]["actual_ms_per_round"],
             doc["mr_staged"]["floor_overlap_ms"])):
        check(actual >= 0.95 * floor,
              f"{what} round {actual} ms below 95% of its floor {floor} ms")


def phase_roofline(dev, smi: str):
    """Phase 16: the microkernels' checks and times, the SASS recount,
    then the roofline tool at N = 10M and 100M with its hard checks.
    Returns the microkernels' entries of the ``kernels`` line and the
    10M document's calibrated floors of the round kernels."""
    from pathlib import Path

    import torch
    from gossip_tpu_torch.ops import _kernels
    from gossip_tpu_torch.ops import calibrate as CAL
    from gossip_tpu_torch.ops.fused_round import n_rows
    from gossip_tpu_torch.tools import roofline as R
    from gossip_tpu_torch.utils.timing import steady_timed

    results, err = phase_roofline_checks(dev)
    sass = R.sass_counts()
    recount = {name: {k: c[k] for k in ("alu", "fma", "vector")}
               for name, c in sass.items()}
    check(recount == R.SASS_PER_WORD,
          f"SASS counts {recount} differ from SASS_PER_WORD")
    unassigned = {name: c["unassigned"] for name, c in sass.items()
                  if c["unassigned"]}
    check(not unassigned, f"SASS opcodes in no pipe list: {unassigned}")
    rows = n_rows(N)
    table = torch.zeros(rows, 128, dtype=torch.int32, device=dev)
    times = {}
    for name, step, plain in (
            ("cal_prng", CAL.prng_chain_step, CAL.prng_chain_step_plain),
            ("cal_prng_gather", CAL.prng_gather_step,
             CAL.prng_gather_step_plain),
            ("cal_vpu", CAL.vpu_step, CAL.vpu_step_plain)):
        times[name] = (
            kernel_ms(lambda: step(CHECK_ROUND, table)),
            1e3 * statistics.median(steady_timed(dev, plain, CHECK_ROUND,
                                                 table)[1] for _ in range(3)))
    emit("roofline_checks", cases=results, max_abs_err=err, tolerance=0,
         sass_per_word=sass, times_ms=times, card=smi)

    docs, launches = {}, {}
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    for n in (N, N_BIG):
        out = out_dir / f"roofline_n{n}.json"
        for k in _kernels.KERNELS:
            k.launches = 0
        check(R.main(["--n", str(n), "--out", str(out)]) == 0,
              f"roofline at n={n}")
        launches[n] = {k.name: k.launches for k in _kernels.KERNELS}
        docs[n] = json.loads(out.read_text())
        emit("roofline", n=n, doc=docs[n], launches=launches[n], card=smi)
        check_roofline_doc(docs[n], launches[n])

    # the one PyTorch call that draws as many random words: torch.randint
    # over the prng microkernel's count (32 words a table word), on its
    # own (Philox) stream, timed as the kernels are
    words = R.BITS * rows * R.LANES
    library = {"cal_prng": kernel_ms(lambda: torch.randint(
        0, 2**31, (words,), dtype=torch.int32, device=dev))}
    notes = {
        "cal_prng": f"torch.randint(0, 2**31, ({words},), int32): the same "
                    "count of random words, another stream, no table "
                    "write",
        "cal_prng_gather": "no single PyTorch call draws and gathers in "
                           "one pass: randint then a gather are two calls",
        "cal_vpu": "no single PyTorch call runs the integer chain: it is "
                   "one elementwise launch an operation in PyTorch"}
    entries = [{"name": name, "route": "cuda",
                "source": "gossip_tpu_torch/csrc/calibrate.cu",
                "replaces": f"tools/roofline.py:{line}",
                "launches": launches[N][name], "max_abs_err": err[name],
                "bitwise_equal": True, "ms": times[name][0],
                "plain_ms": times[name][1],
                "bound_ms": R.cal_bound(name, rows)[0],
                "bound_by": R.cal_bound(name, rows)[1],
                "library_ms": library.get(name),
                "library_note": notes[name],
                "path": "roofline", "card": smi}
               for name, line in (("cal_prng", 148), ("cal_prng_gather", 156),
                                  ("cal_vpu", 169))]
    return entries, {name: k["floor_ms"]
                     for name, k in docs[N]["kernels"].items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # ``--only sweeps,roofline``: those phases alone, after the device and
    # build lines, for a measurement; no ``ok`` line
    only = argv[1].split(",") if argv[:1] == ["--only"] else None
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    import numpy as np

    from gossip_tpu_torch import bench
    from gossip_tpu_torch.backend import run_simulation
    from gossip_tpu_torch.config import (FaultConfig, ProtocolConfig,
                                         RunConfig, TopologyConfig)
    from gossip_tpu_torch.ops import _kernels
    from gossip_tpu_torch.ops import fused_round as FR
    from gossip_tpu_torch.tools.roofline import round_bound
    from gossip_tpu_torch.utils.timing import steady_timed

    dev = torch.device("cuda", 0)
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=name,
         count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    built = _kernels.KERNELS + (_kernels.FUSED_MR_PARTS,)
    _kernels.build_all(built)
    emit("build", build_s=time.perf_counter() - t0,
         kernels={k.name: [ln.split(":", 1)[-1].strip()
                           for ln in k.ptxas.splitlines()
                           if any(w in ln for w in ("entry function",
                                                    "registers", "spill"))]
                  for k in built})
    if only:
        phases = {"sweeps": phase_sweeps, "roofline": phase_roofline,
                  "mesh_fused_planes": phase_mesh_fused_planes,
                  "mr_parts": phase_mr_parts,
                  "mr_checks": lambda dev, smi: emit(
                      "mr_checks", cases=phase_mr_checks(dev, N)[0],
                      card=smi)}
        for p in only:
            phases[p](dev, smi)
        return 0

    # 3. kernel against plain, then times at the main path's shape
    results, max_err, table = phase_checks(dev, N)
    out = torch.empty_like(table)
    pop = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = kernel_ms(lambda: FR.fused_pull_round(table, SEED, CHECK_ROUND, N,
                                               out=out, pop=pop))
    plain_ms = 1e3 * statistics.median(
        steady_timed(dev, FR.fused_pull_round_plain, table, SEED,
                     CHECK_ROUND, N)[1] for _ in range(3))
    bound_ms, bound_by = round_bound(N, 1, 1)
    # measurement only: the generic instantiation at fanout 2 under
    # deaths 0.1 and drop 0.05 (its bound counts operations, which the
    # alive table's bytes do not reach)
    alive_t, thr_t = FR.fault_masks_node_packed(
        FaultConfig(node_death_rate=0.1, drop_prob=0.05), N, 0, dev)
    generic = {"ms": kernel_ms(lambda: FR.fused_pull_round(
        table, SEED, CHECK_ROUND, N, 2, drop_threshold=thr_t,
        alive_table=alive_t, out=out, pop=pop)),
        **dict(zip(("bound_ms", "bound_by"), round_bound(N, 2, 1)))}
    del alive_t
    emit("checks", cases=results, max_abs_err=max_err, tolerance=0,
         kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by, generic_f2_deaths_drop=generic,
         sass_static=round_sass(_kernels.FUSED_ROUND), card=smi)

    # 4. the main path, counts from 0
    for k in _kernels.KERNELS:
        k.launches = 0
    report = run_simulation(ProtocolConfig(mode="pull", fanout=1),
                            TopologyConfig(family="complete", n=N),
                            RunConfig(seed=SEED, target_coverage=0.99,
                                      engine="fused"),
                            device="cuda")
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    rounds = report.rounds
    check(rounds > 0 and report.coverage >= np.float32(0.99),
          f"coverage {report.coverage} after {rounds} rounds")
    check(report.msgs == float(np.float32(2 * N * rounds)),
          f"msgs {report.msgs} != 2*n*rounds")
    check(launches["fused_round"] == rounds
          and sum(launches.values()) == rounds,
          f"launches {launches} for {rounds} rounds")
    emit("main_path", report=report.to_dict(), launches=launches, card=smi)

    # the same loop, round by round through the plain version
    final, _ = FR.until_fused(N, SEED, device=dev)
    plain = FR.init_fused_state(N, 0, dev).table
    for r in range(final.round):
        plain = FR.fused_pull_round_plain(plain, SEED, r, N)
    check(final.round == rounds and torch.equal(final.table, plain),
          "main path vs its plain replay")
    # the once-per-round host read: the loop against the curve loop
    # (same rounds, counters read once at the end)
    until_s = statistics.median(
        steady_timed(dev, FR.until_fused, N, SEED, device=dev)[1]
        for _ in range(5))
    curve_s = statistics.median(
        steady_timed(dev, FR.curve_fused, N, SEED, max_rounds=rounds,
                     device=dev)[1] for _ in range(5))
    emit("main_path_replay", plain_replay_equal=True, rounds=rounds,
         until_ms=until_s * 1e3, curve_ms=curve_s * 1e3,
         host_read_ms_per_round=(until_s - curve_s) * 1e3 / rounds,
         kernel_share_of_until=rounds * ms / (until_s * 1e3),
         kernel_share_of_curve=rounds * ms / (curve_s * 1e3), card=smi)

    # 5. bench
    b_rounds, seconds = bench.run_fused(N, "cuda")
    line = bench.measurement_line(N, b_rounds, seconds, bench.card_info())
    check(b_rounds == rounds, f"bench ran {b_rounds} rounds, not {rounds}")
    emit("bench", line=line)

    mr_kernels = phase_mr(dev, smi)
    mr_parts = phase_mr_parts(dev, smi)

    sampler = phase_sampler_checks(dev, smi)
    threefry_round_ms = phase_xla_main_path(dev, smi)
    xla_sampler_launches = phase_xla_sampler_path(dev, smi,
                                                  threefry_round_ms)
    churn_launches = phase_churn_path(dev, smi)
    single_runs = dict(phase_swim_rumor_path(dev, smi))
    crdt_runs, cr4_single = phase_crdt_log_path(dev, smi)
    single_runs.update(crdt_runs, CR4_direct=cr4_single)
    txn_runs, tx10m_single = phase_txn_path(dev, smi)
    single_runs.update(txn_runs, TX10M_direct=tx10m_single)
    sampler.update(launches=churn_launches, path="churn_path",
                   launches_by_path={"xla_sampler_path": xla_sampler_launches,
                                     "churn_path": churn_launches})
    phase_fused_deaths(dev, smi)
    cfg5_ms = phase_mesh_path(dev, smi)
    phase_mesh_models(dev, smi, single_runs)
    phase_mesh_exchanges(dev, smi, cfg5_ms)
    planes_launches = phase_mesh_fused_planes(dev, smi)
    sweeps_launches = phase_sweeps(dev, smi)
    mr_kernels[0]["launches_by_path"] = {
        "mr_main_path": mr_kernels[0]["launches"],
        "mesh_fused_planes": planes_launches,
        "sweeps": sweeps_launches}
    thr = mr_parts["threshold"]
    mr_kernels[0]["instantiations"] = {
        "mr_main_path": {"what": "fanout 1, the fast kernel",
                         "ms": mr_kernels[0]["ms"],
                         **_kernels.fused_mr_occupancy(1)},
        "mesh_fused_planes": {
            "what": "fanout 1, alive, cut and threshold operands",
            "ms": mr_parts["cases"]["redesign_f1"]["ms"],
            "bound_ms": mr_parts["bound_ms"]["f1"],
            **_kernels.fused_mr_occupancy(1, True, True, False, thr)},
        "sweeps": {
            "what": "fanout 2, alive, cut and threshold operands (CF256)",
            "ms": mr_parts["cases"]["redesign_f2"]["ms"],
            "bound_ms": mr_parts["bound_ms"]["f2"],
            **_kernels.fused_mr_occupancy(2, True, True, False, thr)}}
    cal_kernels, floors = phase_roofline(dev, smi)

    kernels = [{
        "name": "fused_round", "route": "cuda",
        "source": "gossip_tpu_torch/csrc/fused_round.cu",
        "replaces": "gossip_tpu/ops/pallas_round.py:316",
        "launches": launches["fused_round"], "max_abs_err": max_err,
        "bitwise_equal": True, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library_note": "no single PyTorch call computes this round",
        "card": smi}, *mr_kernels, sampler]
    for k in kernels:
        k["floor_ms"] = floors[k["name"]]
    print(json.dumps({"kernels": kernels + cal_kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
