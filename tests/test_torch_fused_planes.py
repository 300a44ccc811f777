"""The fused rumor planes (``gossip_tpu_torch.parallel.sharded_fused``),
their nemesis tables and ``run --engine fused --devices K`` against the
JAX package on the CPU.

The port runs K in {1, 2, 4} ranks under gloo, spawned once for each K a
test session (:func:`port_runs`; under xdist the first worker to need it
computes it and the others read it), and each test compares its share.
The spawned ranks import this module for :func:`_port_worker`, so its top
level imports torch, numpy and the port only; the JAX package comes in
through the ``ref`` fixture, with its executable store off, and runs on
its 8 virtual CPU devices with the fused round in interpret mode.

The reference's interpreter stubs its hardware PRNG with zeros, so its
loops cannot draw the port's stream: the loops are held to a host-stepped
reference (:func:`_replay`), each plane of each round through the JAX
package's ``fused_multirumor_pull_round(interpret=True)`` on the port's
Philox bits with that round's operands, the stop test through a jitted
``coverage_planes_masked`` (the compiled chooser).  One round is held to
the reference's ``make_sharded_fused_round`` on its plane mesh under
injected bits, through the port's ``make_sharded_fused_round`` (the
loops' own operands and round) and its ``make_sharded_fused_round_masked``
(operands passed in the reference's layout).

Tolerance: 0 everywhere (bitwise planes, rounds, coverage, curves, msgs
and digests).
"""

import functools
import json
import os
import pickle
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gossip_tpu_torch import config as TC
from gossip_tpu_torch.backend import run_simulation
from gossip_tpu_torch.ops import fused_mr_round as MR
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops.fused_round import drop_threshold_for
from gossip_tpu_torch.parallel import group as GR
from gossip_tpu_torch.parallel import sharded_fused as SF

KS = (1, 2, 4)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEATH = dict(node_death_rate=0.1, drop_prob=0.05, seed=1)


def _program(cut):
    """``tests/_churn_surfaces.py``'s program (a crash that recovers, a
    permanent crash, a cut window, a drop ramp, static deaths and drops)
    with the cut at ``cut``."""
    return dict(node_death_rate=0.1, drop_prob=0.05, seed=1, churn=dict(
        events=((3, 2, 5), (7, 1, -1)), partitions=((2, 6, cut),),
        ramp=(1, 4, 0.0, 0.3)))


# (name, n, rumors, fault, run, fanout): the loops' cases, each run
# until the target and as a curve of run["max_rounds"] rounds
LOOPS = [
    ("plain", 128 * 24 - 37, 96, None, dict(seed=3, max_rounds=24), 1),
    ("deaths", 128 * 8, 64, DEATH, dict(seed=5, max_rounds=12, origin=9), 2),
    ("program", 128 * 16 - 37, 64, _program(1000),
     dict(seed=1, max_rounds=12), 1),
]
LOOP_IDS = [c[0] for c in LOOPS]

# (name, fault, round): one round at K = 2 and 4 under injected bits
ROUND_N, ROUND_W = 128 * 12 - 37, 4
ROUNDS = [("plain", None, 0), ("deaths", DEATH, 1),
          ("program-r0", _program(700), 0), ("program-r3", _program(700), 3),
          ("program-r7", _program(700), 7)]

# (n, rumors, origin): the start planes
INITS = [(128 * 8, 64, 0), (128 * 24 - 37, 96, 7), (128 * 9 - 5, 40, 1000)]
DIGEST_N = 128 * 24 - 37


def _fault(spec, cfg):
    if spec is None:
        return None
    spec = dict(spec)
    churn = spec.pop("churn", None)
    if churn is not None:
        spec["churn"] = cfg.ChurnConfig(**churn)
    return cfg.FaultConfig(**spec)


def _round_inputs():
    """The round cases' global plane stack (the reference's start planes
    with random infection ORed in) and injected bits, from a numpy
    seed."""
    rng = np.random.default_rng(23)
    rows = MR.mr_rows(ROUND_N)
    planes = rng.integers(0, 2**32, (ROUND_W, rows, 128), dtype=np.uint32)
    planes &= rng.integers(0, 2**32, planes.shape, dtype=np.uint32)
    planes &= rng.integers(0, 2**32, planes.shape, dtype=np.uint32)
    planes.reshape(ROUND_W, -1)[:, ROUND_N:] = 0
    bits = (rng.integers(0, 2**32, (2, 8, 128), dtype=np.uint32),
            rng.integers(0, 2**32, (2, rows, 128), dtype=np.uint32))
    return planes, bits


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


def _port_worker(calls, group):
    """One rank's share of every port call (runs in the spawned ranks)."""
    out = {}
    for name, kind, args in calls:
        if kind == "init":
            n, rumors, origin = args
            out[name] = SF.init_plane_state(n, rumors, group, origin)
        elif kind == "round":
            fault, seed, round_, planes, bits = args
            w = planes.shape[0] // group.size
            mine = _i32(planes[group.rank * w:(group.rank + 1) * w])
            step = SF.make_sharded_fused_round(
                ROUND_N, group, 2, tuple(_i32(b) for b in bits),
                _fault(fault, TC), origin=5)
            out[name] = step(mine, seed, round_)
        elif kind == "masked":
            fault, seed, round_, planes, bits = args
            w = planes.shape[0] // group.size
            mine = _i32(planes[group.rank * w:(group.rank + 1) * w])
            ops = _masked_operands(_fault(fault, TC), round_)
            step = SF.make_sharded_fused_round_masked(
                ROUND_N, 2, tuple(_i32(b) for b in bits),
                has_alive="alive_words" in ops, has_cut="cut_words" in ops)
            out[name] = step(mine, seed, round_, **ops)
        elif kind in ("until", "curve"):
            n, rumors, fault, run, fanout = args
            fn = (SF.simulate_until_sharded_fused if kind == "until"
                  else SF.simulate_curve_sharded_fused)
            out[name] = fn(n, rumors, TC.RunConfig(**run), group, fanout,
                           _fault(fault, TC))
        else:                           # "digests"
            rows = MR.mr_rows(DIGEST_N)
            zeros = (torch.zeros(1, 8, 128, dtype=torch.int32),
                     torch.zeros(1, rows, 128, dtype=torch.int32))
            res = {"zero_bits": SF.prng_invariant_digests(
                       DIGEST_N, group, inject_bits=zeros),
                   "philox": SF.assert_prng_invariant(DIGEST_N, group,
                                                      seed=4, round_=3)}
            try:
                SF.assert_prng_invariant(DIGEST_N, group, seed=group.rank)
                res["diverged"] = None
            except AssertionError as e:
                res["diverged"] = str(e)
            out[name] = res
    return out


def _masked_operands(fault, round_):
    """A round case's fault operands in the reference's layout, rendered
    from the port's nemesis tables as the host-stepped reference renders
    them (:func:`_replay`), for ``make_sharded_fused_round_masked``."""
    if fault is None:
        return {}
    if NE.get(fault) is None:
        return dict(alive_words=MR.fault_masks_word(fault, ROUND_N, 5,
                                                    CPU)[0],
                    drop_threshold=drop_threshold_for(fault))
    base = NE.fused_base_words(fault, ROUND_N, 5, CPU)
    die, rec = NE.fused_word_tables(fault, ROUND_N, CPU)
    cut, thr = NE.fused_sched_tables(fault, ROUND_N)
    i = min(round_, len(cut) - 1)
    return dict(alive_words=NE.fused_alive_words_at(base, die, rec, round_),
                drop_threshold=int(thr[i]),
                cut_words=MR.render_cut_words(int(cut[i]), ROUND_N, CPU))


def _calls(k):
    calls = [(f"init-{i}", "init", spec) for i, spec in enumerate(INITS)]
    if k > 1:
        planes, bits = _round_inputs()
        calls += [(f"{kind}-{name}", kind, (fault, 11, r, planes, bits))
                  for name, fault, r in ROUNDS for kind in ("round", "masked")]
        calls.append(("digests", "digests", ()))
    for name, n, rumors, fault, run, fanout in LOOPS:
        for kind in ("until", "curve"):
            calls.append((f"{kind}-{name}", kind,
                          (n, rumors, fault, run, fanout)))
    return calls


@pytest.fixture(scope="session")
def port_runs(tmp_path_factory):
    """``{K: {name: per-rank results}}`` for every call of this file, one
    spawn for each K, once a session (shared through a file by the xdist
    workers of one run)."""
    from filelock import FileLock
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent if uid
            else tmp_path_factory.getbasetemp())
    path = root / f"torch_fused_planes_{uid or 'solo'}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return pickle.loads(path.read_bytes())
        with ThreadPoolExecutor(len(KS)) as pool:
            spawns = {k: pool.submit(GR.launch, _port_worker, k, _calls(k),
                                     device="cpu") for k in KS}
            runs = {k: {name: [r[name] for r in f.result()]
                        for name in f.result()[0]}
                    for k, f in spawns.items()}
        path.write_bytes(pickle.dumps(runs))
    return runs


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules, imported here and not at module level
    (the spawned ranks import this module)."""
    import jax
    import jax.numpy as jnp
    from gossip_tpu import backend as JB
    from gossip_tpu import config as JC
    from gossip_tpu.ops import nemesis as JNE
    from gossip_tpu.ops import pallas_round as J
    from gossip_tpu.parallel import sharded_fused as JSF
    return types.SimpleNamespace(jax=jax, jnp=jnp, B=JB, C=JC, NE=JNE, J=J,
                                 SF=JSF)


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    # the reference's AOT store cannot run sharded executables here
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _stack(per_rank):
    """Every rank's planes in rank order, as the reference's uint32."""
    return np.concatenate([_u32(p) for p in per_rank])


@functools.lru_cache(maxsize=None)
def _replay(name):
    """The host-stepped reference of a loop case (module doc): ``(start
    coverage, coverage after each round, planes after each round)`` over
    ``run["max_rounds"]`` rounds, on ``plane_count(rumors, 4)`` planes
    (every K of this file holds a prefix of them; the rest are padding
    planes at coverage 1.0)."""
    import jax
    from gossip_tpu import config as JC
    from gossip_tpu.ops import nemesis as JNE
    from gossip_tpu.ops import pallas_round as J
    from gossip_tpu.parallel import sharded_fused as JSF
    _, n, rumors, spec, run, fanout = next(c for c in LOOPS if c[0] == name)
    fault = _fault(spec, JC)
    origin, seed = run.get("origin", 0), run["seed"]
    planes = np.asarray(JSF.init_plane_state(n, rumors,
                                             JSF.make_plane_mesh(4), origin))
    cov = jax.jit(lambda p, w: JSF.coverage_planes_masked(p, n, w))
    thr, alive, cut = J.drop_threshold_for(fault), None, None
    words = None
    if JNE.get(fault) is not None:
        base = JNE.fused_base_words(fault, n, origin)
        die, rec = JNE.fused_word_tables(fault, n)
        words = JNE.fused_eventual_words(base, die, rec)
        cut_np, thr_np = JNE.fused_sched_tables(fault, n)
    elif spec is not None:
        words = alive = J.fault_masks_word(fault, n, origin)[0]
    if words is None:
        # no alive set: the division by the static n, folded under jit
        cov = jax.jit(lambda p, w: JSF.coverage_planes_masked(p, n))
    covs, tables = [], []
    c0 = float(cov(planes, words))
    for r in range(run["max_rounds"]):
        if JNE.get(fault) is not None:
            i = min(r, len(cut_np) - 1)
            alive = JNE.fused_alive_words_at(base, die, rec, r)
            thr, cut = int(thr_np[i]), J.render_cut_words(int(cut_np[i]), n)
        sb, rb = MR.draw_mr_round_bits(seed, r, planes.shape[1], fanout,
                                       device=CPU)
        planes = np.stack([np.asarray(J.fused_multirumor_pull_round(
            p, seed, r, n, fanout, interpret=True,
            inject_bits=(_u32(sb), _u32(rb)), drop_threshold=thr,
            alive_words=alive, cut_words=cut)) for p in planes])
        covs.append(float(cov(planes, words)))
        tables.append(planes)
    return c0, covs, tables


def _replay_until(name):
    """The reference's while-loop read off :func:`_replay`: ``(rounds,
    coverage, msgs, planes)``."""
    _, n, _, _, run, fanout = next(c for c in LOOPS if c[0] == name)
    c0, covs, tables = _replay(name)
    target = np.float32(run.get("target_coverage", 0.99))
    r, cov = 0, c0
    while cov < target and r < run["max_rounds"]:
        cov = covs[r]
        r += 1
    return r, cov, 2.0 * fanout * n * r, tables[r - 1]


# -- the nemesis tables ---------------------------------------------------

TABLES_N = 1001


@pytest.mark.parametrize("table", ["sched", "base", "die_rec", "alive_at",
                                   "eventual"])
def test_nemesis_fused_tables_equal_reference(ref, table):
    """The five fused tables of ``tests/_churn_surfaces.py``'s program
    (with its ramp) at n = 1001, bitwise against the reference's."""
    import _churn_surfaces
    jf = _churn_surfaces._churn_fault()
    tf = _fault(_program(32), TC)
    n, origin = TABLES_N, 4
    if table == "sched":
        for got, want in zip(NE.fused_sched_tables(tf, n),
                             ref.NE.fused_sched_tables(jf, n)):
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
        assert max(NE.fused_sched_tables(tf, n)[1]) == round(0.3 * 2**20)
        return
    base = NE.fused_base_words(tf, n, origin, CPU)
    jbase = ref.NE.fused_base_words(jf, n, origin)
    die, rec = NE.fused_word_tables(tf, n, CPU)
    jdie, jrec = ref.NE.fused_word_tables(jf, n)
    if table == "base":
        np.testing.assert_array_equal(_u32(base), np.asarray(jbase))
    elif table == "die_rec":
        np.testing.assert_array_equal(die.numpy(), np.asarray(jdie))
        np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    elif table == "alive_at":
        for r in range(9):
            np.testing.assert_array_equal(
                _u32(NE.fused_alive_words_at(base, die, rec, r)),
                np.asarray(ref.NE.fused_alive_words_at(jbase, jdie, jrec, r)))
    else:
        np.testing.assert_array_equal(
            _u32(NE.fused_eventual_words(base, die, rec)),
            np.asarray(ref.NE.fused_eventual_words(jbase, jdie, jrec)))


# -- the start planes -----------------------------------------------------

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("i", range(len(INITS)))
def test_init_planes_equal_reference_slices(port_runs, ref, k, i):
    """Each rank's start planes equal its slice of the reference's stack
    on ``make_plane_mesh(K)``, padding columns and planes included;
    ``plane_count`` is the reference's."""
    n, rumors, origin = INITS[i]
    assert SF.plane_count(rumors, k) == ref.SF.plane_count(rumors, k)
    per_rank = port_runs[k][f"init-{i}"]
    assert len({p.shape[0] for p in per_rank}) == 1
    want = np.asarray(ref.SF.init_plane_state(n, rumors,
                                              ref.SF.make_plane_mesh(k),
                                              origin))
    np.testing.assert_array_equal(_stack(per_rank), want)


def test_padding_planes_are_all_ones_at_real_nodes():
    """40 rumors on 4 ranks: plane 1 has 8 real rumors (one origin each)
    and 24 all-ones columns; planes 2 and 3 are all ones at every real
    node, zero at phantoms; the coverage is one node's."""
    n = 500
    g = types.SimpleNamespace(rank=0, size=1, device=CPU)
    planes = SF.init_plane_state(n, 40, g)
    assert planes.shape[0] == 2
    seen = MR.word_unpack(planes[1], n, 32)
    assert int(seen[:, :8].sum()) == 8 and bool(seen[:, 8:].all())
    g4 = [types.SimpleNamespace(rank=r, size=4, device=CPU) for r in (2, 3)]
    for gr in g4:
        (p,) = SF.init_plane_state(n, 40, gr)
        assert bool(MR.word_unpack(p, n, 32).all())
        assert not bool(p.reshape(-1)[n:].any())
    assert SF.coverage_planes(planes, n) == float(
        np.float32(1) * (np.float32(1) / np.float32(n)))


# -- one round ------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name,fault,round_", ROUNDS,
                         ids=[c[0] for c in ROUNDS])
def test_round_equals_reference(port_runs, ref, k, name, fault, round_):
    """One round of every rank's planes (fanout 2, injected bits) equals
    the reference's ``make_sharded_fused_round`` on ``make_plane_mesh(K)``
    in interpret mode: no fault, static deaths with drops, and the
    program at rounds 0 (before its window and ramp), 3 (node 3 down,
    inside the window and the ramp) and 7 (after both)."""
    planes, bits = _round_inputs()
    step = ref.SF.make_sharded_fused_round(
        ROUND_N, ref.SF.make_plane_mesh(k), 2, interpret=True,
        inject_bits=bits, fault=_fault(fault, ref.C), origin=5)
    want = np.asarray(step(ref.jnp.asarray(planes), 11, round_))
    np.testing.assert_array_equal(_stack(port_runs[k][f"round-{name}"]),
                                  want)
    assert not (want == planes).all()


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name,fault,round_", ROUNDS,
                         ids=[c[0] for c in ROUNDS])
def test_masked_round_equals_reference(port_runs, ref, k, name, fault,
                                       round_):
    """``make_sharded_fused_round_masked`` given the round's operands in
    the reference's layout (alive words, threshold, cut words, rendered
    from the port's nemesis tables) equals the reference's
    ``make_sharded_fused_round`` on the same case."""
    planes, bits = _round_inputs()
    step = ref.SF.make_sharded_fused_round(
        ROUND_N, ref.SF.make_plane_mesh(k), 2, interpret=True,
        inject_bits=bits, fault=_fault(fault, ref.C), origin=5)
    want = np.asarray(step(ref.jnp.asarray(planes), 11, round_))
    np.testing.assert_array_equal(_stack(port_runs[k][f"masked-{name}"]),
                                  want)


# -- the loops ------------------------------------------------------------

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", LOOP_IDS)
def test_until_equals_host_stepped_reference(port_runs, k, name):
    """The until loop at K ranks: rounds, the coverage of the loop's last
    stop test, msgs and every rank's final planes equal the host-stepped
    reference's while-loop."""
    got = port_runs[k][f"until-{name}"]
    rounds, cov, msgs, planes = _replay_until(name)
    assert all(g[:3] == (rounds, cov, msgs) for g in got)
    stack = _stack([g[3] for g in got])
    np.testing.assert_array_equal(stack, planes[:stack.shape[0]])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", LOOP_IDS)
def test_curve_equals_host_stepped_reference(port_runs, k, name):
    """The curve loop at K ranks: the coverage after every round and the
    final planes equal the host-stepped reference's scan."""
    got = port_runs[k][f"curve-{name}"]
    _, covs, tables = _replay(name)
    assert all(g[0] == covs for g in got)
    stack = _stack([g[1] for g in got])
    np.testing.assert_array_equal(stack, tables[-1][:stack.shape[0]])


@pytest.mark.parametrize("k", KS)
def test_planes_are_the_single_device_loop(port_runs, k):
    """Without a fault, plane p after R rounds is the single-device
    multi-rumor loop's table from origin 32p (``curve_fused_multirumor``:
    the same Philox bits), and the run stops at the planes' largest
    rounds-to-target: the trajectory does not depend on K."""
    _, n, rumors, _, run, _ = LOOPS[0]
    rounds = port_runs[k]["until-plain"][0][0]
    stack = _stack([g[3] for g in port_runs[k]["until-plain"]])
    hits = []
    for p in range(rumors // 32):
        final, covs = MR.curve_fused_multirumor(n, 32, run["seed"],
                                                max_rounds=rounds,
                                                origin=32 * p, device=CPU)
        np.testing.assert_array_equal(stack[p], _u32(final.table))
        hits.append(next(i + 1 for i, c in enumerate(covs)
                         if c >= np.float32(0.99)))
    assert rounds == max(hits)


# -- the compiled chooser -------------------------------------------------

def _boundary(total):
    """The first count c of ``total`` whose folded product and quotient
    differ."""
    inv = np.float32(1) / np.float32(total)
    return next(c for c in range(1, total)
                if np.float32(c) * inv != np.float32(c) / np.float32(total))


@pytest.mark.parametrize("metric", ["none", "deaths", "eventual"])
def test_chooser_at_ulp_boundary(ref, metric):
    """At a count where ``float32(c) * float32(1/a)`` and ``float32(c) /
    float32(a)`` differ, the port's plane coverage and its loops'
    chooser (``_Operands.fraction`` of the count the loops take from the
    kernel's counters, ``_Operands.least``) equal the reference's
    ``coverage_planes_masked`` under ``jax.jit``: the product without an
    alive set (the static n folds), the quotient by a traced alive total
    with deaths or under a program (the eventual words)."""
    n, origin = 128 * 24 - 37, 0
    spec = {"none": None, "deaths": DEATH,
            "eventual": _program(1000)}[metric]
    tf, jf = _fault(spec, TC), _fault(spec, ref.C)
    ops = SF._Operands(n, tf, origin, CPU)
    words = ops.metric
    alive = (np.ones(n, bool) if words is None
             else (_u32(words).reshape(-1)[:n] != 0))
    total = int(alive.sum())
    c = _boundary(total)
    # two planes, every bit all-ones at real nodes but bit 5 of plane 1,
    # held by the first c alive nodes (and by every dead one)
    flat = np.zeros((2, MR.mr_rows(n) * 128), np.uint32)
    flat[:, :n] = 0xFFFFFFFF
    holders = np.flatnonzero(alive)[c:]
    flat[1, holders] &= ~np.uint32(1 << 5)
    planes = flat.reshape(2, -1, 128)
    if words is None:
        want = ref.jax.jit(lambda p: ref.SF.coverage_planes_masked(p, n))(
            planes)
    else:
        want = ref.jax.jit(
            lambda p, w: ref.SF.coverage_planes_masked(p, n, w))(
            planes, np.asarray(_u32(words)))
    got = SF.coverage_planes_masked(_i32(planes), n, words)
    assert got == ops.fraction(c) == float(want)
    # the loops' count: the kernel's counters of these planes less the
    # bits at nodes outside the metric (dead from the start, and the
    # permanently crashed node, which holds every bit here)
    ops.start(_i32(planes))
    pop = SF._counts(_i32(planes)).to(torch.int32)
    lanes = _i32(planes).transpose(1, 2).contiguous()
    assert ops.fraction(int(ops.least(pop, lanes))) == float(want)
    prod = float(np.float32(c) * (np.float32(1) / np.float32(total)))
    quot = float(np.float32(c) / np.float32(total))
    assert got == (prod if words is None else quot) and prod != quot
    if metric == "eventual":
        assert ops.total == total and ops.perm is not None


# -- the invariant --------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
def test_prng_invariant_digests(port_runs, ref, k):
    """Every rank's digest equals the reference's
    ``prng_invariant_digests`` on ``make_plane_mesh(K)`` under zero bits
    (its interpreter's stubbed PRNG), the same on every rank; on the
    Philox stream every rank's digest is the same and the check passes;
    a rank keyed by another seed makes it raise on every rank, in the
    reference's words."""
    got = port_runs[k]["digests"]
    want = np.asarray(ref.SF.prng_invariant_digests(
        DIGEST_N, ref.SF.make_plane_mesh(k), interpret=True))
    for res in got:
        np.testing.assert_array_equal(res["zero_bits"], want)
        d = res["philox"]
        assert d.shape == (k, 2) and (d == d[0]).all() and d[0, 0] > 0
        assert not (d[0] == want[0]).all()
        assert res["diverged"].startswith(
            "zero-ICI plane-sharding PRNG invariant VIOLATED")


def test_plane_digest_arithmetic(ref):
    """``plane_digest`` is the reference's (popcount, weighted mix) mod
    2^32, on words with the top bit set (the mix wraps)."""
    rng = np.random.default_rng(3)
    t = rng.integers(0, 2**32, (24, 128), dtype=np.uint32)
    jnp = ref.jnp
    i = np.arange(24, dtype=np.uint32)[:, None]
    j = np.arange(128, dtype=np.uint32)[None, :]
    w = np.uint32(2) * (i * np.uint32(128) + j) + np.uint32(1)
    pop = int(jnp.sum(ref.jax.lax.population_count(jnp.asarray(t)),
                      dtype=jnp.uint32))
    mix = int(jnp.sum(jnp.asarray(t) * jnp.asarray(w), dtype=jnp.uint32))
    assert SF.plane_digest(_i32(t)) == (pop, mix)


# -- the entry points -----------------------------------------------------

def _ref_report(ref, monkeypatch, n, rumors, run, want_curve):
    """The reference's ``_run_fused`` report at 2 devices, its loops in
    interpret mode (its zero-PRNG values; the keys are what is
    compared)."""
    monkeypatch.setattr(ref.B, "_fused_ineligible_reason",
                        lambda *a, **k: None)
    for fn in ("simulate_until_sharded_fused",
               "simulate_curve_sharded_fused"):
        monkeypatch.setattr(ref.SF, fn, functools.partial(
            getattr(ref.SF, fn), interpret=True))
    return ref.B._run_fused(ref.C.ProtocolConfig(mode="pull", rumors=rumors),
                            ref.C.TopologyConfig(n=n), ref.C.RunConfig(**run),
                            None, 2, want_curve)


@pytest.mark.parametrize("want_curve", [False, True])
def test_run_simulation_runs_the_planes(ref, monkeypatch, want_curve):
    """``run_simulation(engine='fused', mesh_cfg=MeshConfig(2))`` spawns two
    gloo ranks of the planes: rounds (-1 below the target), coverage,
    msgs and the curve of the host-stepped reference, the reference's
    meta keys (its VMEM table bytes as ``table_bytes_per_plane``) and
    values, one ``all_reduce_min`` a stop test, no kernel on the CPU."""
    _, n, rumors, _, run, _ = LOOPS[0]
    run = dict(run, engine="fused")
    if not want_curve:
        run["max_rounds"] = 10       # short of the target: rounds -1
    rep = run_simulation(TC.ProtocolConfig(mode="pull", rumors=rumors),
                         TC.TopologyConfig(n=n), TC.RunConfig(**run),
                         want_curve=want_curve, device="cpu",
                         mesh_cfg=TC.MeshConfig(n_devices=2))
    c0, covs, _ = _replay("plain")
    if want_curve:
        hit = next(i + 1 for i, c in enumerate(covs) if c >= 0.99)
        want = (hit, covs[-1], 2.0 * n * run["max_rounds"], covs)
    else:
        want = (-1, covs[9], 2.0 * n * 10, None)
        assert covs[9] < np.float32(0.99)
    assert (rep.rounds, rep.coverage, rep.msgs, rep.curve) == want
    jrep = _ref_report(ref, monkeypatch, n, rumors, run, want_curve)
    jmeta = dict(jrep.meta)
    jmeta["table_bytes_per_plane"] = jmeta.pop("vmem_table_bytes_per_plane")
    jmeta.pop("compile_s")
    assert set(jmeta) <= set(rep.meta)
    for key in ("clock", "devices", "msgs_counts", "layout",
                "table_bytes_per_plane", "ici_bytes_per_round"):
        assert rep.meta[key] == jmeta[key], key
    assert rep.meta["engine"] == "fused-plain-planes"
    assert rep.meta["process_group"] == "gloo"
    calls = rep.meta["collective_ms"]["all_reduce_min"]["calls"]
    assert calls == (1 if want_curve else 11)
    assert [sum(r.values()) for r in rep.meta["rank_launches"]] == [0, 0]


def test_cli_runs_the_planes():
    """``python -m gossip_tpu_torch run --engine fused --devices 2 --device
    cpu`` exits 0 and prints the host-stepped reference's values."""
    _, n, rumors, _, run, _ = LOOPS[0]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.run(
        [sys.executable, "-m", "gossip_tpu_torch", "run", "--mode", "pull",
         "--n", str(n), "--rumors", str(rumors), "--seed", str(run["seed"]),
         "--max-rounds", str(run["max_rounds"]), "--engine", "fused",
         "--devices", "2", "--device", "cpu"], capture_output=True,
        text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    rounds, cov, msgs, _ = _replay_until("plain")
    assert (out["rounds"], out["coverage"], out["msgs"]) == (rounds, cov,
                                                             msgs)
    assert out["meta"]["layout"] == \
        "4 rumor planes x one 32-rumor word per node"


# (name, proto, topology, fault, devices, exchange): what the fused
# route refuses, in the reference's words
REFUSALS = [
    ("push", dict(mode="push"), dict(n=256), None, 2, "dense"),
    ("erdos-renyi", dict(mode="pull"),
     dict(family="erdos_renyi", n=256, p=0.05), None, 2, "dense"),
    ("dead-nodes", dict(mode="pull"), dict(n=256),
     dict(dead_nodes=(3,), fail_round=1), 2, "dense"),
    ("dead-nodes-one-device", dict(mode="pull"), dict(n=256),
     dict(dead_nodes=(3,), fail_round=1), 1, "dense"),
    ("rumors-33-one-device", dict(mode="pull", rumors=33), dict(n=256),
     None, 1, "dense"),
    ("sparse", dict(mode="pull"), dict(n=256), None, 2, "sparse"),
    ("program-one-device", dict(mode="pull"), dict(n=256),
     dict(churn=dict(events=((1, 1, 4),))), 1, "dense"),
]


@pytest.mark.parametrize("name,proto,topo,fault,k,exchange", REFUSALS,
                         ids=[c[0] for c in REFUSALS])
def test_fused_refusals_use_the_reference_words(ref, name, proto, topo,
                                                fault, k, exchange):
    """What the fused route refuses, on the planes (K = 2) and on one
    device, is refused before any rank starts with the reference's
    message (its single-device program refusal up to the surfaces the
    port does not have yet); none names a ROADMAP item."""
    mesh = TC.MeshConfig(n_devices=k, exchange=exchange) if k > 1 else None
    with pytest.raises(ValueError) as got:
        run_simulation(TC.ProtocolConfig(**proto), TC.TopologyConfig(**topo),
                       TC.RunConfig(engine="fused"), _fault(fault, TC),
                       device="cpu", mesh_cfg=mesh)
    jp, jt = ref.C.ProtocolConfig(**proto), ref.C.TopologyConfig(**topo)
    jf = _fault(fault, ref.C)
    if exchange != "dense":
        with pytest.raises(ValueError) as want:
            ref.B.run_simulation("jax-tpu", jp, jt,
                                 ref.C.RunConfig(engine="fused"), jf,
                                 ref.C.MeshConfig(n_devices=k,
                                                  exchange=exchange))
        want = str(want.value)
    else:
        want = ref.B._fused_ineligible_reason(jp, jt, jf, k)
    msg = str(got.value)
    if name == "program-one-device":
        head = want.split(", or the plane-sharded")[0]
        assert msg.startswith(head) and "--devices > 1" in msg
    else:
        assert msg == want
    assert "ROADMAP" not in msg and "item" not in msg
