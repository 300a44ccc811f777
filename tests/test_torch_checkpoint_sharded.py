"""The port's checkpointed drivers on K ranks against the JAX package's on
its K-device CPU mesh: the packed node-sharded SI driver
(``parallel/sharded_packed.checkpointed_packed_sharded``) at K = 2 and 4,
SWIM and rumor mongering on the mesh at K = 2, and the fused rumor
planes (``parallel/sharded_fused.checkpointed_fused_planes``) at K = 1
and 2, each without a fault and under a fault program whose partition
window and drop ramp are open at the kill (round 3).

Each case checks, bitwise (the padded state or plane stack, the eager
coverage, the curve, ``msgs``, ``round`` and ``dropped``):

* the port's run killed at round 3 and resumed from its file equals its
  straight run;
* the port's straight run equals the reference's;
* a run the reference starts (its file, the padded global array) and
  every port rank resumes equals the reference's straight run.

The reference cannot run its planes off its TPU with the port's bits
(its interpreter stubs the hardware PRNG with zeros), so its
``checkpointed_fused_planes(interpret=True)`` runs with its round
patched to inject the port's Philox bits of each absolute round
(:func:`_injected`); the port's checkpointed planes are also held to its
own straight ``simulate_curve_sharded_fused``.  The planes' cross resume
starts from the reference's file with ``msgs`` set past ``2**25``, where
each round's ``+ 2 * fanout * n`` rounds in float32: the carry the
10M-node run reaches, at a size the CPU runs.

The port runs in one spawn for each K a session (gloo), shared by the
xdist workers through a file; the reference's half-run files are written
before the spawn.  The spawned ranks import this module, so its top
level imports torch, numpy and the port only.  Tolerance: 0.
"""

import os
import pickle
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gossip_tpu_torch import config as TC
from gossip_tpu_torch.models import rumor as TRU
from gossip_tpu_torch.ops import fused_mr_round as MR
from gossip_tpu_torch.ops.common import f32_fraction, f32_mean
from gossip_tpu_torch.ops.fused_round import FusedState
from gossip_tpu_torch.parallel import group as GR
from gossip_tpu_torch.parallel import sharded_fused as SF
from gossip_tpu_torch.parallel import sharded_packed as SP
from gossip_tpu_torch.runtime import simulator as TSIM
from gossip_tpu_torch.topology import generators as TG
from gossip_tpu_torch.utils import checkpoint as TCK

N, PLANES_N = 209, 647     # K does not divide them; both meet ulp counts
T, HALF, EVERY = 10, 3, 3
BIG_MSGS = 2.0**25 + 2.0   # past 2^25 a float32 add of 2n (n odd) rounds

_CHURN = dict(events=((3, 2, 5), (7, 1, -1)), partitions=((2, 6, 100),),
              ramp=(1, 4, 0.0, 0.3))
FAULTS = {
    "packed": dict(drop_prob=0.05, seed=1, churn=_CHURN),
    "rumor": dict(drop_prob=0.05, seed=1, churn=_CHURN),
    # SWIM refuses partition windows
    "swim": dict(drop_prob=0.05, seed=1, churn=dict(
        events=((3, 2, 5), (2, 1, -1)), ramp=(1, 4, 0.0, 0.3))),
    "planes": dict(node_death_rate=0.1, drop_prob=0.05, seed=1,
                   churn=dict(_CHURN, partitions=((2, 6, 300),))),
}
PROTOS = {
    "packed": dict(mode="pull", fanout=2, rumors=40),
    "swim": dict(mode="swim", fanout=2, swim_proxies=2,
                 swim_suspect_rounds=3, swim_subjects=4),
    "rumor": dict(mode="rumor", fanout=2, rumors=2, rumor_k=3),
    "planes": dict(mode="pull", fanout=1, rumors=64),
}
SEEDS = {"packed": 0, "swim": 2, "rumor": 4, "planes": 3}
# (kind, K): every kind without a fault and under its program
CASES = [("packed", 2), ("packed", 4), ("swim", 2), ("rumor", 2),
         ("planes", 1), ("planes", 2)]
PARAMS = [(kind, k, f) for kind, k in CASES for f in ("none", "program")]
IDS = [f"{kind}-k{k}-{f}" for kind, k, f in PARAMS]
KS = sorted({k for _, k in CASES})


def _fault(cfg, kind, name):
    if name == "none":
        return None
    spec = dict(FAULTS[kind])
    churn = spec.pop("churn")
    return cfg.FaultConfig(churn=cfg.ChurnConfig(**churn), **spec)


def _tag(kind, k, f):
    return f"{kind}-k{k}-{f}"


# -- the port (runs in the spawned ranks) ----------------------------------

def _port(kind, fault_name, path, rounds, group, resume=None):
    """``(fields of the gathered final state, coverage, curve)`` of the
    port's checkpointed ``kind`` run to ``rounds`` from ``resume`` (a
    file) or round 0, on this rank of ``group``."""
    fault = _fault(TC, kind, fault_name)
    meta = TCK.load_meta(resume)["extra"] if resume else {}
    st = TCK.load_state(resume, device="cpu") if resume else None
    run = TC.RunConfig(seed=SEEDS[kind], max_rounds=rounds)
    proto = TC.ProtocolConfig(**PROTOS[kind])
    kw = dict(every=EVERY, resume_state=st, want_curve=True,
              curve_prefix=meta.get("curve", ()))
    if kind == "packed":
        final, cov, curve = SP.checkpointed_packed_sharded(
            proto, TG.complete(N), run, group, path, fault=fault,
            lost_prefix=meta.get("dropped", 0.0), **kw)
    elif kind == "swim":
        final, cov, curve = TSIM.checkpointed_swim(
            proto, N, run, path, dead_nodes=(1,), fail_round=2,
            fault=fault, group=group, **kw)
    elif kind == "rumor":
        final, cov, _, curve = TRU.checkpointed_rumor(
            proto, TG.complete(N), run, path, fault=fault, group=group,
            lost_prefix=meta.get("dropped", 0.0), **kw)
    else:
        final, cov, curve = SF.checkpointed_fused_planes(
            PLANES_N, proto.rumors, run, group, path, fanout=proto.fanout,
            fault=fault, **kw)
    return TCK.state_fields(final, group), cov, curve


def _port_worker(tmp, k, group):
    """Every case of this K on this rank: straight, half, resumed from
    its own file, resumed from the reference's; the planes' straight
    loop.  Rank 0 returns them."""
    out = {}
    for kind, kk in CASES:
        if kk != k:
            continue
        for f in ("none", "program"):
            tag = _tag(kind, k, f)
            p = lambda name: os.path.join(tmp, f"{tag}-{name}")  # noqa
            res = {"straight": _port(kind, f, p("t-full.npz"), T, group)}
            _port(kind, f, p("t-half.npz"), HALF, group)
            res["resumed"] = _port(kind, f, p("t-half.npz"), T, group,
                                   p("t-half.npz"))
            res["cross"] = _port(kind, f, p("x.npz"), T, group,
                                 p("j-half.npz"))
            res["meta"] = {name: TCK.load_meta(p(name))["extra"]
                           for name in ("t-full.npz", "t-half.npz",
                                        "x.npz")}
            if kind == "planes":
                covs, planes = SF.simulate_curve_sharded_fused(
                    PLANES_N, PROTOS["planes"]["rumors"],
                    TC.RunConfig(seed=SEEDS[kind], max_rounds=T), group,
                    1, _fault(TC, kind, f))
                res["loop"] = (covs, TCK.state_fields(
                    FusedState(planes, T, np.float32(0)), group))
            out[tag] = res
    return out if group.rank == 0 else None


# -- the reference (the pytest process) ------------------------------------

def _injected(J, seed, fanout, rows):
    """The reference's fused round with the port's Philox bits of the
    absolute round it is called with (the planes' cases)."""
    bits = [MR.draw_mr_round_bits(seed, r, rows, fanout, device="cpu")
            for r in range(T)]
    sb, rb = (J.jnp.asarray(np.stack([b[i].numpy().view(np.uint32)
                                      for b in bits])) for i in (0, 1))
    orig = J.SF.fused_multirumor_pull_round

    def round_(table, seed_, round__, n, fanout_, interpret=False,
               inject_bits=None, **kw):
        return orig(table, seed_, round__, n, fanout_, interpret,
                    inject_bits=(sb[round__], rb[round__]), **kw)
    return round_


def _ref(J, kind, k, fault_name, path, rounds, resume=None,
         resume_state=None):
    """``(final state, coverage, curve)`` of the reference's checkpointed
    ``kind`` run on its K-device mesh."""
    from unittest import mock
    fault = _fault(J.C, kind, fault_name)
    meta = J.CK.load_meta(resume)["extra"] if resume else {}
    st = resume_state if resume_state is not None else (
        J.CK.load_state(resume) if resume else None)
    run = J.C.RunConfig(seed=SEEDS[kind], max_rounds=rounds)
    proto = J.C.ProtocolConfig(**PROTOS[kind])
    kw = dict(every=EVERY, resume_state=st, want_curve=True,
              curve_prefix=meta.get("curve", ()))
    if kind == "packed":
        return J.SP.checkpointed_packed_sharded(
            proto, J.G.complete(N), run, J.make_mesh(k), path, fault=fault,
            lost_prefix=meta.get("dropped", 0.0), **kw)
    if kind == "swim":
        return J.SIM.checkpointed_swim(
            proto, N, run, path, dead_nodes=(1,), fail_round=2,
            fault=fault, mesh=J.make_mesh(k), **kw)
    if kind == "rumor":
        final, cov, _, curve = J.RU.checkpointed_rumor(
            proto, J.G.complete(N), run, path, fault=fault,
            mesh=J.make_mesh(k), lost_prefix=meta.get("dropped", 0.0),
            **kw)
        return final, cov, curve
    if fault is not None:
        # the reference caches its churn masks on first use; a first use
        # inside its scan's trace would cache tracers for the next trace
        J.SF._cached_churn_masks(fault, PLANES_N, 0)
    patched = _injected(J, SEEDS[kind], proto.fanout, MR.mr_rows(PLANES_N))
    with mock.patch.object(J.SF, "fused_multirumor_pull_round", patched):
        return J.SF.checkpointed_fused_planes(
            PLANES_N, proto.rumors, run, J.SF.make_plane_mesh(k), path,
            fanout=proto.fanout, interpret=True, fault=fault, **kw)


def _jax():
    import jax
    import jax.numpy as jnp
    from gossip_tpu import config as JC
    from gossip_tpu.models import rumor as JRU
    from gossip_tpu.parallel import sharded_fused as JSF
    from gossip_tpu.parallel import sharded_packed as JSP
    from gossip_tpu.parallel.sharded import make_mesh
    from gossip_tpu.runtime import simulator as JSIM
    from gossip_tpu.topology import generators as JG
    from gossip_tpu.utils import checkpoint as JCK
    return types.SimpleNamespace(jax=jax, jnp=jnp, C=JC, RU=JRU, SF=JSF,
                                 SP=JSP, SIM=JSIM, G=JG, CK=JCK,
                                 make_mesh=make_mesh)


def _write_ref_halves(J, tmp):
    """The reference's half-run files every cross resume starts from; the
    planes' with ``msgs`` set to :data:`BIG_MSGS`."""
    for kind, k in CASES:
        for f in ("none", "program"):
            path = os.path.join(tmp, f"{_tag(kind, k, f)}-j-half.npz")
            final, _, _ = _ref(J, kind, k, f, path, HALF)
            if kind == "planes":
                meta = J.CK.load_meta(path)["extra"]
                J.CK.save_state(path, final._replace(
                    msgs=J.jnp.float32(BIG_MSGS)), meta)


@pytest.fixture(scope="session")
def runs(tmp_path_factory):
    """``(tmp dir, {tag: the port's results})``: one spawn for each K,
    once a session, shared by the xdist workers through a file."""
    from unittest import mock

    from filelock import FileLock
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent if uid
            else tmp_path_factory.getbasetemp())
    tmp = root / f"torch_ckpt_sharded_{uid or 'solo'}"
    path = root / f"torch_ckpt_sharded_{uid or 'solo'}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return str(tmp), pickle.loads(path.read_bytes())
        tmp.mkdir(exist_ok=True)
        # the reference's executable store off for its runs, and only
        # for them (the other tests of this worker keep the session's)
        with mock.patch.dict(os.environ, {"GOSSIP_COMPILE_CACHE": ""}):
            _write_ref_halves(_jax(), str(tmp))
        with ThreadPoolExecutor(len(KS)) as pool:
            spawns = [pool.submit(GR.launch, _port_worker, k, str(tmp), k,
                                  device="cpu") for k in KS]
            results = {}
            for f in spawns:
                results.update(f.result()[0])
        path.write_bytes(pickle.dumps(results))
    return str(tmp), results


@pytest.fixture(scope="module")
def J():
    return _jax()


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    # the reference's store cannot run sharded executables here
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _ref_fields(J, state) -> dict:
    return {k: np.asarray(J.jax.random.key_data(v)) if k == "base_key"
            else np.asarray(v) for k, v in state._asdict().items()}


def _assert_fields_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("kind,k,fault", PARAMS, ids=IDS)
def test_checkpointed_driver_equals_reference(runs, J, tmp_path, kind, k,
                                             fault):
    """Straight, resumed and cross-resumed runs (module doc), bitwise."""
    tmp, results = runs
    res = results[_tag(kind, k, fault)]
    want = _ref(J, kind, k, fault, str(tmp_path / "j-full.npz"), T)
    wfields = _ref_fields(J, want[0])
    for leg in ("straight", "resumed"):
        fields, cov, curve = res[leg]
        _assert_fields_equal(fields, wfields)
        assert (cov, curve) == (want[1], want[2]), leg
    jm = J.CK.load_meta(str(tmp_path / "j-full.npz"))["extra"]
    assert res["meta"]["t-full.npz"] == res["meta"]["t-half.npz"] == jm
    assert jm["round"] == T
    if fault == "program" and kind != "swim" and kind != "planes":
        assert jm["dropped"] > 0
    half = os.path.join(tmp, f"{_tag(kind, k, fault)}-j-half.npz")
    cross = _ref(J, kind, k, fault, str(tmp_path / "jx.npz"), T, half)
    fields, cov, curve = res["cross"]
    _assert_fields_equal(fields, _ref_fields(J, cross[0]))
    assert (cov, curve) == (cross[1], cross[2])
    assert res["meta"]["x.npz"] == J.CK.load_meta(
        str(tmp_path / "jx.npz"))["extra"]
    if kind != "planes":
        # the reference's straight run, from the reference's half file
        _assert_fields_equal(fields, wfields)
    if fault == "none" and kind in ("packed", "planes"):
        # the curve meets counts where the folded division and the true
        # quotient differ, and the eager coverage is the quotient
        n = PLANES_N if kind == "planes" else N
        counts = [round(v * n) for v in want[2]]
        assert any(f32_mean(c, n) != f32_fraction(c, n) for c in counts)
        assert want[1] == f32_fraction(round(want[1] * n), n)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("fault", ["none", "program"])
def test_checkpointed_planes_are_the_straight_loop(runs, k, fault):
    """The checkpointed planes equal the port's straight
    ``simulate_curve_sharded_fused`` (planes and curve), which is held to
    the reference's round elsewhere; their ``msgs`` is the float32 carry,
    and from the cross resume's start past ``2**25`` that carry is not
    the product the straight loop's report gives."""
    _, results = runs
    res = results[_tag("planes", k, fault)]
    covs, loop = res["loop"]
    fields, _, curve = res["straight"]
    np.testing.assert_array_equal(fields["table"], loop["table"])
    assert curve == covs
    add = np.float32(2.0 * PLANES_N)
    carry = np.float32(BIG_MSGS)
    for _ in range(T - HALF):
        carry = np.float32(carry + add)
    assert res["cross"][0]["msgs"] == carry
    assert float(carry) != BIG_MSGS + 2.0 * PLANES_N * (T - HALF)
