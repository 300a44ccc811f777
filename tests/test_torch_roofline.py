"""The port's roofline path on the CPU: the calibration microkernels'
plain versions (gossip_tpu_torch/ops/calibrate.py), the counts and the
bound model of gossip_tpu_torch/tools/roofline.py, its document and its
refusals.  Every comparison is exact (tolerance 0): the microkernels and
the counts are integer functions.

* The counts equal tools/roofline.py's on every shared key, and each
  documented difference is its formula.
* Under injected zero bits each plain microkernel equals the JAX
  package's microkernel run in Pallas interpret mode (whose generator
  draws zeros), captured by replacing the reference's ``_timed_chain``
  with a recorder that applies one step to a random table.
* Under random injected bits and on the Philox stream the plain versions
  equal numpy models; the prng output is the OR of
  ``philox.draw_words(*round_key(i, i), rows, 32)``.
* ``--smoke --device cpu`` writes a document with the reference's keys
  and the port's additions that passes tools/validate_artifacts.py's
  provenance check.
"""

import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gossip_tpu_torch.ops import _kernels, philox
from gossip_tpu_torch.ops import calibrate as CAL
from gossip_tpu_torch.ops import fused_mr_round as MR
from gossip_tpu_torch.ops import fused_round as FR
from gossip_tpu_torch.tools import roofline as R
from gossip_tpu_torch.utils import provenance as P
from gossip_tpu_torch.utils.timing import timed_chain

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
I_CASES = [0, 5, 2**31 - 1]


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """The JAX package's tools/roofline.py, loaded by path (it imports
    JAX only inside its functions)."""
    return _load("reference_roofline", "tools/roofline.py")


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def _port(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)
                            .copy())


def _u32_of(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n", [4096 * 8, 10_000_000 - 37, 10_000_000,
                               2**24 + 1])
def test_counts_match_reference(ref, n):
    """Shared keys equal the reference's; prng_words and vpu_ops are the
    documented formulas (tolerance 0)."""
    want_sr, got_sr = ref.single_rumor_counts(n), R.single_rumor_counts(n)
    assert set(got_sr) == set(want_sr)
    for key in ("rows", "table_bytes", "gathers"):
        assert got_sr[key] == want_sr[key]
    words = got_sr["rows"] * 128
    assert got_sr["prng_words"] == 128 + 32 * words
    assert want_sr["prng_words"] - got_sr["prng_words"] == 7 * 128
    stages = max(1, int(np.ceil(np.log2(got_sr["rows"]))))
    assert got_sr["vpu_ops"] == (7 * 32 + 4) * words
    assert want_sr["vpu_ops"] - got_sr["vpu_ops"] == 3 * stages * words
    assert R.single_rumor_counts(n, 2)["prng_words"] == 128 + 16 * words
    assert R.mr_staged_counts(n) == ref.mr_staged_counts(n)


def test_counts_at_ten_million():
    """The reference's figures at 10M, worked out by hand."""
    sr, mr = R.single_rumor_counts(10**7), R.mr_staged_counts(10**7)
    assert (sr["rows"], sr["table_bytes"]) == (2448, 1_253_376)
    assert (mr["rows"], mr["table_bytes"]) == (78128, 40_001_536)
    assert mr["hbm_bytes_fused_rot"] == 200_007_680


@pytest.mark.parametrize("i", I_CASES)
@pytest.mark.parametrize("rows", [8, 16])
def test_zero_bits_match_reference_interpret(ref, monkeypatch, rows, i):
    """prng, prng_gather and vpu under zero bits against the reference's
    interpret-mode microkernels, bitwise (tolerance 0)."""
    import jax.numpy as jnp
    table = _u32(np.random.default_rng(rows + i % 97), (rows, 128))
    outs = []

    def recorder(step, init, iters):
        outs.append(np.asarray(step(jnp.int32(i), jnp.asarray(table))))
        return 1.0

    monkeypatch.setattr(ref, "_timed_chain", recorder)
    ref.calibrate(rows, True, 1)
    assert len(outs) == 3
    zeros = np.zeros((32, rows, 128), np.uint32)
    t = _port(table)
    np.testing.assert_array_equal(
        _u32_of(CAL.prng_chain_step_plain(i, t, zeros)), outs[0])
    np.testing.assert_array_equal(
        _u32_of(CAL.prng_gather_step_plain(i, t, zeros)), outs[1])
    np.testing.assert_array_equal(_u32_of(CAL.vpu_step_plain(i, t)), outs[2])
    # the interpreter's zero generator: prng keeps the table, every
    # gather reads lane 0
    np.testing.assert_array_equal(outs[0], table)
    np.testing.assert_array_equal(outs[1], table | table[:, :1])


def _gather_model(table, bits):
    acc = table.copy()
    for d in range(bits.shape[0]):
        acc |= np.take_along_axis(table, (bits[d] & 127).astype(np.int64),
                                  axis=1)
    return acc


@pytest.mark.parametrize("rows", [8, 24])
def test_injected_bits_match_numpy_model(rows):
    """Random injected bits against a numpy model of each drawing
    microkernel (tolerance 0); the table is sparse so the gathers show."""
    rng = np.random.default_rng(rows)
    table = _u32(rng, (rows, 128)) & _u32(rng, (rows, 128)) \
        & _u32(rng, (rows, 128)) & _u32(rng, (rows, 128))
    bits = _u32(rng, (32, rows, 128))
    sparse = bits & _u32(rng, bits.shape) & _u32(rng, bits.shape) \
        & _u32(rng, bits.shape) & _u32(rng, bits.shape)
    t = _port(table)
    np.testing.assert_array_equal(
        _u32_of(CAL.prng_chain_step_plain(3, t, _port(sparse))),
        table | np.bitwise_or.reduce(sparse, axis=0))
    np.testing.assert_array_equal(
        _u32_of(CAL.prng_gather_step_plain(3, t, _port(bits))),
        _gather_model(table, bits))


@pytest.mark.parametrize("i", I_CASES)
def test_stream_matches_draw_words_and_models(i):
    """On the stream: prng is the table ORed with the round key (i, i)'s
    32 draw words, prng_gather gathers by them, and vpu is the uint32
    chain with s = uint32(int32(i) * 1000003) (tolerance 0)."""
    rows = 16
    rng = np.random.default_rng(i % 1009)
    table = _u32(rng, (rows, 128)) & _u32(rng, (rows, 128))
    k0, k1 = philox.round_key(i, i)
    assert (k0, k1) == CAL.step_key(i)
    # the bits of the reference's wrapping int32 product i * 1000003
    s = np.uint32(i * 1000003 % 2**32)
    assert k0 == s
    draws = philox.draw_words(k0, k1, rows, 32).numpy().astype(np.uint32)
    t = _port(table)
    np.testing.assert_array_equal(
        _u32_of(CAL.prng_chain_step_plain(i, t)),
        table | np.bitwise_or.reduce(draws, axis=0))
    np.testing.assert_array_equal(
        _u32_of(CAL.prng_gather_step_plain(i, t)),
        _gather_model(table, draws))
    acc = table.copy()
    with np.errstate(over="ignore"):
        for k in range(256):
            acc = (acc ^ (s + np.uint32(k))) | (acc >> np.uint32(1))
    np.testing.assert_array_equal(_u32_of(CAL.vpu_step_plain(i, t)), acc)


def test_wrappers_update_cpu_tables_in_place():
    rng = np.random.default_rng(2)
    table = _u32(rng, (8, 128))
    bits = _u32(rng, (32, 8, 128))
    for step, plain, args in (
            (CAL.prng_chain_step, CAL.prng_chain_step_plain, (bits,)),
            (CAL.prng_gather_step, CAL.prng_gather_step_plain, (bits,)),
            (CAL.prng_gather_step, CAL.prng_gather_step_plain, ()),
            (CAL.vpu_step, CAL.vpu_step_plain, ())):
        t = _port(table)
        want = plain(7, t.clone(), *args)
        assert step(7, t, *args) is t
        assert torch.equal(t, want)


def test_refusals(capsys):
    """No fallback: a non-CPU tensor that is not CUDA is refused, the
    launch layer takes CUDA tensors only, and with no card the roofline
    refuses to run unless --device cpu is given."""
    with pytest.raises(ValueError, match="int32"):
        CAL.vpu_step(0, torch.zeros(8, 64, dtype=torch.int32))
    with pytest.raises(ValueError, match="no calibration kernel"):
        CAL.prng_chain_step(0, torch.zeros(8, 128, dtype=torch.int32,
                                           device="meta"))
    for launch, args in ((_kernels.cal_prng, ((0, 0),)),
                         (_kernels.cal_prng_gather, ((0, 0),)),
                         (_kernels.cal_vpu, (0,))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch(torch.zeros(8, 128, dtype=torch.int32), *args)
    if torch.cuda.is_available():
        return
    with pytest.raises(ValueError, match="needs a CUDA device"):
        R.calibrate(8)
    assert R.main(["--smoke"]) == 1
    captured = capsys.readouterr()
    assert "needs a CUDA device" in captured.err and not captured.out


def test_smoke_document_on_cpu(tmp_path, capsys):
    """``--smoke --device cpu`` through ``main``: the summary line and a
    document with the reference's keys, the port's additions and the
    provenance keys of tools/validate_artifacts.py."""
    out = tmp_path / "roofline.json"
    assert R.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"single_actual_ms", "single_util_serial",
                         "mr_actual_ms", "mr_util_hbm", "backend", "smoke"}
    assert line["backend"] == "cpu" and line["smoke"] is True
    doc = json.loads(out.read_text())
    assert {"what", "provenance", "backend", "smoke", "n", "rumors",
            "calibration", "single_rumor", "mr_staged", "mr_value",
            "kernels"} <= set(doc)
    assert (doc["n"], doc["rumors"], doc["iters"]) == (4096 * 8, 8, 2)
    cal = doc["calibration"]
    assert {"shape", "prng_words_per_s", "gathers_per_s", "gather_resolved",
            "vpu_ops_per_s", "t_prng_ms", "t_prng_gather_ms", "t_vpu_ms",
            "hbm", "hbm_beyond_l2", "vpu_alu_per_s",
            "prng_sass_per_s"} <= set(cal)
    assert cal["hbm_beyond_l2"]["table_bytes"] == 4 * cal["hbm"]["table_bytes"]
    sr = doc["single_rumor"]
    assert {"counts", "actual_ms_per_round", "actual_ms_plane_sharing2",
            "floor_components_ms", "gather_floor_resolved",
            "floor_serial_ms", "floor_overlap_ms", "utilization_vs_serial",
            "utilization_vs_overlap"} <= set(sr)
    assert sr["floor_overlap_ms"] == max(sr["floor_components_ms"].values())
    assert sr["floor_overlap_ms_plane_sharing2"] > 0
    assert {"counts", "actual_ms_per_round", "floor_ms_fused_rotation",
            "floor_ms_materialized_rotation", "utilization_vs_fused_floor",
            "rotation_fuses", "floor_overlap_ms"} <= set(doc["mr_staged"])
    assert doc["mr_staged"]["timed_as"] == "host clock"
    assert set(doc["kernels"]) == {"fused_round", "fused_mr_round",
                                   "mr_gather", "sampler"}
    # one floor for the value round: the one of its kernel
    assert doc["mr_value"]["floor_ms"] == \
        doc["kernels"]["fused_mr_round"]["floor_ms"]
    # the launches the chains issued: a warm-up and the timed chains each
    # (on the CPU no timing retries and the staged chain is no graph)
    chain = (R.CHAIN_REPEATS + 1) * doc["iters"]
    assert cal["launches"] == {"cal_prng": chain, "cal_prng_gather": chain,
                               "cal_vpu": chain}
    assert doc["round_launches"] == {"fused_round": 2 * chain,
                                     "mr_gather": chain,
                                     "fused_mr_round": chain}
    validate = _load("validate_artifacts", "tools/validate_artifacts.py")
    assert validate._has_provenance_keys(doc)
    assert doc["provenance"]["torch"] == torch.__version__
    assert "card" not in doc["provenance"]


def test_provenance_keys():
    doc = P.provenance(["x"], device="cpu")
    assert set(doc) == {"run_id", "schema", "git_commit", "captured", "argv",
                        "torch", "cuda", "python", "platform", "pid"}
    assert doc["argv"] == ["x"] and len(doc["run_id"]) == 12


def test_timed_chain_on_cpu():
    """Each chain starts from init and applies step(i, carry) for i in
    order; one warm-up chain and ``repeats`` timed ones."""
    seen = []

    def step(i, carry):
        seen.append((i, carry))
        return carry + 1
    chains = []
    assert timed_chain(step, 10, 3, "cpu", repeats=2, chains=chains) > 0
    assert seen == [(0, 10), (1, 11), (2, 12)] * 3
    assert chains == [3]
    # no graph on the CPU: the same chains on the host clock
    seen.clear()
    assert timed_chain(step, 10, 3, "cpu", repeats=2, graph=True) > 0
    assert seen == [(0, 10), (1, 11), (2, 12)] * 3


def test_bound_model_values():
    """The datasheet bounds to the last bit: the two round kernels'
    counted by pipe, the staged pass's and the sampler's as chip_smoke.py
    printed them before the model moved here, and each microkernel's."""
    n = 10_000_000
    assert R.round_bound(n, 1, 1) == (0.005032356298507463, "operations")
    assert R.mr_round_bound(n, 1) == (0.023881552238805972, "bytes")
    # under alive and cut words (CF256's fanout 2, the planes' fanout 1)
    # the function also reads both once: four arrays of 40,001,536 B
    assert R.mr_round_bound(n, 2, alive=True, cut=True) == \
        R.mr_round_bound(n, 1, alive=True, cut=True) == \
        (0.047763066268656715, "bytes")
    assert R.mr_round_work(n, 2, alive=True, cut=True).nbytes == \
        4 * 40_001_536 + 32 * 4
    assert R.mr_round_work(n, 2, alive=True).nbytes == \
        R.mr_round_work(n, 2, cut=True).nbytes == 3 * 40_001_536 + 32 * 4
    assert R.mr_gather_bound(n) == (0.04119561170149254, "operations")
    assert R.sampler_bound(n, 1) == (0.020895522388059702, "operations")
    words = 2448 * 128
    assert R.cal_work("cal_prng", 2448) == (154 * words, 123 * words,
                                            8 * words)
    assert R.cal_work("cal_prng_gather", 2448) == (186 * words, 123 * words,
                                                   8 * words)
    assert R.cal_work("cal_vpu", 2448) == (512 * words, 0, 8 * words)
    for name in ("cal_prng", "cal_prng_gather", "cal_vpu"):
        alu, fma, nbytes = R.cal_work(name, 2448)
        assert R.cal_bound(name, 2448) == (
            max(alu, fma, nbytes * R.INT32_OPS_PER_S / R.HBM_BYTES_PER_S)
            / R.INT32_OPS_PER_S * 1e3, "operations")


def _philox_word_ops(counters=tuple(("w", ("q", q), 0, 0)
                                   for q in range(8))):
    """(wide products, xors) that a thread's Philox calls with these
    counters need (default: a word's 8 calls, (w, q, 0, 0)): the calls'
    dataflow as expression trees, each distinct node that depends on the
    thread's own word "w" counted once (the compiler shares the rest), a
    node of q, constants and the keys alone being one per warp."""
    products, xors = set(), set()

    def has_w(e):
        return e == "w" or (isinstance(e, tuple)
                            and any(has_w(x) for x in e[1:]))

    def mulhilo(m, x):
        if x == 0:
            return 0, 0
        node = ("mul", m, x)
        if has_w(node):
            products.add(node)
        return ("hi", node), ("lo", node)

    def xor(*args):
        args = tuple(sorted((a for a in args if a != 0), key=repr))
        node = ("xor",) + args
        if has_w(node):
            xors.add(node)
        return node

    for c0, c1, c2, c3 in counters:
        for r in range(10):
            k0, k1 = ("k0", r), ("k1", r)
            hi0, lo0 = mulhilo("M0", c0)
            hi1, lo1 = mulhilo("M1", c2)
            c0, c1, c2, c3 = xor(hi1, c1, k0), lo1, xor(hi0, c3, k1), lo0
    return len(products), len(xors)


def test_microkernel_counts_follow_the_function():
    """CAL_PHILOX_PRODUCTS and CAL_PHILOX_XORS are what the dataflow of
    a word's 8 Philox calls needs, and an OR of n + 1 words takes n / 2
    three-input ops."""
    assert _philox_word_ops() == (R.CAL_PHILOX_PRODUCTS, R.CAL_PHILOX_XORS)
    assert (R.CAL_PHILOX_PRODUCTS, R.CAL_PHILOX_XORS) == (123, 138)
    assert R.CAL_ALU_OPS["cal_prng"] - R.CAL_PHILOX_XORS == 32 // 2
    assert R.CAL_ALU_OPS["cal_prng_gather"] - R.CAL_PHILOX_XORS \
        == 32 + 32 // 2
    assert R.CAL_ALU_OPS["cal_vpu"] == CAL.VPU_CHAIN * 2


def test_kernel_floors_price_the_bound_counts():
    """The calibrated floor is the largest of the bound's counts at the
    calibrated rates: Philox calls, other operations, bytes."""
    cal = {"prng_words_per_s": 1e12, "vpu_alu_per_s": 1e13}
    floors = R.kernel_floors(10_000_000, cal, 3e12)
    for name, work in (("fused_round", R.round_work(10**7, 1, 1)),
                       ("fused_mr_round", R.mr_round_work(10**7, 1)),
                       ("sampler", R.sampler_work(10**7, 1))):
        calls, _, _, ops, nbytes = work
        comp = {"prng": calls * 4 / 1e12 * 1e3, "vpu": ops / 1e13 * 1e3,
                "hbm": nbytes / 3e12 * 1e3}
        assert floors[name]["floor_components_ms"] == pytest.approx(comp)
        assert floors[name]["floor_ms"] == max(comp.values())
        assert floors[name]["floor_by"] == max(comp, key=comp.get)
        assert floors[name]["bound_ms"] == R._bound_of(work)[0]


# The two round kernels' ALU-pipe work beside Philox, op by op, as the
# function needs it (csrc/fused_round.cu, csrc/fused_mr_round.cu).
PULL_OPS = ("lane m = rb & 127", "amount (rb >> 7) - p",
            "funnel-shift rotate of rot[m] by the amount",
            "OR-in under 1 << p")
WORD_OPS = ("phantom compare", "phantom select", "popcount")
MR_PULL_OPS = ("lane m = rb & 127", "staged address m * rows + r",
               "OR-in")
MR_WORD_OPS = ("phantom compare", "phantom select")
# the per-rumor counts: a thread's 128 / 8 words, added a pair at a time
# into bit-sliced counters wide enough for 16, each counter then
# transposed once across the warp and popcounted
MR_THREAD_WORDS = 128 // 8
MR_COUNT_BITS = MR_THREAD_WORDS.bit_length()
MR_PAIR_OPS = (("three-input xor", "majority")
               + ("carry AND", "carry xor") * (MR_COUNT_BITS - 1))
MR_COUNTER_OPS = (("funnel shift", "select", "three-input op") * 5
                  + ("popcount", "shift-add"))


@pytest.mark.parametrize("calls", [1, 2, 8, 16])
def test_philox_pipe_ops_follow_the_dataflow(calls):
    """``philox_pipe_ops`` is what the dataflow of ``calls`` calls with
    counters (w, q, 0, 0) needs; a lane shift's call (j, f, 1, 0) needs
    what one of them needs."""
    assert R.philox_pipe_ops(calls) == _philox_word_ops(
        tuple(("w", ("q", q), 0, 0) for q in range(calls)))
    assert R.philox_pipe_ops(1) == _philox_word_ops(
        (("w", ("f", calls), 1, 0),))


@pytest.mark.parametrize("fanout,sharing", [(1, 1), (2, 1), (1, 2), (2, 2),
                                            (3, 1)])
def test_round_kernel_counts_follow_the_function(fanout, sharing):
    """The redesigned round kernels' counts by pipe: Philox from the
    dataflow (a word's calls share counters), the 128 lane shifts of every
    draw, the other ALU work op by op, each input byte read and each
    output byte written once."""
    n = 4096 * 24 - 37
    words = FR.n_rows(n) * 128
    draws = fanout * 32 // sharing
    products, xors = _philox_word_ops(
        tuple(("w", ("q", q), 0, 0) for q in range(draws // 4)))
    s_products, s_xors = _philox_word_ops((("w", ("f", 0), 1, 0),))
    other = words * (draws * sharing * len(PULL_OPS) + len(WORD_OPS))
    assert R.round_work(n, fanout, sharing) == R.Work(
        words * draws // 4 + 128, words * xors + 128 * s_xors + other,
        words * products + 128 * s_products, other, 2 * words * 4 + 4)
    words = MR.mr_rows(n) * 128
    products, xors = _philox_word_ops(
        tuple(("w", ("q", q), 0, 0) for q in range(-(-fanout // 4))))
    per_word = (len(MR_WORD_OPS) + len(MR_PAIR_OPS) / 2
                + MR_COUNT_BITS * len(MR_COUNTER_OPS) / MR_THREAD_WORDS)
    other = words * (fanout * len(MR_PULL_OPS) + per_word)
    assert R.mr_round_work(n, fanout) == R.Work(
        words * -(-fanout // 4) + 128 * fanout,
        words * xors + 128 * fanout * s_xors + other,
        words * products + 128 * fanout * s_products, other,
        2 * words * 4 + 32 * 4)
    # the bound is the busier pipe against the bytes
    for work, bound in ((R.round_work(n, fanout, sharing),
                         R.round_bound(n, fanout, sharing)),
                        (R.mr_round_work(n, fanout),
                         R.mr_round_bound(n, fanout))):
        assert bound == R._bound(max(work.alu, work.fma), work.nbytes)


SASS = """
\tFunction : _ZN45_GLOBAL__N__x_12_calibrate_cu_y14cal_vpu_kernelEPjj
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0 */
                                                            /* 0x0 */
        /*0010*/                   SHF.R.U32.HI R3, RZ, 0x1, R2 ;
        /*0020*/                   UIADD3 UR4, UR5, 0x1, URZ ;
        /*0030*/                   LOP3.LUT R2, R2, UR4, R3, 0x3c, !PT ;
        /*0040*/              @!P0 IMAD.WIDE.U32 R4, R5, 0x4, R6 ;
        /*0048*/                   FOO R2, R2 ;
        /*0050*/                   EXIT ;
        /*0060*/                   BRA 0x60;
        /*0070*/                   NOP;
\tFunction : _ZN45_GLOBAL__N__x_12_calibrate_cu_y22cal_prng_gather_kernelILb1EEEvPjPKjjjm
        /*0000*/                   LOP3.LUT R2, R2, R3, RZ, 0xfc, !PT ;
        /*0010*/                   BRA 0x10;
\tFunction : _ZN45_GLOBAL__N__x_14_fused_round_cu_y18fused_round_kernelILi1ELi1ELb0ELb0ELb0EEEvNS_4ArgsE
        /*0000*/                   SHF.R.W.U32 R2, R3, R4, R3 ;
        /*0010*/                   LDS R3, [R5] ;
        /*0020*/                   SHFL.DOWN PT, R2, R2, 0x10, 0x1f ;
        /*0030*/                   BRA 0x40;
        /*0040*/                   EXIT ;
        /*0050*/                   BRA 0x50;
"""


def test_sass_counts_parse(monkeypatch):
    """The instruction count by pipe: the injected instantiation and
    NOPs left out, the closing self-branch subtracted, uniform
    instructions apart, predicated ones counted, an opcode in no pipe
    list reported."""
    monkeypatch.setattr(R, "subprocess", types.SimpleNamespace(
        run=lambda *a, **k: types.SimpleNamespace(stdout=SASS)))
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "/cuda/bin/nvcc")
    got = R.sass_counts("lib.so")
    assert set(got) == {"cal_vpu"}
    assert {k: got["cal_vpu"][k] for k in ("alu", "fma", "vector")} == \
        {"alu": 2, "fma": 1, "vector": 6}
    assert got["cal_vpu"]["opcodes"]["UIADD3"] == 1
    assert got["cal_vpu"]["unassigned"] == ["FOO"]
    # a round kernel's instantiation, by its own tags; a loop's branch
    # stays, the closing self-branch goes
    got = R.sass_counts("lib.so", R.ROUND_SASS_TAGS)
    assert set(got) == {"fused_round_f1_s1"}
    assert {k: got["fused_round_f1_s1"][k]
            for k in ("alu", "fma", "vector")} == \
        {"alu": 1, "fma": 0, "vector": 5}
    assert got["fused_round_f1_s1"]["unassigned"] == []


def test_one_build_per_source(monkeypatch):
    """build_all starts one nvcc for calibrate.cu's three entry points
    and loads each of them from that one build."""
    started, finished = [], []

    def start(k):
        started.append(k.source.name)
        return ("proc", k.name)

    def finish(k, s, t0):
        finished.append((k.name, s))
        k._fn = object()
        k.ptxas = f"ptxas of {k.name}" if s else ""

    monkeypatch.setattr(_kernels.Kernel, "start_build", start)
    monkeypatch.setattr(_kernels.Kernel, "finish_build", finish)
    cal = (_kernels.CAL_PRNG, _kernels.CAL_PRNG_GATHER, _kernels.CAL_VPU)
    saved = [(k._fn, k.ptxas) for k in _kernels.KERNELS]
    try:
        for k in _kernels.KERNELS:
            k._fn = None
        _kernels.build_all()
        assert sorted(started) == sorted({k.source.name
                                          for k in _kernels.KERNELS})
        assert len(started) == 5 and len(_kernels.KERNELS) == 7
        assert finished[[n for n, _ in finished].index("cal_prng")][1] \
            == ("proc", "cal_prng")
        assert [s for n, s in finished
                if n in ("cal_prng_gather", "cal_vpu")] == [None, None]
        assert {k.ptxas for k in cal} == {"ptxas of cal_prng"}
    finally:
        for k, (fn, ptxas) in zip(_kernels.KERNELS, saved):
            k._fn, k.ptxas = fn, ptxas
