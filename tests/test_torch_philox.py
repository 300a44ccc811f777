"""The port's Philox4x32-10 and the fused round's random stream
(gossip_tpu_torch/ops/philox.py), on the CPU.

The plain torch Philox is held against Random123's published known
answers and against an independent numpy model in uint64 arithmetic
(exact: a product of two 32-bit words is below 2^64).  The layouts of
both streams, the single-rumor round's and the multi-rumor round's
(draws of word w, the lane shifts, the round key), are checked against
the same numpy model, bitwise.
"""

import numpy as np
import pytest
import torch

from gossip_tpu_torch.ops import fused_mr_round as MR
from gossip_tpu_torch.ops import fused_round as FR
from gossip_tpu_torch.ops import philox

M32 = np.uint64(0xFFFFFFFF)


def numpy_philox(ctr, key):
    """Philox4x32-10 on uint64 arrays holding 32-bit words."""
    c = [np.asarray(x, np.uint64) for x in ctr]
    k0, k1 = (np.uint64(x) for x in key)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & M32
            k1 = (k1 + np.uint64(0xBB67AE85)) & M32
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & M32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & M32]
    return c


# Random123's kat_vectors for philox4x32 with 10 rounds:
# counter (4 words), key (2 words) -> output (4 words)
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KNOWN_ANSWERS)
def test_known_answer(ctr, key, want):
    got = philox.philox4x32_10(*(torch.tensor(c) for c in ctr), *key)
    assert tuple(int(x) for x in got) == want
    assert tuple(int(x) for x in numpy_philox(ctr, key)) == want


def test_matches_numpy_uint64_model():
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2**32, size=(4, 4096), dtype=np.uint64)
    for key in [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF),
                tuple(int(k) for k in rng.integers(0, 2**32, size=2))]:
        got = philox.philox4x32_10(
            *(torch.from_numpy(c.astype(np.int64)) for c in ctr), *key)
        want = numpy_philox(ctr, key)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)


@pytest.mark.parametrize("seed,round_", [(0, 0), (7, 3), (-5, 2**31 + 9)])
def test_round_key(seed, round_):
    k0, k1 = philox.round_key(seed, round_)
    # k0 has the bits of the TPU path's wrapping int32 product
    wrapped = (np.array([seed], np.int64).astype(np.int32)
               * np.int32(1000003))
    assert k0 == int(wrapped.view(np.uint32)[0])
    assert k1 == round_ & 0xFFFFFFFF
    assert philox.round_key(seed, round_, salt=0x5D0)[1] == \
        (round_ & 0xFFFFFFFF) ^ 0x5D0


@pytest.mark.parametrize("fanout,sharing", [(1, 1), (2, 1), (1, 2),
                                            (2, 2)])
def test_stream_layout(fanout, sharing):
    """draw d of word w = i*128 + j is Philox(ctr=(w, d>>2, 0, 0))[d & 3];
    the shift word of lane j is Philox(ctr=(j, 0, 1, 0))[0]; the bits come
    in the reference's inject layout."""
    rows, seed, round_ = 8, 11, 4
    k0, k1 = philox.round_key(seed, round_)
    sbits, rbits = FR.draw_round_bits(seed, round_, rows, fanout, sharing,
                                      device="cpu")
    draws = fanout * 32 // sharing
    assert sbits.shape == (8, 128) and sbits.dtype == torch.int32
    assert rbits.shape == (draws, rows, 128) and rbits.dtype == torch.int32
    sb = sbits.numpy().view(np.uint32)
    rb = rbits.numpy().view(np.uint32)
    assert not sb[1:].any()
    lanes = np.arange(128, dtype=np.uint64)
    np.testing.assert_array_equal(
        sb[0], numpy_philox((lanes, 0, 1, 0), (k0, k1))[0])
    words = np.arange(rows * 128, dtype=np.uint64)
    for d in range(draws):
        want = numpy_philox((words, d >> 2, 0, 0), (k0, k1))[d & 3]
        np.testing.assert_array_equal(rb[d].reshape(-1), want)


@pytest.mark.parametrize("fanout", [1, 2, 5])
def test_multirumor_stream_layout(fanout):
    """The multi-rumor stream: key (seed * 1000003, round ^ 0x5D0); the
    shift word of lane j for fanout draw f is Philox(ctr=(j, f, 1, 0))[0];
    draw f of word w is Philox(ctr=(w, f>>2, 0, 0))[f & 3]; the bits come
    in the reference's inject layout (sbits [F, 8, 128], rbits
    [F, rows, 128])."""
    rows, seed, round_ = 8, 11, 4
    wrapped = np.array([seed], np.int64).astype(np.int32) * np.int32(1000003)
    key = (int(wrapped.view(np.uint32)[0]), round_ ^ 0x5D0)
    assert philox.round_key(seed, round_, philox.MR_SALT) == key
    sbits, rbits = MR.draw_mr_round_bits(seed, round_, rows, fanout,
                                         device="cpu")
    assert sbits.shape == (fanout, 8, 128) and sbits.dtype == torch.int32
    assert rbits.shape == (fanout, rows, 128) and rbits.dtype == torch.int32
    sb = sbits.numpy().view(np.uint32)
    rb = rbits.numpy().view(np.uint32)
    assert not sb[:, 1:].any()
    lanes = np.arange(128, dtype=np.uint64)
    words = np.arange(rows * 128, dtype=np.uint64)
    for f in range(fanout):
        np.testing.assert_array_equal(
            sb[f, 0], numpy_philox((lanes, f, 1, 0), key)[0])
        np.testing.assert_array_equal(
            rb[f].reshape(-1), numpy_philox((words, f >> 2, 0, 0), key)[f & 3])
    np.testing.assert_array_equal(
        philox.shift_words(*key, fanout).numpy().astype(np.uint64),
        sb[:, 0].astype(np.uint64))


@pytest.mark.parametrize("draws", [1, 2, 3, 4, 5])
def test_four_draws_share_one_philox_call(draws):
    """The invariant the value kernel's operand path draws by: draws 0-3
    of word w are the four words of the one Philox call at counter
    (w, 0, 0, 0), in order, so ``draw_words`` at 1 to 4 draws is that
    call's first words; draw 4 starts the call at (w, 1, 0, 0)."""
    rows, key = 8, philox.round_key(5, 3, philox.MR_SALT)
    got = philox.draw_words(*key, rows, draws).numpy()
    words = torch.arange(rows * 128, dtype=torch.int64)
    first = torch.stack(philox.philox4x32_10(words, 0, 0, 0, *key)).numpy()
    assert got.shape == (draws, rows, 128)
    np.testing.assert_array_equal(got[:4].reshape(min(draws, 4), -1),
                                  first[:draws])
    if draws > 4:
        second = philox.philox4x32_10(words, 1, 0, 0, *key)
        np.testing.assert_array_equal(got[4].reshape(-1),
                                      second[0].numpy())
        assert not np.array_equal(got[4], got[0])
