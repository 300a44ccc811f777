"""The port's weak-isolation checker against the JAX package's.

The planted G0, G1a, G1b and G1c traces of ``tests/test_txn.py``, their
clean twins, the trace-integrity defects and the final-state LWW
cross-check go through both ``check_txn_trace``; the verdict dicts must
be equal (exact equality), and each planted anomaly must be flagged.
"""

import pytest

from gossip_tpu.runtime.txn_checker import check_txn_trace as jcheck
from gossip_tpu_torch.runtime.txn_checker import check_txn_trace


def _committed(tid, writes=(), reads=()):
    return {"id": tid, "status": "committed", "reads": list(reads),
            "writes": [{"key": k, "value": v, "ts": list(ts)}
                       for k, v, ts in writes]}


def _aborted(tid, key, value, ts):
    return {"id": tid, "status": "aborted", "reads": [],
            "writes": [{"key": key, "value": value, "ts": ts}]}


def _indeterminate(tid, key, value, ts):
    return {"id": tid, "status": "indeterminate", "reads": [],
            "writes": [{"key": key, "value": value, "ts": ts}]}


_LWW = [_committed(1, writes=[("x", 5, (1, 0))]),
        _committed(2, writes=[("x", 7, (2, 1))])]
_LEAK = [_committed(1, writes=[("x", 5, (1, 0))]),
         _aborted(2, "y", 99, None)]

# name: (trace, final reads or None, the anomaly it must flag or None)
TRACES = {
    "g0": ([_committed(1, writes=[("x", 10, (1, 0)), ("y", 11, (4, 0))]),
            _committed(2, writes=[("x", 20, (2, 1)), ("y", 21, (3, 1))])],
           None, "g0"),
    "g0_clean": ([_committed(1, writes=[("x", 10, (1, 0)),
                                        ("y", 11, (1, 0))]),
                  _committed(2, writes=[("x", 20, (2, 1)),
                                        ("y", 21, (2, 1))])], None, None),
    "g1a": ([_aborted(1, "x", 99, [1, 0]), _committed(2, reads=[["x", 99]])],
            None, "g1a"),
    "g1a_live": ([_aborted(1, "x", 99, None),
                  _committed(2, reads=[["x", 99]])], None, "g1a"),
    "g1a_indeterminate": ([_indeterminate(1, "x", 99, [1, 0]),
                           _committed(2, reads=[["x", 99]])], None, None),
    "g1b": ([_committed(1, writes=[("x", 10, (1, 0)), ("x", 12, (2, 0))]),
             _committed(2, reads=[["x", 10]])], None, "g1b"),
    "g1b_final_read": ([_committed(1, writes=[("x", 10, (1, 0)),
                                              ("x", 12, (2, 0))]),
                        _committed(2, reads=[["x", 12]])], None, None),
    "g1b_self_read": ([_committed(1, writes=[("x", 10, (1, 0)),
                                             ("x", 12, (2, 0))],
                                  reads=[["x", 10]])], None, None),
    "g1c": ([_committed(1, writes=[("x", 10, (1, 0)), ("y", 11, (2, 0))]),
             _committed(2, writes=[("y", 21, (1, 1))], reads=[["x", 10]])],
            None, "g1c"),
    "g1c_ordered": ([_committed(1, writes=[("x", 10, (1, 0)),
                                           ("y", 11, (2, 0))]),
                     _committed(2, writes=[("y", 21, (3, 1))],
                                reads=[["x", 10]])], None, None),
    "duplicate_value": ([_committed(1, writes=[("x", 5, (1, 0))]),
                         _committed(2, writes=[("y", 5, (2, 1))])],
                        None, "defects"),
    "ts_collision": ([_committed(1, writes=[("x", 5, (1, 0))]),
                      _committed(2, writes=[("x", 6, (1, 0))])],
                     None, "defects"),
    "converged": (_LWW, {"n0": {"x": 7}, "n1": {"x": 7}}, None),
    "stale": (_LWW, {"n0": {"x": 5}, "n1": {"x": 5}}, "converged"),
    "split": (_LWW, {"n0": {"x": 7}, "n1": {"x": 5}}, "converged"),
    "indeterminate_won": (
        _LWW + [_indeterminate(3, "x", 9, None)],
        {"n0": {"x": 9}, "n1": {"x": 9}}, None),
    "aborted_leak": (_LEAK, {"n0": {"x": 5, "y": 99},
                             "n1": {"x": 5, "y": 99}}, "converged"),
    "no_leak": (_LEAK, {"n0": {"x": 5, "y": None},
                        "n1": {"x": 5, "y": None}}, None),
}


@pytest.mark.parametrize("name", TRACES)
def test_verdict_is_the_references(name):
    trace, final, flagged = TRACES[name]
    got = check_txn_trace(trace, final_reads=final)
    assert got == jcheck(trace, final_reads=final)
    assert got["ok"] is (flagged is None)
    if flagged == "converged":
        assert got["converged"] is False
    elif flagged is not None:
        assert got[flagged]
