"""Runtimes: the XLA engine's run loops (``simulator``), the go-native
event-driven parity backend (``gonative``, its C++ core ``native_sim``),
and the Maelstrom protocol node, harness, router and txn checker.

Importing this package imports nothing: the protocol node (spawned as one
OS process per cluster node) and the harness import neither torch nor
numpy, so they start at once; the simulator is imported by name.
"""
