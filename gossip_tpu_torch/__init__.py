"""gossip_tpu_torch: the gossip simulator on PyTorch and CUDA.

The port of the JAX package ``gossip_tpu`` to an NVIDIA H100.  It imports
``torch`` and ``numpy`` only, never ``jax`` or ``gossip_tpu``; its tests
hold it against the JAX package.  On one device it runs two engines: the
fused pull route, one hand-written CUDA kernel per round (one rumor,
``csrc/fused_round.cu``; up to 32, ``csrc/fused_mr_round.cu`` and the
staged route's ``csrc/mr_gather.cu``), and the threefry-keyed XLA engine
(every SI mode and topology, bitwise equal to the JAX package), whose
packed loop can draw its partners with ``csrc/sampler.cu``; the XLA
engine also runs the JAX package's fault programs (the nemesis: churn
events, partition windows, drop ramps), SWIM failure detection, rumor
mongering, the CRDT payloads (with the byzantine liar program), the
replicated logs and the LWW registers' txn workload.  Beside them, the
go-native backend (the reference node's event-driven model on a C++
core built with ``g++``), the Maelstrom runtime (protocol node,
harness, C++ router and txn checker) and the ``sweep`` of the five
BASELINE rows.  Its roofline
tool calibrates the card's rates with the microkernels of
``csrc/calibrate.cu`` and prices the round kernels' work with them.

Layout:
  - :mod:`gossip_tpu_torch.config`           the run configuration
  - :mod:`gossip_tpu_torch.ops.nemesis`      fault programs lowered to
    schedule tables, the per-round helpers, and the liar tables
  - :mod:`gossip_tpu_torch.ops.crdt`, ``logs``, ``registers``  the
    payloads' merges, injections, ground truth, and the liar transforms
    and defenses
  - :mod:`gossip_tpu_torch.ops.philox`       the kernels' random streams
  - :mod:`gossip_tpu_torch.ops.threefry`     ``jax.random``'s threefry
  - :mod:`gossip_tpu_torch.ops.fused_round`  the single-rumor round, its
    plain version, the state and the run loops
  - :mod:`gossip_tpu_torch.ops.fused_mr_round`  the multi-rumor round's
    two routes, their plain versions, the layout helpers and the loops
  - :mod:`gossip_tpu_torch.ops.sampling`, ``propagate``, ``bitpack``,
    ``fast_sampling``                        the XLA engine's operations
    and the sampling kernel's wrapper
  - :mod:`gossip_tpu_torch.topology.generators`  the graph families
  - :mod:`gossip_tpu_torch.models`           state, bool and packed rounds,
    SWIM (``swim``), rumor mongering (``rumor``), the CRDT, log and
    register rounds and loops (``crdt``, ``log``, ``register``)
  - :mod:`gossip_tpu_torch.runtime.simulator`  the bool rounds' and SWIM's
    loops
  - :mod:`gossip_tpu_torch.runtime.gonative`, ``native_sim``,
    :mod:`gossip_tpu_torch.native`  the go-native event simulator, its
    C++ core and the ``g++`` build
  - :mod:`gossip_tpu_torch.runtime.maelstrom_node`, ``maelstrom_harness``,
    ``native_router``, ``txn_checker``  the Maelstrom runtime (torch-free)
  - :mod:`gossip_tpu_torch.ops._kernels`     build, binding and launch
  - :mod:`gossip_tpu_torch.backend`          ``run_simulation`` and the
    serving wire (``request_to_args``, ``dispatch``)
  - :mod:`gossip_tpu_torch.rpc`              serving: the admission
    batcher, the sidecar's handlers and gRPC transport, the failover
    router
  - :mod:`gossip_tpu_torch.cli`              ``python -m gossip_tpu_torch``
  - :mod:`gossip_tpu_torch.bench`            the node-rounds/s line
  - :mod:`gossip_tpu_torch.ops.calibrate`    the calibration microkernels
  - :mod:`gossip_tpu_torch.tools.roofline`   floors, calibrated rates and
    the datasheet bound model
  - :mod:`gossip_tpu_torch.utils`            timing, provenance and curve
    files
"""

from gossip_tpu_torch.config import (  # noqa: F401
    ChurnConfig, FaultConfig, ProtocolConfig, RunConfig, TopologyConfig)
