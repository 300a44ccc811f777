"""gossip_tpu_torch: the gossip simulator on PyTorch and CUDA.

The port of the JAX package ``gossip_tpu`` to an NVIDIA H100.  It imports
``torch`` and ``numpy`` only, never ``jax`` or ``gossip_tpu``; its tests
hold it against the JAX package.  This slice runs the flagship route:
single-rumor pull gossip on the implicit complete graph, one hand-written
CUDA kernel per round (``csrc/fused_round.cu``).

Layout:
  - :mod:`gossip_tpu_torch.config`           the run configuration
  - :mod:`gossip_tpu_torch.ops.philox`       the round's random stream
  - :mod:`gossip_tpu_torch.ops.fused_round`  the round, its plain version,
    the state and the run loops
  - :mod:`gossip_tpu_torch.ops._kernels`     build, binding and launch
  - :mod:`gossip_tpu_torch.backend`          ``run_simulation``
  - :mod:`gossip_tpu_torch.cli`              ``python -m gossip_tpu_torch``
  - :mod:`gossip_tpu_torch.bench`            the node-rounds/s line
"""

from gossip_tpu_torch.config import (  # noqa: F401
    FaultConfig, ProtocolConfig, RunConfig, TopologyConfig)
