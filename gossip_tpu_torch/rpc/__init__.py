"""The serving layer: the admission batcher
(:mod:`gossip_tpu_torch.rpc.batcher`), the sidecar's handlers and their
gRPC transport (:mod:`gossip_tpu_torch.rpc.sidecar`) and the failover
router (:mod:`gossip_tpu_torch.rpc.router`).  The handlers and the
batcher run without ``grpc``; only the transport functions import it."""
