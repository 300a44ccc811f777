"""Node-dimension sharding over ``torch.distributed``: the process group
(:mod:`~gossip_tpu_torch.parallel.group`), the dense SI drivers
(:mod:`~gossip_tpu_torch.parallel.sharded`) and the bit-packed pull /
anti-entropy drivers (:mod:`~gossip_tpu_torch.parallel.sharded_packed`)."""
