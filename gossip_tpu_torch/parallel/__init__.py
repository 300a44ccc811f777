"""Node-dimension sharding over ``torch.distributed``: the process group
(:mod:`~gossip_tpu_torch.parallel.group`), the dense SI drivers
(:mod:`~gossip_tpu_torch.parallel.sharded`), the bit-packed pull /
anti-entropy drivers (:mod:`~gossip_tpu_torch.parallel.sharded_packed`),
the sparse all_to_all and halo ppermute exchanges
(:mod:`~gossip_tpu_torch.parallel.sharded_sparse`,
:mod:`~gossip_tpu_torch.parallel.halo`), the sharded SWIM, rumor and
payload drivers; rumor-plane sharding of the fused round
(:mod:`~gossip_tpu_torch.parallel.sharded_fused`); and the hybrid meshes
and multi-host bootstrap (:mod:`~gossip_tpu_torch.parallel.multislice`)."""
