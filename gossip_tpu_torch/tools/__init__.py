"""Measurement tools of the port (``python -m gossip_tpu_torch.tools.*``)."""
