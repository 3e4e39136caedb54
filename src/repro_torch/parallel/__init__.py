"""repro_torch.parallel — sharding rules and per-device byte accounting."""
