"""PyTorch modules of the port (counterparts of gradtts_tpu.models)."""
