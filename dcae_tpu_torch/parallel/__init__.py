"""Data-parallel deployment over torch.distributed (dp only)."""
