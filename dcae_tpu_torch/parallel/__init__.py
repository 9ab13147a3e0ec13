"""Data- and spatial-parallel deployment over torch.distributed."""
