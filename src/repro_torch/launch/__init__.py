"""repro_torch.launch — drivers."""
