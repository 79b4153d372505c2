"""repro_torch.obs — ground truth for the recall check."""
