"""repro_torch.data — synthetic corpora (numpy, host side)."""
