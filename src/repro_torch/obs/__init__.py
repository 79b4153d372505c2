"""repro_torch.obs — ground truth for the recall check (``probe``), the
injectable clock (``clock``) and the metrics registry (``metrics``)."""
