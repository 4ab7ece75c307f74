"""Architecture configs: full-scale + CPU-reduced variants (configs.base)."""
