"""The LM stack's models on PyTorch: parameter templates (`params`), the
shared transformer layers (`layers`), the MoE layer whose token routing runs
on the radix-partition kernels (`moe`) and the model assembly (`model`)."""
