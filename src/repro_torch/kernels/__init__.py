"""Hand-written CUDA kernels for Hopper (`csrc/`), their plain PyTorch
versions, the oracles (`ref`) and the public wrappers (`ops`)."""
