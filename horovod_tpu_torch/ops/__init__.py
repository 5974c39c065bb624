"""The port's operators: the hand-written Hopper kernels and their
plain PyTorch versions."""
