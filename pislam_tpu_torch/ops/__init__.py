"""Tensor ops of the ORB frontend and their Hopper kernels."""
