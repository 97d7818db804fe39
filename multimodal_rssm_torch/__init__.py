"""PyTorch / CUDA port of the multimodal RSSM world model.

A second package beside the JAX one, which stays the reference it is held
against.  Plain tensor code is PyTorch; each TPU kernel of the JAX package
on a ported path becomes a hand-written Hopper kernel (``kernels/``).
"""
