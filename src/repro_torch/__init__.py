"""PyTorch/CUDA port of the BST accelerator's single-chip read and write paths.

A sibling of the JAX package ``repro``: it imports torch and numpy, never
JAX and nothing of ``repro``.  The tensors' device decides whether a descent
launches a hand-written Hopper kernel (CUDA) or runs its plain PyTorch
version (CPU).
"""
