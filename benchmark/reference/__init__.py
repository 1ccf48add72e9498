"""Plain PyTorch reference of PLAID search, independent of the program.

It reads an index directory in next-plaid's documented on-disk format and
computes, in f32 with TF32 off, what a search over it must return. It
imports numpy and torch only: nothing of nextplaid_tpu_torch, nothing of
the JAX package.
"""
