"""PyTorch/CUDA port of the LMC system for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package imports nothing of
it, and keeps its module and public function names so that each counterpart
is easy to find. Entry points run on the CUDA card unless the caller passes
``device="cpu"``. See ROADMAP.md for what is ported so far.
"""
