"""PyTorch/CUDA port of the SWARM reproduction (``repro``), slice by
slice.  It imports torch, numpy and the standard library only — never
jax and nothing of ``repro``.  Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
