"""PyTorch / CUDA port of the LLMBridge serving stack for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro`` (the reference) module by
module.  It imports torch and numpy only: nothing of JAX and nothing of
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit request they raise.
"""
