"""PyTorch port of RADNet for NVIDIA GPUs.

Imports torch, numpy and the standard library only.  Entry points run on
the card unless the caller passes ``device="cpu"``.
"""
