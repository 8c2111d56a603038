"""PyTorch and CUDA port of ``ot_vae_tpu`` for NVIDIA Hopper GPUs.

Slice 1 serves the FFHQ128 CNN VAE: networks, the Gaussian prior, the
inference transforms, the VAE and its ``InferenceEngine``, with the packed
attention forward as a hand-written CUDA kernel (``ops/csrc``). Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
