"""PyTorch and CUDA port of ``ot_vae_tpu`` for NVIDIA Hopper GPUs.

Slice 1 serves the FFHQ128 CNN VAE (networks, the Gaussian prior, the
inference transforms, the VAE and its ``InferenceEngine``); slice 2 trains
it (``trainer``, ``metrics``, ``data``, checkpoints). Attention runs through
hand-written CUDA kernels for its forward and backward (``ops/csrc``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
