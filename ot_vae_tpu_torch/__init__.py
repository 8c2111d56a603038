"""PyTorch and CUDA port of ``ot_vae_tpu`` for NVIDIA Hopper GPUs.

Slice 1 serves the FFHQ128 CNN VAE (networks, the Gaussian prior, the
inference transforms, the VAE and its ``InferenceEngine``); slice 2 trains
it (``trainer``, ``metrics``, ``data``, checkpoints); slice 3 runs discrete
latent transport on MNIST32 (``distributions``, ``transport``, the
``AutoEncoder``, restoration serving); slice 4 the OT core and the Gaussian
and GMM latent transport; slices 6a and 6b serve and train the ViT VAEs;
slice 7 adds AutoDiffusion and DAD (the time-conditioned AutoEncoder, the
causal and KV-cached ViT, ``AutoRegressive``, ``CodebookPrior``); slice 8
the fused attention block. Attention runs through hand-written
CUDA kernels for its forward and backward, and the transport's entropic OT
through a hand-written log-domain Sinkhorn kernel (``ops/csrc``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
