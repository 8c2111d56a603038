"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""
from ot_vae_tpu_torch.ops.attention import (
    attention_packed,
    attention_packed_backward,
    attention_packed_backward_reference,
    attention_packed_reference,
    fused_attention_packed,
)

__all__ = ["attention_packed", "attention_packed_reference", "attention_packed_backward",
           "attention_packed_backward_reference", "fused_attention_packed"]
