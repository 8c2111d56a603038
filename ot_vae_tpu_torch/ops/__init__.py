"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""
from ot_vae_tpu_torch.ops.attention import (
    attention_bhtc,
    attention_bhtc_backward,
    attention_bhtc_backward_reference,
    attention_bhtc_reference,
    attention_block,
    attention_block_backward,
    attention_block_backward_reference,
    attention_block_reference,
    attention_bthd,
    attention_bthd_backward,
    attention_bthd_backward_reference,
    attention_bthd_reference,
    attention_packed,
    attention_packed_backward,
    attention_packed_backward_reference,
    attention_packed_reference,
    fused_attention,
    fused_attention_block,
    fused_attention_bthd,
    fused_attention_bthd_dropout,
    fused_attention_packed,
)
from ot_vae_tpu_torch.ops.sinkhorn import (
    sinkhorn_log_auto,
    sinkhorn_log_kernel,
    sinkhorn_log_kernel_reference,
)
from ot_vae_tpu_torch.ops.w2 import sinkhorn_log

__all__ = ["attention_packed", "attention_packed_reference", "attention_packed_backward",
           "attention_packed_backward_reference", "fused_attention_packed",
           "attention_bthd", "attention_bthd_reference", "attention_bhtc",
           "attention_bhtc_reference", "attention_bthd_backward",
           "attention_bthd_backward_reference", "attention_bhtc_backward",
           "attention_bhtc_backward_reference", "fused_attention_bthd",
           "fused_attention_bthd_dropout", "fused_attention", "attention_block",
           "attention_block_reference", "attention_block_backward",
           "attention_block_backward_reference", "fused_attention_block",
           "sinkhorn_log_auto", "sinkhorn_log_kernel", "sinkhorn_log_kernel_reference",
           "sinkhorn_log"]
