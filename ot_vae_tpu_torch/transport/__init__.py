"""Transport operators and the LatentTransport callback (counterpart:
``ot_vae_tpu/transport``). Slice 3 carries the discrete operator; the
Gaussian and GMM operators follow with the OT core (ROADMAP)."""
from ot_vae_tpu_torch.transport.base import TransportOperator
from ot_vae_tpu_torch.transport.callback import LatentTransport
from ot_vae_tpu_torch.transport.discrete import DiscreteTransport, DiscreteTransportState

__all__ = ["TransportOperator", "DiscreteTransport", "DiscreteTransportState",
           "LatentTransport"]
