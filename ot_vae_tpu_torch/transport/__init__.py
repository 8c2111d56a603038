"""Transport operators and the LatentTransport callback (counterpart:
``ot_vae_tpu/transport``): the Gaussian, GMM and discrete operators. The
per-class callback arrives with slice 4c (ROADMAP)."""
from ot_vae_tpu_torch.transport.base import OperatorState, TransportOperator
from ot_vae_tpu_torch.transport.callback import LatentTransport
from ot_vae_tpu_torch.transport.discrete import DiscreteTransport, DiscreteTransportState
from ot_vae_tpu_torch.transport.gaussian import GaussianTransport, GaussianTransportState
from ot_vae_tpu_torch.transport.gmm import GMMTransport, GMMTransportState

__all__ = ["TransportOperator", "OperatorState", "GaussianTransport",
           "GaussianTransportState", "GMMTransport", "GMMTransportState",
           "DiscreteTransport", "DiscreteTransportState", "LatentTransport"]
