from agents_tpu_torch.networks.encoding_network import EncoderModule
from agents_tpu_torch.networks.network import Network
from agents_tpu_torch.networks.q_network import QModule, make_q_network

__all__ = ["EncoderModule", "Network", "QModule", "make_q_network"]
