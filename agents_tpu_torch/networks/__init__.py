from agents_tpu_torch.networks.encoding_network import EncoderModule
from agents_tpu_torch.networks.network import Network
from agents_tpu_torch.networks.q_network import (CategoricalQModule,
                                                 DuelingQModule, QModule,
                                                 make_categorical_q_network,
                                                 make_q_network)

__all__ = ["CategoricalQModule", "DuelingQModule", "EncoderModule", "Network",
           "QModule", "make_categorical_q_network", "make_q_network"]
