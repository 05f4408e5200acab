from agents_tpu_torch.networks.actor_distribution_network import (
    ActorDistributionModule, make_actor_distribution_network,
    make_sac_actor_network)
from agents_tpu_torch.networks.encoding_network import EncoderModule
from agents_tpu_torch.networks.network import Network
from agents_tpu_torch.networks.projection_networks import (
    CategoricalProjection, NormalProjection, TanhNormalProjection,
    default_projection)
from agents_tpu_torch.networks.q_network import (CategoricalQModule,
                                                 DuelingQModule, QModule,
                                                 make_categorical_q_network,
                                                 make_q_network)
from agents_tpu_torch.networks.value_network import (CriticModule,
                                                     ValueModule,
                                                     make_critic_network,
                                                     make_value_network)

__all__ = ["ActorDistributionModule", "CategoricalProjection",
           "CategoricalQModule", "CriticModule", "DuelingQModule",
           "EncoderModule", "Network", "NormalProjection", "QModule",
           "TanhNormalProjection", "ValueModule", "default_projection",
           "make_actor_distribution_network", "make_categorical_q_network",
           "make_critic_network", "make_q_network", "make_sac_actor_network",
           "make_value_network"]
