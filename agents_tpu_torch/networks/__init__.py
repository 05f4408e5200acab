from agents_tpu_torch.networks.actor_distribution_network import (
    ActorDistributionModule, DeterministicActorModule,
    make_actor_distribution_network, make_deterministic_actor_network,
    make_sac_actor_network)
from agents_tpu_torch.networks.encoding_network import (EncoderModule,
                                                        make_encoding_network)
from agents_tpu_torch.networks.lstm_networks import (
    ActorDistributionRnnModule, LSTMEncoder, QRnnModule,
    RecurrentDuelingQModule, ValueRnnModule,
    make_actor_distribution_rnn_network, make_q_rnn_network,
    make_recurrent_dueling_q_network, make_value_rnn_network)
from agents_tpu_torch.networks.network import Network
from agents_tpu_torch.networks.projection_networks import (
    CategoricalProjection, NormalProjection, TanhNormalProjection,
    default_projection)
from agents_tpu_torch.networks.qtopt_networks import (GraspQModule,
                                                      make_grasp_q_network)
from agents_tpu_torch.networks.q_network import (CategoricalQModule,
                                                 DuelingQModule, QModule,
                                                 make_categorical_q_network,
                                                 make_q_network)
from agents_tpu_torch.networks.sequential import (BiasLayer, NestMapModule,
                                                  SequentialModule,
                                                  inner_reshape,
                                                  mask_splitter, sequential)
from agents_tpu_torch.networks.value_network import (CriticModule,
                                                     ValueModule,
                                                     make_critic_network,
                                                     make_value_network)

__all__ = ["ActorDistributionModule", "ActorDistributionRnnModule",
           "BiasLayer", "CategoricalProjection",
           "CategoricalQModule", "CriticModule", "DeterministicActorModule",
           "DuelingQModule",
           "EncoderModule", "GraspQModule", "LSTMEncoder", "Network", "NormalProjection",
           "QModule", "QRnnModule", "RecurrentDuelingQModule", "ValueRnnModule",
           "TanhNormalProjection", "ValueModule", "default_projection",
           "make_actor_distribution_network",
           "make_actor_distribution_rnn_network", "make_categorical_q_network",
           "make_critic_network", "make_deterministic_actor_network",
           "make_encoding_network", "make_grasp_q_network", "make_q_network", "make_q_rnn_network",
           "make_recurrent_dueling_q_network", "make_sac_actor_network",
           "make_value_network", "make_value_rnn_network", "NestMapModule",
           "SequentialModule", "inner_reshape", "mask_splitter",
           "sequential"]
