"""PPO collect policy: emits the action distribution and the value
prediction in `policy_info`.

Port of ``agents_tpu/agents/ppo/ppo_policy.py`` (:22-61). `params` is
``{"actor": actor module, "value": value module, "normalizer": observation
normalizer state}``; the info field carries the collect-time distribution
object itself (a nest whose parameter tensors stack into the trajectory),
so the learner reads the old log-probabilities and KL terms from it.
`action` samples each leaf at the draw site "actor_noise", one draw per
leaf, as `ActorPolicy` does.
"""
from __future__ import annotations

from agents_tpu_torch.policies.actor_policy import ACTOR_NOISE_SITE
from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.utils import nest_utils


class PPOPolicy(Policy):
  """info = {"dist": <distribution nest>, "value_prediction": [B]}."""

  def __init__(self, time_step_spec, action_spec, actor_network,
               value_network, observation_normalizer=None, clip: bool = True):
    super().__init__(time_step_spec, action_spec,
                     state_spec=(actor_network.state_spec,
                                 value_network.state_spec),
                     clip=clip)
    self.actor_network = actor_network
    self.value_network = value_network
    self.observation_normalizer = observation_normalizer

  def _nets(self, params, time_step, state):
    obs = time_step.observation
    if self.observation_normalizer is not None:
      obs = self.observation_normalizer.normalize(params["normalizer"], obs)
    actor_state, value_state = state if isinstance(state, tuple) and len(
        state) == 2 else ((), ())
    dist, new_actor_state = params["actor"](obs, time_step.step_type,
                                            actor_state)
    value, new_value_state = params["value"](obs, time_step.step_type,
                                             value_state)
    return dist, value, (new_actor_state, new_value_state)

  def _action(self, params, time_step, state, draws):
    dist, value, new_state = self._nets(params, time_step, state)
    actions = nest_utils.tree_map(
        lambda d: d.sample(draws, site=ACTOR_NOISE_SITE), dist,
        is_leaf=lambda d: hasattr(d, "sample"))
    info = {"dist": dist, "value_prediction": value}
    return ps.PolicyStep(action=actions, state=new_state, info=info)

  def _distribution(self, params, time_step, state):
    dist, value, new_state = self._nets(params, time_step, state)
    return ps.PolicyStep(action=dist, state=new_state,
                         info={"dist": dist, "value_prediction": value})
