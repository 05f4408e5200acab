"""DQN / DDQN / D3QN agents, feed-forward Q networks.

Port of `DqnAgent`, `DdqnAgent`, `D3qnAgent` and `_ScheduledQPolicy` of
``agents_tpu/agents/dqn/dqn_agent.py``:
  - epsilon-greedy collect and greedy eval policies; the collect params are
    always {"q", "train_step"} (:105-118); with `boltzmann_temperature` the
    collect policy is a `BoltzmannPolicy` over the Q policy and its params
    the Q network (:100-103);
  - an `observation_and_action_constraint_splitter` maps observations to
    ``(network observation, mask)``: the policies become masked and the
    next state's max (DDQN: the online argmax) runs over the valid actions
    alone (:141-152);
  - action specs whose minimum is not 0 raise `ValueError`;
  - n-step TD targets through `to_n_step_transition`, whose discount already
    holds gamma^(N-1); the loss multiplies by gamma once more (:175);
  - boundary transitions masked, 1/N aggregation;
  - a periodic polyak target update that fires when
    ``train_step % period == 0`` after the increment.

A recurrent Q network (one with a `state_spec`, `lstm_networks`) trains on
``[B, T]`` sequences of `train_sequence_length` (`_sequence_loss`,
:196-230): the online and the target network each unroll once from a zero
carry with FIRST-step resets, TD pairs are the frames ``(t, t + 1)``,
frames whose step is LAST are masked, and the loss sums over time, then
averages over the batch. The next state's value is the masked max of the
target unroll (`_seq_next_best_q`, :188-194); DDQN's is the target unroll
at the argmax of the online one (:271-280).

The train step is host-int driven: `DqnAgentState.train_step` is a Python
int (the JAX package keeps a device int32), so the target-update branch
needs no device `where` over every parameter and no sync. The parameters
and optimizer moments are updated in place.

On a card, a feed-forward train step runs as one CUDA graph where one is
valid: the device is CUDA, every optimizer param group is `capturable`
(Adam's step count on the card), the agent has no `mesh`, the Q network
has no `state_spec`, and the step runs on the main thread. The first
step on a given online network, target network, optimizer (with its state
and hyperparameters) and input shape runs eagerly on a side stream, which
creates the optimizer's state; the next captures the loss forward, `torch.autograd.grad`, clipping and
the optimizer step, and every later step copies its batch into the
graph's input buffers, replays it, clones its outputs and runs the due
target update eagerly. Anywhere else (the CPU, a recurrent Q network,
data parallelism, a non-capturable optimizer, the trainer thread of the
asynchronous loop) the step runs eagerly, as above.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import weakref
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agents_tpu_torch.agents.agent import (APPLY_SPAN, GRAD_SPAN, LOSS_SPAN,
                                           Agent, apply_gradients,
                                           check_network_devices)
from agents_tpu_torch.policies.q_policy import QPolicy
from agents_tpu_torch.policies.wrappers import (BoltzmannPolicy,
                                                EpsilonGreedyPolicy,
                                                GreedyPolicy)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import common, nest_utils, profiling
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device

# The span of a train step's part that records nothing (a capture's).
_NO_SPAN = contextlib.nullcontext()


class _ScheduledQPolicy(QPolicy):
  """QPolicy whose params are {"q": network, "train_step": int} so an
  epsilon schedule can read the step at act time."""

  def q_values(self, params, time_step, state=()):
    return super().q_values(params["q"], time_step, state)


@dataclasses.dataclass(frozen=True)
class DqnAgentState:
  q_network: nn.Module
  target_q_network: nn.Module
  optimizer: torch.optim.Optimizer
  train_step: int


@dataclasses.dataclass(frozen=True)
class DqnLossExtra:
  td_loss: torch.Tensor
  td_error: torch.Tensor


class DqnAgent(Agent):
  """Vanilla DQN (max over the target network).

  Args:
    q_network: the online Q network (an nn.Module on `device`); `init`
      trains this module and copies it for the target.
    optimizer_fn: builds the optimizer from the online parameters, e.g.
      ``lambda p: torch.optim.Adam(p, lr=1e-3)`` for ``optax.adam(1e-3)``.
    device: where the networks live; "cuda" unless the caller asks for
      "cpu".
  """

  def __init__(self, time_step_spec, action_spec, q_network: nn.Module,
               optimizer_fn: Callable, epsilon_greedy=0.1,
               n_step_update: int = 1,
               boltzmann_temperature: Optional[float] = None,
               observation_and_action_constraint_splitter=None,
               td_errors_loss_fn: Callable = common.element_wise_huber_loss,
               gamma: float = 1.0, reward_scale_factor: float = 1.0,
               target_update_tau: float = 1.0,
               target_update_period: int = 1,
               gradient_clipping: Optional[float] = None,
               train_sequence_length: Optional[int] = None, device="cuda"):
    self.device = resolve_device(device)
    for s in nest_utils.flatten(action_spec, is_leaf=array_spec._is_spec):
      if int(np.asarray(s.minimum)) != 0:
        raise ValueError(
            f"DqnAgent action specs should have minimum of 0, got {s}")
    check_network_devices(self.device, q_network=q_network)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.q_network = q_network
    self.optimizer_fn = optimizer_fn
    self.epsilon_greedy = epsilon_greedy
    self.n_step_update = n_step_update
    self.td_errors_loss_fn = td_errors_loss_fn
    self.gamma = gamma
    self.reward_scale_factor = reward_scale_factor
    self.target_update_tau = target_update_tau
    self.target_update_period = target_update_period
    self.gradient_clipping = gradient_clipping
    self.train_sequence_length = train_sequence_length or n_step_update + 1

    splitter = observation_and_action_constraint_splitter
    self._q_policy = QPolicy(
        time_step_spec, action_spec, q_network,
        observation_and_action_constraint_splitter=splitter)
    self.policy = GreedyPolicy(self._q_policy)
    self._collect_carries_step = boltzmann_temperature is None
    if boltzmann_temperature is not None:
      self.collect_policy = BoltzmannPolicy(self._q_policy,
                                            boltzmann_temperature)
    else:
      eps = epsilon_greedy if callable(epsilon_greedy) \
          else lambda _: epsilon_greedy
      self.collect_policy = EpsilonGreedyPolicy(
          _ScheduledQPolicy(
              time_step_spec, action_spec, q_network,
              observation_and_action_constraint_splitter=splitter),
          lambda p: eps(p["train_step"]))
    # `train`'s CUDA graph, and the weak key (`_weak_key`) of the step
    # warmed up but not yet captured.
    self._train_graph: Optional[_TrainGraph] = None
    self._warmed_up = None

  def init(self) -> DqnAgentState:
    target = copy.deepcopy(self.q_network).requires_grad_(False)
    return DqnAgentState(
        q_network=self.q_network, target_q_network=target,
        optimizer=self.optimizer_fn(self.q_network.parameters()),
        train_step=0)

  def policy_params(self, agent_state):
    return agent_state.q_network

  def collect_policy_params(self, agent_state):
    if self._collect_carries_step:
      return {"q": agent_state.q_network,
              "train_step": agent_state.train_step}
    return agent_state.q_network

  def _next_best_q(self, agent_state, next_time_steps):
    """max_a Q_target(s', a) over the valid actions (:141-152)."""
    obs, mask = self._q_policy.split(next_time_steps.observation)
    q_next, _ = agent_state.target_q_network(obs, next_time_steps.step_type,
                                             ())
    if mask is not None:
      q_next = torch.where(mask, q_next, -1e9)
    return torch.max(q_next, dim=-1).values

  def _loss(self, q_network, agent_state, experience, weights=None):
    """experience: Trajectory [B, T=n_step+1], or [B, T] sequences for a
    recurrent Q network."""
    if self.q_network.state_spec:
      return self._sequence_loss(q_network, agent_state, experience, weights)
    transition = tj.to_n_step_transition(experience, gamma=self.gamma)
    time_steps = transition.time_step
    actions = transition.action_step.action
    next_time_steps = transition.next_time_step

    obs, _ = self._q_policy.split(time_steps.observation)
    q_all, _ = q_network(obs, time_steps.step_type, ())
    q_values = common.index_with_actions(q_all, actions)

    with torch.no_grad():
      next_q = self._next_best_q(agent_state, next_time_steps)
      rewards = self.reward_scale_factor * next_time_steps.reward
      discounts = self.gamma * next_time_steps.discount
      td_targets = rewards + discounts * next_q
    td_error = td_targets - q_values
    td_loss = self.td_errors_loss_fn(td_targets, q_values)

    valid_mask = (~time_steps.is_last()).to(torch.float32)
    td_error = valid_mask * td_error
    td_loss = valid_mask * td_loss

    loss = common.aggregate_losses(per_example_loss=td_loss,
                                   sample_weight=weights)
    return loss, DqnLossExtra(td_loss=td_loss, td_error=td_error)

  def _seq_next_best_q(self, q_all_online, target_all, action_mask):
    """The next states' values from the ``[B, T, A]`` unrolls: the masked
    max of the target network's."""
    del q_all_online
    if action_mask is not None:
      target_all = torch.where(action_mask, target_all, -1e9)
    return torch.max(target_all, dim=-1).values

  def _sequence_loss(self, q_network, agent_state, experience, weights=None):
    """TD over the adjacent frames of whole sequences (recurrent Q)."""
    obs, action_mask = self._q_policy.split(experience.observation)
    step_type = experience.step_type
    q_all, _ = q_network(obs, step_type, None)                # [B, T, A]
    q_taken = common.index_with_actions(q_all, experience.action)
    with torch.no_grad():
      target_all, _ = agent_state.target_q_network(obs, step_type, None)
      next_q = self._seq_next_best_q(q_all.detach(), target_all, action_mask)
      rewards = self.reward_scale_factor * experience.reward[:, :-1]
      discounts = self.gamma * experience.discount[:, :-1]
      td_targets = rewards + discounts * next_q[:, 1:]
    td_error = td_targets - q_taken[:, :-1]
    td_loss = self.td_errors_loss_fn(td_targets, q_taken[:, :-1])
    valid = (step_type[:, :-1] != ts.StepType.LAST).to(torch.float32)
    td_loss = td_loss * valid
    td_error = td_error * valid
    loss = common.aggregate_losses(per_example_loss=td_loss.sum(dim=1),
                                   sample_weight=weights)
    return loss, DqnLossExtra(td_loss=td_loss, td_error=td_error)

  def train(self, agent_state: DqnAgentState, experience,
            weights=None) -> Tuple[DqnAgentState, LossInfo]:
    if not self._graphable(agent_state):
      return self._train_eagerly(agent_state, experience, weights)
    key, signature = _graph_key(agent_state), _signature(experience, weights)
    graph = self._train_graph
    if graph is None or not graph.matches(key, signature):
      warm = _weak_key(key, signature)
      if warm != self._warmed_up:
        # The first step on these objects and shapes: eagerly, on a side
        # stream, as a capture requires; it creates the optimizer's state.
        self._warmed_up = warm
        return _on_side_stream(self.device, self._train_eagerly,
                               agent_state, experience, weights)
      graph = self._train_graph = _TrainGraph(key, signature)
      self._warmed_up = None
    return self._replay(graph, agent_state, experience, weights)

  def _graphable(self, agent_state) -> bool:
    """Whether a CUDA graph can hold this agent's train step. The step
    must also run on the main thread: a loop that trains on a thread of
    its own (`train/async_host_device_loop.py`) launches work from another
    thread meanwhile, which a capture cannot have."""
    return (self.device.type == "cuda" and self.mesh is None
            and not self.q_network.state_spec
            and threading.current_thread() is threading.main_thread()
            and all(group.get("capturable", False)
                    for group in agent_state.optimizer.param_groups))

  def _train_eagerly(self, agent_state, experience, weights=None):
    loss, extra = self._gradient_step(
        agent_state, experience, weights,
        spans=(LOSS_SPAN, GRAD_SPAN, APPLY_SPAN), update_target=True)
    profiling.count("agent.train_steps")
    new_state = dataclasses.replace(agent_state,
                                    train_step=agent_state.train_step + 1)
    return new_state, LossInfo(loss=loss, extra=extra)

  def _gradient_step(self, agent_state, experience, weights,
                     spans=(_NO_SPAN,) * 3, update_target=False):
    """The loss forward, its gradient and the optimizer step, each under
    its span of `spans`, then the due target update where `update_target`
    (a CUDA graph holds the rest; the target update is the host's).
    Returns (loss, extra), detached."""
    loss_span, grad_span, apply_span = spans
    q_network = agent_state.q_network
    with loss_span:
      loss, extra = self._loss(q_network, agent_state, experience, weights)
    with grad_span:
      params = list(q_network.parameters())
      grads = torch.autograd.grad(loss, params, allow_unused=True)
    with apply_span:
      apply_gradients([(grads, params, agent_state.optimizer)],
                      self.gradient_clipping, self.mesh)
      if update_target:
        self._update_target(agent_state, agent_state.train_step + 1)
    return loss.detach(), nest_utils.tree_map(torch.Tensor.detach, extra)

  def _update_target(self, agent_state, train_step):
    common.periodic_soft_update(
        train_step, self.target_update_period,
        agent_state.q_network.parameters(),
        agent_state.target_q_network.parameters(), self.target_update_tau)

  def _replay(self, graph: "_TrainGraph", agent_state, experience, weights):
    """One train step through `graph`, captured first if it is not yet:
    `agent.loss` stages the batch, `agent.grad` replays the graph, and
    `agent.apply` clones its outputs and runs the due target update."""
    with LOSS_SPAN:
      graph.stage(experience, weights)
    with GRAD_SPAN:
      if graph.graph is None:
        graph.capture(self.device,
                      lambda e, w: self._gradient_step(agent_state, e, w))
      graph.graph.replay()
    train_step = agent_state.train_step + 1
    with APPLY_SPAN:
      info = graph.results()
      self._update_target(agent_state, train_step)
    profiling.count("agent.graph_replays")
    profiling.count("agent.train_steps")
    return dataclasses.replace(agent_state, train_step=train_step), info


def _signature(experience, weights):
  """The inputs' structure, shapes, dtypes and devices."""
  return (type(experience), weights is None,
          tuple((x.shape, x.dtype, x.device)
                for x in nest_utils.flatten((experience, weights))))


def _graph_key(agent_state):
  """(the objects a graph reads, compared with `is`; the optimizer's
  hyperparameters, which a graph bakes in). The optimizer's `state` and
  `param_groups` are new objects after its `load_state_dict`."""
  optimizer = agent_state.optimizer
  objects = (agent_state.q_network, agent_state.target_q_network, optimizer,
             optimizer.state, optimizer.param_groups)
  hyperparameters = tuple(
      tuple((k, v) for k, v in group.items() if k != "params")
      for group in optimizer.param_groups)
  return objects, hyperparameters


def _weak_key(key, signature):
  """`key` and `signature` with no strong reference, for the slot that
  records a warm-up, so that a step on a state's copy (`Agent.loss`)
  keeps none of it: the networks and the optimizer by weak reference,
  equal while they live and are the same, the optimizer's `state` and
  `param_groups`, which take none, by id. A graph is only ever captured
  on a step's own objects."""
  (network, target, optimizer, state, groups), hyperparameters = key
  return (weakref.ref(network), weakref.ref(target), weakref.ref(optimizer),
          id(state), id(groups), hyperparameters, signature)


def _on_side_stream(device, fn, *args):
  """`fn(*args)` on a new side stream of `device` that starts after the
  current stream's work and which the current stream then waits for: the
  warm-up a CUDA graph capture needs."""
  current = torch.cuda.current_stream(device)
  side = torch.cuda.Stream(device)
  side.wait_stream(current)
  with torch.cuda.stream(side):
    out = fn(*args)
  current.wait_stream(side)
  return out


class _TrainGraph:
  """A train step captured as one CUDA graph, the static input buffers it
  reads and the output buffers it writes.

  It holds the objects it was captured on (`_graph_key`) by strong
  reference, so none of them can be freed and another take its place; a
  train step replays it only on those same objects and on inputs of the
  same `_signature`.
  """

  def __init__(self, key, signature):
    self.key, self.signature = key, signature
    self.graph = None                         # torch.cuda.CUDAGraph
    self.experience = self.weights = None     # static inputs
    self.loss = self.extra = None             # static outputs

  def matches(self, key, signature) -> bool:
    (objects, hyperparameters), (mine, my_hyperparameters) = key, self.key
    return (signature == self.signature
            and all(a is b for a, b in zip(objects, mine))
            and hyperparameters == my_hyperparameters)

  def stage(self, experience, weights) -> None:
    """Copy the inputs into the static buffers (made on the first call)."""
    if self.experience is None:
      self.experience = nest_utils.tree_map(torch.clone, experience)
      self.weights = None if weights is None else weights.clone()
      return
    for static, x in zip(nest_utils.flatten(self.experience),
                         nest_utils.flatten(experience)):
      static.copy_(x)
    if weights is not None:
      self.weights.copy_(weights)

  def capture(self, device, step) -> None:
    """Capture ``step(experience, weights) -> (loss, extra)`` on the static
    inputs, on `device`; the capture runs none of its work."""
    self.graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(self.graph):
      self.loss, self.extra = step(self.experience, self.weights)

  def results(self) -> LossInfo:
    """The last replay's outputs, cloned: the next replay overwrites the
    static buffers."""
    return LossInfo(loss=self.loss.clone(),
                    extra=nest_utils.tree_map(torch.clone, self.extra))


class DdqnAgent(DqnAgent):
  """Double DQN: online-network argmax, target-network evaluation."""

  def _next_best_q(self, agent_state, next_time_steps):
    obs, mask = self._q_policy.split(next_time_steps.observation)
    q_online, _ = agent_state.q_network(obs, next_time_steps.step_type, ())
    if mask is not None:
      q_online = torch.where(mask, q_online, -1e9)
    best = torch.argmax(q_online, dim=-1)
    q_target, _ = agent_state.target_q_network(obs, next_time_steps.step_type,
                                               ())
    return common.index_with_actions(q_target, best)

  def _seq_next_best_q(self, q_all_online, target_all, action_mask):
    """The target unroll at the online unroll's (masked) argmax; the
    online values come in detached."""
    if action_mask is not None:
      q_all_online = torch.where(action_mask, q_all_online, -1e9)
    best = torch.argmax(q_all_online, dim=-1)
    return common.index_with_actions(target_all, best)


# D3QN is Double DQN with a dueling Q network: build the agent with
# ``make_q_network(..., dueling=True)`` (the JAX package's D3qnAgent).
D3qnAgent = DdqnAgent
