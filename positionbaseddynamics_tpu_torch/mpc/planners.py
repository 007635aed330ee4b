"""Sampling-based MPC planners: MPPI and CEM over batched XPBD rollouts —
the counterpart of ``positionbaseddynamics_tpu/mpc/planners.py``.

* :func:`make_sequence_cost` closes a scene (``ConstraintSet`` +
  ``StepConfig`` + control model + cost terms) into
  ``(state, controls) -> (cost, final state)``; the running costs add up
  step by step, no trajectory is kept.
* :func:`mppi_update` / :func:`cem_update` — one planner iteration over
  ``K`` sampled control sequences.
* :func:`make_mpc_controller` — receding-horizon controller: plan
  ``plan_iters`` updates, execute the first control, shift the nominal
  sequence.

JAX vmaps the sequence cost over the K samples; a kernel launch cannot be
vmapped, so here the K rollouts are a leading axis of the state: ``x``,
``v``, ``old_x`` and ``last_x`` are ``(K, N, 3)``, ``inv_mass`` stays
``(N,)`` and is shared; rigid bodies likewise carry ``(K, R, ...)`` fields
with ``inv_mass`` and ``inertia0`` shared, and step through the
``torch_rigid`` route. On the card a grid-cloth scene steps through
``make_step_fn``'s kernel route, one launch of the fused cloth substep
(``csrc/grid_cloth_step.cu``) per substep for all K rollouts; on the CPU
through the stencil route. JAX's ``lax.scan`` loops are Python loops.

JAX draws its noise from ``jax.random`` keys inside the updates; here the
updates draw from an explicit ``torch.Generator`` on the state's device,
or take the draw as an argument, so that a test can feed in JAX's.

MPPI follows the information-theoretic weighting exp(-(J-J*)/λ)
(Williams et al., standard form); CEM refits a diagonal Gaussian to the
elite fraction per iteration.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .._device import resolve_device
from ..solver.constraints import ConstraintSet
from ..solver.state import ParticleState, SimState
from ..solver.step import StepConfig, make_step_fn
from ..utils import telemetry

Tensor = torch.Tensor


@dataclass(frozen=True)
class MPPIConfig:
    horizon: int = 20
    num_samples: int = 128
    sigma: float = 1.0            # exploration std-dev (per control dim)
    temperature: float = 0.1      # λ in exp(-(J - J*)/λ)
    plan_iters: int = 2           # planner updates per environment step


@dataclass(frozen=True)
class CEMConfig:
    horizon: int = 20
    num_samples: int = 128
    elite_frac: float = 0.1
    init_sigma: float = 1.0
    min_sigma: float = 0.05
    plan_iters: int = 3


#: The rigid-body fields that differ between rollouts; ``inv_mass``,
#: ``inertia0``, ``x0`` and ``q0`` stay shared.
_RIGID_ROLLOUT_FIELDS = ("x", "v", "q", "omega", "old_x", "last_x", "old_q",
                         "last_q", "ext_force", "ext_torque")


def _expand_state(state: SimState, k: int) -> SimState:
    """``state`` of one scene as K identical rollouts: the particles' ``x``,
    ``v``, ``old_x`` and ``last_x``, the orientations' ``q``, ``omega``,
    ``old_q`` and ``last_q`` and the rigid bodies' per-rollout fields
    become real ``(K, ...)`` storage, written once here, since the kernel
    route reads contiguous planes; ``x0``, the inverse masses and the
    bodies' ``inertia0`` and ``q0`` stay shared."""
    p = state.particles

    def lead(a):
        return a.unsqueeze(0).expand(k, *a.shape).contiguous()

    particles = ParticleState(x=lead(p.x), v=lead(p.v), old_x=lead(p.old_x),
                              last_x=lead(p.last_x), x0=p.x0,
                              inv_mass=p.inv_mass)
    rigid = state.rigid
    if rigid is not None:
        rigid = dataclasses.replace(rigid, **{
            f: lead(getattr(rigid, f)) for f in _RIGID_ROLLOUT_FIELDS})
    ori = state.orientations
    if ori is not None:
        ori = dataclasses.replace(ori, **{
            f: lead(getattr(ori, f)) for f in ("q", "omega", "old_q",
                                               "last_q")})
    return dataclasses.replace(state, particles=particles, rigid=rigid,
                               orientations=ori)


def make_sequence_cost(cset: ConstraintSet, cfg: StepConfig, control_model,
                       running_cost: Optional[Callable] = None,
                       terminal_cost: Optional[Callable] = None,
                       pipeline=None, device=None):
    """Build ``seq_cost(state, controls) -> (cost, final_state)`` on
    ``device`` (None means CUDA). ``controls`` is ``(T, u)`` for one
    rollout, or ``(K, T, u)`` for K: a state of one scene is then expanded
    to K rollouts (:func:`_expand_state`), and a state of K rollouts is
    taken as it is. The cost is 0-d or ``(K,)``. The step function is
    built once, here, with the collision ``pipeline`` when given (its
    detection and contact solves run once for all K rollouts);
    ``seq_cost.step`` is it, and ``seq_cost.path`` its route.

    A call runs in the span ``pbd.plan.rollouts``; inside it the
    expansion in ``pbd.plan.expand``, each ``control_model.apply`` in
    ``pbd.plan.control``, each running and the terminal cost in
    ``pbd.plan.cost``, and each step in ``pbd.step``."""
    step_fn = make_step_fn(cset, cfg, device, pipeline=pipeline)

    @telemetry.traced("pbd.plan.rollouts")
    def seq_cost(state: SimState, controls: Tensor):
        x = state.particles.x
        if controls.dim() == 3 and x.dim() == 2:
            with telemetry.span("pbd.plan.expand"):
                state = _expand_state(state, controls.shape[0])
        acc = torch.zeros(controls.shape[:-2], dtype=torch.float32,
                          device=x.device)
        for t in range(controls.shape[-2]):
            u = controls[..., t, :]
            with telemetry.span("pbd.plan.control"):
                state = control_model.apply(state, u, cfg.dt)
            state = step_fn(state)
            if running_cost is not None:
                with telemetry.span("pbd.plan.cost"):
                    acc = acc + running_cost(state, u)
        if terminal_cost is not None:
            with telemetry.span("pbd.plan.cost"):
                acc = acc + terminal_cost(state)
        return acc, state

    seq_cost.step, seq_cost.path = step_fn, step_fn.path
    return seq_cost


# ---------------------------------------------------------------------------
# Planner iterations
# ---------------------------------------------------------------------------


def _normal(shape, like: Tensor, generator):
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=like.device)


@telemetry.traced("pbd.mppi.update")
def mppi_update(state, nominal: Tensor, seq_cost, mcfg: MPPIConfig,
                generator: Optional[torch.Generator] = None,
                eps: Optional[Tensor] = None):
    """One MPPI iteration: sample K perturbations, softmin-weight them.
    ``eps`` is the perturbation ``σ·N(0, 1)`` of shape ``(K,) +
    nominal.shape`` (JAX's ``eps``, ``planners.py:90``); when None it is
    drawn from ``generator`` on the state's device. Returns
    ``(new_nominal, costs (K,))``. Runs in the span ``pbd.mppi.update``,
    the softmin weights and their sum in ``pbd.mppi.weights``."""
    if eps is None:
        eps = mcfg.sigma * _normal((mcfg.num_samples,) + tuple(nominal.shape),
                                   nominal, generator)
    costs = seq_cost(state, nominal + eps)[0]
    with telemetry.span("pbd.mppi.weights"):
        beta = torch.min(costs)
        w = torch.exp(-(costs - beta) / mcfg.temperature)
        w = w / torch.clamp_min(torch.sum(w), 1e-12)
        return nominal + torch.tensordot(w, eps, dims=1), costs


@telemetry.traced("pbd.cem.update")
def cem_update(state, mean: Tensor, sigma: Tensor, seq_cost,
               ccfg: CEMConfig, generator: Optional[torch.Generator] = None,
               eps: Optional[Tensor] = None):
    """One CEM iteration: sample, select elites, refit a diagonal Gaussian.
    ``eps`` is the standard normal draw of shape ``(K,) + mean.shape``
    (JAX's ``eps``, ``planners.py:103``: samples are ``mean + sigma·eps``);
    when None it is drawn from ``generator`` on the state's device.
    Returns ``(mean, sigma, costs (K,))``. Runs in the span
    ``pbd.cem.update``, the elites' selection and refit in
    ``pbd.cem.refit``."""
    n_elite = max(1, int(ccfg.elite_frac * ccfg.num_samples))
    if eps is None:
        eps = _normal((ccfg.num_samples,) + tuple(mean.shape), mean,
                      generator)
    samples = mean + sigma * eps
    costs = seq_cost(state, samples)[0]
    with telemetry.span("pbd.cem.refit"):
        elite_idx = torch.topk(-costs, n_elite).indices
        elites = samples[elite_idx]
        mean = torch.mean(elites, dim=0)
        sigma = torch.clamp_min(torch.std(elites, dim=0, correction=0),
                                ccfg.min_sigma)
    return mean, sigma, costs


def plan_mppi(state, nominal, seq_cost, mcfg: MPPIConfig,
              generator: Optional[torch.Generator] = None,
              noise: Optional[Tensor] = None):
    """``plan_iters`` MPPI updates; ``noise[i]``, when given, is the
    ``eps`` of update i. Returns ``(nominal, best_cost)``."""
    best = None
    for i in range(mcfg.plan_iters):
        nominal, costs = mppi_update(
            state, nominal, seq_cost, mcfg, generator,
            None if noise is None else noise[i])
        best = torch.min(costs)
    return nominal, best


def plan_cem(state, mean, seq_cost, ccfg: CEMConfig,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Tensor] = None):
    """``plan_iters`` CEM updates from ``init_sigma``; ``noise[i]``, when
    given, is the ``eps`` of update i. Returns ``(mean, best_cost)``."""
    sigma = torch.full_like(mean, ccfg.init_sigma)
    best = None
    for i in range(ccfg.plan_iters):
        mean, sigma, costs = cem_update(
            state, mean, sigma, seq_cost, ccfg, generator,
            None if noise is None else noise[i])
        best = torch.min(costs)
    return mean, best


# ---------------------------------------------------------------------------
# Receding-horizon controller
# ---------------------------------------------------------------------------


def make_mpc_controller(cset: ConstraintSet, cfg: StepConfig, control_model,
                        running_cost=None, terminal_cost=None,
                        planner: str = "mppi", planner_cfg=None,
                        pipeline=None, device=None):
    """Receding-horizon MPC on ``device`` (None means CUDA): returns
    ``run(state, n_steps, generator=None, noise=None) -> (final_state,
    info)`` where ``info`` has the executed ``controls (n_steps, u)`` and
    each step's best planned ``cost (n_steps,)``. ``noise``, when given,
    is ``(n_steps, plan_iters, K, T, u)``: ``noise[s, i]`` is the ``eps``
    of update i at step s, as :func:`mppi_update` or :func:`cem_update`
    takes it. The nominal sequence warm-starts each step by a one-step
    shift (zero tail). A collision ``pipeline`` steps every rollout and
    the executed step."""
    if planner_cfg is None:
        planner_cfg = MPPIConfig() if planner == "mppi" else CEMConfig()
    dev = resolve_device(device)
    seq_cost = make_sequence_cost(cset, cfg, control_model, running_cost,
                                  terminal_cost, pipeline=pipeline,
                                  device=dev)
    u_dim = control_model.u_dim
    T = planner_cfg.horizon
    plan = plan_mppi if planner == "mppi" else plan_cem

    def run(state, n_steps: int,
            generator: Optional[torch.Generator] = None,
            noise: Optional[Tensor] = None):
        nominal = torch.zeros((T, u_dim), dtype=torch.float32, device=dev)
        controls, costs = [], []
        for s in range(n_steps):
            nominal, best = plan(state, nominal, seq_cost, planner_cfg,
                                 generator,
                                 None if noise is None else noise[s])
            u0 = nominal[0]
            state = seq_cost.step(control_model.apply(state, u0, cfg.dt))
            nominal = torch.cat([nominal[1:], torch.zeros_like(nominal[:1])])
            controls.append(u0)
            costs.append(best)
        return state, {"controls": torch.stack(controls),
                       "cost": torch.stack(costs)}

    return run
