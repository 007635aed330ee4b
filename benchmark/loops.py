"""The one traffic generator: it reads a mix's parameters
(``benchmark/traffic/<mix>.json``) and drives the program's public entry
points in closed loops, each period waiting for the one before.

* ``"loop": "sim"``: interactive simulation. Frames of
  ``steps_per_frame`` calls of ``make_step_fn``'s step, then the
  positions copied to the host, which is what a renderer reads: into one
  page-locked buffer kept for the run, as a renderer keeps its own. The seed
  draws the initial velocities (``|v| ≤ initial_speed``, 0 at static
  particles) on the card, for ``rollouts`` scenes stepped together.
* ``"loop": "mpc"``: receding-horizon MPPI, one control period at a time
  as ``make_mpc_controller.run`` runs it: ``mppi_update`` over
  ``make_sequence_cost`` with the period's perturbations drawn from the
  seed on the card, one step of the real scene under the first command,
  the nominal shifted with a zero tail and the command copied to the
  host.

Both save, at periods drawn from the seed, what the judge needs: the
inputs a period started from and the outputs it produced; an MPPI period
also the final positions of a sample of its rollouts, which the terminal
cost keeps as the update hands it them.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext

import numpy as np
import torch

from benchmark.controls import HandleVelocity

MASK64 = (1 << 64) - 1


def seed64(seed: int, salt: int) -> int:
    """A 64-bit seed of ``seed`` and a stream number ``salt``."""
    ss = np.random.SeedSequence([seed & MASK64, salt])
    return int(ss.generate_state(1, np.uint64)[0])


def schedule(seed: int, gap: int, cap: int, salt: int) -> set:
    """Indices of the periods whose outputs the judge checks: period 0,
    then gaps drawn uniformly from ``[1, 2·gap)``, ``cap`` in all."""
    rng = np.random.default_rng(seed64(seed, salt))
    gaps = rng.integers(1, max(2, 2 * gap), size=max(0, cap - 1))
    return {0, *np.cumsum(gaps).tolist()}


def rollout_sample(seed: int, index: int, k: int, r: int) -> list:
    """``r`` of ``k`` rollouts whose costs the judge checks at period
    ``index``: the first and the last, and the rest drawn from the
    seed."""
    rng = np.random.default_rng([seed64(seed, 9), index])
    rest = rng.choice(np.arange(1, k - 1), size=max(0, min(r, k) - 2),
                      replace=False)
    return sorted({0, k - 1, *rest.tolist()})


def _label(on: bool, name: str):
    if not on:
        return nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def handle_target(config: dict, ref_kind) -> np.ndarray:
    """The MPPI target: the handle's rest centre plus the configuration's
    ``target_offset``, float64; both sides are handed it."""
    x0 = ref_kind.points(config).astype(np.float64)
    return (x0[ref_kind.handle(config)].mean(0)
            + np.asarray(config["mpc"]["target_offset"], np.float64))


def _step_config(config: dict):
    from positionbaseddynamics_tpu_torch.solver import StepConfig

    st = config["step"]
    return StepConfig(dt=st["dt"], substeps=st["substeps"],
                      max_iterations=st["max_iterations"],
                      gravity=tuple(st["gravity"]),
                      solver_mode=st["solver_mode"])


def _clone(p, *fields):
    return {f: getattr(p, f).clone() for f in fields}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """What one run of a loop produced: the host seconds of each period,
    the window's length, the saved samples, the steps of the scene, and
    the substep work done, as ``(n_batch, substeps, iterations)``
    entries."""

    def __init__(self):
        self.periods = []
        self.seconds = 0.0
        self.samples = []
        self.work = []
        self.steps = 0
        self.step_host_s = []


class SimLoop:
    kind = "sim"

    def __init__(self, config, mix, state, cset, seed, device, ref_kind):
        from positionbaseddynamics_tpu_torch.solver import make_step_fn

        self.mix, self.device, self.seed = mix, device, seed
        self.cfg = _step_config(config)
        self.fn = make_step_fn(cset, self.cfg, device)
        self.route = self.fn.path
        self.spf = int(mix["steps_per_frame"])
        k = int(mix.get("rollouts", 1))
        p = state.particles
        gen = torch.Generator(device=device)
        gen.manual_seed(seed64(seed, 1))
        shape = (p.x.shape if k == 1 else (k, *p.x.shape))
        v = torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0
        v = v * (float(mix["initial_speed"]) / 3.0 ** 0.5)
        v = torch.where((p.inv_mass > 0)[:, None], v, torch.zeros_like(v))
        if k > 1:
            def lead(a):
                return a.unsqueeze(0).expand(k, *a.shape).contiguous()
            p = dataclasses.replace(p, x=lead(p.x), old_x=lead(p.old_x),
                                    last_x=lead(p.last_x))
        self.state0 = dataclasses.replace(
            state, particles=dataclasses.replace(p, v=v))
        self.n_batch, self.iterations = k, self.cfg.max_iterations
        self.host = torch.empty(shape, dtype=torch.float32,
                                pin_memory=device.type == "cuda")

    def warm(self):
        s = self.state0
        for _ in range(int(self.mix["warm_frames"])):
            for _ in range(self.spf):
                s = self.fn(s)
            self.host.copy_(s.particles.x)

    def run(self, seconds=None, count=None, check=None, label=False,
            time_steps=False) -> Window:
        """Frames from the initial state until ``seconds`` have passed or
        ``count`` frames are done; the frames in ``check`` saved for the judge;
        ``label`` marks the host's phases for the profiler;
        ``time_steps`` keeps the host seconds of each step call."""
        out, s, fn = Window(), self.state0, self.fn
        check = check or set()
        _sync(self.device)
        t_start = time.perf_counter()
        i = 0
        with _label(label, "bench.window"):
            while True:
                if i in check:
                    before = _clone(s.particles, "x", "v")
                t0 = time.perf_counter()
                with _label(label, "bench.frame"):
                    for _ in range(self.spf):
                        with _label(label, "bench.step"):
                            if time_steps:
                                a = time.perf_counter()
                                s = fn(s)
                                out.step_host_s.append(time.perf_counter() - a)
                            else:
                                s = fn(s)
                    with _label(label, "bench.to_host"):
                        self.host.copy_(s.particles.x)
                t1 = time.perf_counter()
                out.periods.append(t1 - t0)
                if i in check:
                    out.samples.append({
                        "index": i, "start": i == 0, "in": before,
                        "out": {"x": self.host.clone(),
                                **_clone(s.particles, "v", "old_x",
                                         "last_x")}})
                i += 1
                done = (t1 - t_start >= seconds if count is None
                        else i >= count)
                if done:
                    break
        out.seconds = t1 - t_start
        out.steps = self.spf * i
        out.work = [(self.n_batch, self.cfg.substeps * self.spf * i,
                     self.iterations)]
        return out

    def e2e(self, w: Window) -> dict:
        p95 = float(np.percentile(w.periods, 95))
        return {"sim_steps_per_s": len(w.periods) * self.spf / w.seconds,
                "sim_frame_p95_ms": p95 * 1e3}


class MpcLoop:
    kind = "mpc"

    def __init__(self, config, mix, state, cset, seed, device, ref_kind):
        from positionbaseddynamics_tpu_torch import mpc

        if mix["planner"] != "mppi":
            raise ValueError(f"planner {mix['planner']!r}: this loop runs "
                             "mppi")
        self.mix, self.device, self.seed = mix, device, seed
        self.cfg = _step_config(config)
        self.control = HandleVelocity(tuple(ref_kind.handle(config)),
                                      float(config["mpc"]["max_speed"]))
        target = mpc.particle_target(ref_kind.tracked(config),
                                     handle_target(config, ref_kind))
        self.keep, self.kept = None, None

        def terminal(state):
            # the final positions of the rollouts in ``keep``, for the judge
            if self.keep is not None:
                self.kept = state.particles.x.index_select(0, self.keep)
            return target(state)

        self.seq_cost = mpc.make_sequence_cost(
            cset, self.cfg, self.control,
            running_cost=mpc.control_effort(float(mix["control_effort"])),
            terminal_cost=terminal, device=device)
        self.route = self.seq_cost.path
        self.mcfg = mpc.MPPIConfig(
            horizon=int(mix["horizon"]), num_samples=int(mix["num_samples"]),
            sigma=float(mix["sigma"]), temperature=float(mix["temperature"]))
        self.update = mpc.mppi_update
        self.state0 = state
        self.n_batch = self.mcfg.num_samples
        self.iterations = self.cfg.max_iterations

    def _eps(self, gen):
        m = self.mcfg
        return m.sigma * torch.randn((m.num_samples, m.horizon, 3),
                                     generator=gen, dtype=torch.float32,
                                     device=self.device)

    def warm(self):
        self.run(count=int(self.mix["warm_periods"]), salt=3)

    def run(self, seconds=None, count=None, check=None, label=False,
            salt=2) -> Window:
        """Control periods from the initial state and a zero nominal,
        as :meth:`SimLoop.run` runs frames; ``salt`` picks the stream of
        perturbations."""
        out, s = Window(), self.state0
        check = check or set()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed64(self.seed, salt))
        nominal = torch.zeros((self.mcfg.horizon, 3), dtype=torch.float32,
                              device=self.device)
        _sync(self.device)
        t_start = time.perf_counter()
        i = 0
        with _label(label, "bench.window"):
            while True:
                t0 = time.perf_counter()
                with _label(label, "bench.period"):
                    eps = self._eps(gen)
                    if i in check:
                        before = {"nominal": nominal.clone(),
                                  "eps": eps.clone(),
                                  **_clone(s.particles, "x", "v")}
                        sub = rollout_sample(
                            self.seed, i, self.mcfg.num_samples,
                            int(self.mix["check"]["rollouts"]))
                        self.keep = torch.as_tensor(sub, device=self.device)
                    with _label(label, "bench.mppi_update"):
                        new, costs = self.update(s, nominal, self.seq_cost,
                                                 self.mcfg, eps=eps)
                    self.keep = None
                    u0 = new[0]
                    with _label(label, "bench.execute"):
                        s = self.seq_cost.step(
                            self.control.apply(s, u0, self.cfg.dt))
                    nominal = torch.cat([new[1:], torch.zeros_like(new[:1])])
                    with _label(label, "bench.to_host"):
                        u0.cpu()
                t1 = time.perf_counter()
                out.periods.append(t1 - t0)
                if i in check:
                    out.samples.append({
                        "index": i, "start": i == 0, "in": before,
                        "rollouts": sub,
                        "out": {"nominal": new.clone(), "costs": costs.clone(),
                                "finals": self.kept,
                                **_clone(s.particles, "x", "v", "old_x",
                                         "last_x")}})
                    self.kept = None
                i += 1
                done = (t1 - t_start >= seconds if count is None
                        else i >= count)
                if done:
                    break
        out.seconds = t1 - t_start
        out.steps = i
        sub = self.cfg.substeps
        out.work = [(self.n_batch, sub * self.mcfg.horizon * i,
                     self.iterations), (1, sub * i, self.iterations)]
        return out

    def e2e(self, w: Window) -> dict:
        p95 = float(np.percentile(w.periods, 95))
        return {"plan_updates_per_s": len(w.periods) / w.seconds,
                "plan_update_p95_ms": p95 * 1e3}


LOOPS = {"sim": SimLoop, "mpc": MpcLoop}
