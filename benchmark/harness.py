"""One run of one cell: set-up (the program's scene build, its step or
planner, a warm-up of every shape the mix uses), then either the measured
window (``trace=False``: the cell's end-to-end metrics) or the traced
slices (``trace=True``: its per-layer metrics), then the judge.

The judge runs after the program's peak memory has been read and its
state freed, and is not counted in ``setup_s`` or the window.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from benchmark import judge, loops, spec, trace as trace_mod
from benchmark.reference.mppi import Planner
from benchmark.work import peaks

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "positionbaseddynamics_tpu"})


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, before the first dot, is JAX's,
    Flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Record:
    """What a traced run hands the per-layer readers: the cell's
    configuration and mix, the scene build's seconds, a sim loop's
    untraced slice (a :class:`loops.Window` with the host seconds of its
    step calls, or None) and those seconds, the trace and the traced
    slice."""

    def __init__(self, config, mix, scene_build_s, untraced, trace,
                 window):
        self.config, self.mix = config, mix
        self.kind, self.loop = config["kind"], mix["loop"]
        self.scene_build_s = scene_build_s
        self.untraced = untraced
        self.step_host_s = untraced.step_host_s if untraced else []
        self.trace, self.window = trace, window

    def least_seconds(self, kind: str) -> float:
        """The least time, at the card's published peaks, of the substep
        work of configuration kind ``kind`` in the traced slice; logs the
        peak that bounds each part of it."""
        work = spec.kind_module("work", kind)
        total = 0.0
        for n_batch, substeps, iterations in self.window.work:
            t, by = peaks.least_seconds(
                *work.substep(self.config, n_batch, iterations))
            log(f"roofline {kind}: {substeps} substeps at n_batch "
                f"{n_batch}, {iterations} iteration(s): least {t * 1e3!r} "
                f"ms a substep, bound by {by}")
            total += substeps * t
        return total


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float) -> dict:
    """The result of one run of cell ``name``; ``t_start`` is the
    process's start on the host clock, from which ``setup_s`` counts."""
    cell = spec.cell(bench, name)
    config, mix = spec.config_and_mix(bench, cell)
    ref_kind = spec.kind_module("reference", config["kind"])

    t0 = time.perf_counter()
    state, cset = spec.kind_module("scenes", config["kind"]).build(
        config, device)
    _sync(device)
    scene_build_s = time.perf_counter() - t0
    loop = make_loop(config, mix, state, cset, seed, device, ref_kind)
    del state, cset
    log(f"route: {cell['name']} steps through {loop.entry}, path "
        f"{loop.route!r} ({mix['loop']} loop)")
    loop.warm()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    out = {}
    if not trace:
        c = mix["check"]
        win = loop.run(seconds=seconds,
                       check=loops.schedule(seed, c["gap"], c["max"], 7))
        values = {"setup_s": setup_s, **loop.e2e(win)}
        wanted = spec.end_to_end(bench, name)
    else:
        c = mix["trace"]
        untraced = None
        if loop.kind == "sim" and "untraced_seconds" in c:
            untraced = loop.run(seconds=c["untraced_seconds"],
                                time_steps=True)
        elif loop.kind == "sim":
            untraced = loop.run(count=c["count"], time_steps=True)
        held = {}
        check = loops.schedule(seed, c["check_gap"], c["check_max"], 8)
        tr = trace_mod.profile(lambda: held.setdefault("w", loop.run(
            count=c["count"], check=check, label=True)))
        win = held["w"]
        rec = Record(config, mix, scene_build_s, untraced, tr, win)
        wanted = spec.per_layer(bench, name)
        values = {m["name"]: spec.reader(m["name"]).read(rec)
                  for m in wanted}
        out["breakdown"] = tr.breakdown()
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values.get(m["name"]) is not None}

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else device.type),
                "count": cell["chips"],
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else 0)}
    if trace:
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)

    samples, n_periods = win.samples, len(win.periods)
    del loop, win
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    correct, failed, checks = check_samples(config, mix, samples, device,
                                            torch.float32, ref_kind)
    saved = sorted(s["index"] for s in samples)
    log(f"judge: saved periods {saved} against the reference in "
        f"{time.perf_counter() - t0!r} s")
    return {"correct": correct, "attempted": n_periods, "failed": failed,
            "metrics": metrics, "device": dev_info, **out, "checks": checks}


def make_loop(config, mix, state, cset, seed, device, ref_kind):
    """The mix's loop over the built scene, stepped by the ``Drive`` of the
    configuration's kind where its ``benchmark/scenes/<kind>.py`` defines
    one, else by the loop's own (``make_step_fn``)."""
    drive = getattr(spec.kind_module("scenes", config["kind"]), "Drive", None)
    kw = {} if drive is None else {"drive": drive}
    return loops.LOOPS[mix["loop"]](config, mix, state, cset, seed, device,
                                    ref_kind, **kw)


def reference_for(config, mix, device, dtype, ref_kind):
    """The plain reference of the configuration: its scene, or for an
    ``mpc`` mix the MPPI period over it."""
    scene = ref_kind.scene(config, device, dtype)
    if mix["loop"] != "mpc":
        return scene
    return Planner(scene, ref_kind.handle(config), ref_kind.tracked(config),
                   loops.handle_target(config, ref_kind), mix,
                   float(config["mpc"]["max_speed"]),
                   float(config["step"]["dt"]))


def numbers(config, mix, samples, ref) -> list:
    if mix["loop"] == "mpc":
        return judge.mpc_numbers(ref, samples)
    return judge.sim_numbers(ref, samples, int(mix["steps_per_frame"]))


def check_samples(config, mix, samples, device, dtype, ref_kind):
    """``judge.verdict`` of the saved samples against the reference."""
    ref = reference_for(config, mix, device, dtype, ref_kind)
    with torch.no_grad():
        per_sample = numbers(config, mix, samples, ref)
    return judge.verdict(per_sample, config["limits"][mix["loop"]])

