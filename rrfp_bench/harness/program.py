"""Drive the program under test, ``repro_torch``'s actor trainer, for one run.

One call of ``repro_torch.launch.train.train_actor`` with the flags the
traffic file names is both the set-up and the window.  Its weights come
from :mod:`rrfp_bench.harness.weights` through ``init_params``; its own
step hook timestamps every step.  The first two steps are set-up: the
first compiles and warms every shape the cell uses, and both are the steps
the reference follows (two, so that the reference takes less time than the
window).  The window starts when the second has ended and closes after the
first step that ends ``seconds`` later (a traced run: after its traced
steps); the hook then raises, which ends the call.

What the program hands out is read, not recomputed: each step's loss from
the ``TrainRun`` the call is filling (found on the stack by its type), the
first gradient as the optimizer gets it (``make_host_update``'s update is
wrapped to read its arguments at step 0), and the parameters it trained,
which are the benchmark's own modules.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import torch

from rrfp_bench.harness import manifest, weights
from rrfp_bench.harness.trace import Tracer
from rrfp_bench.reference.train import Readings, slice_norms, to_host

#: the program's ``--steps``: never reached, it sets the learning-rate
#: schedule (warm-up over 20 steps, cosine over this many)
STEPS_BOUND = 100_000
#: steps before the window: the warm-up, and the steps compared
SETUP_STEPS = 2


class _WindowClosed(Exception):
    pass


@dataclasses.dataclass
class ProgramRun:
    readings: Readings
    setup_s: float
    #: host-clock seconds of each window step, in order
    window_steps: list[float]
    window_s: float
    peak_bytes: int
    trace: dict | None


def program_config(c: dict, cfg=None):
    """The program's own config of ``c["arch"]`` (cut to ``num_layers``, in
    the dtype ``c`` states: the program takes any model dtype), checked
    against the benchmark's numbers by ``c``'s family; ``cfg`` replaces it
    (tests at reduced widths pass theirs)."""
    from repro_torch.configs import registry

    if cfg is None:
        cfg = registry.get_arch(c["arch"])
        if c["num_layers"] < cfg.num_layers:
            cfg = registry.cut_depth(c["arch"], c["num_layers"])
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, c["dtype"]))
    bad = manifest.family(c).check_program(c, cfg)
    if bad:
        raise SystemExit(f"the program's config of {c['arch']} is not the "
                         f"benchmark's (program, benchmark): {bad}")
    return cfg


def program_args(c: dict, traffic: dict, seed: int, device: str):
    from repro_torch.launch import train

    if traffic["runtime"] != "actor":
        raise SystemExit(f"the harness runs train_actor alone, not runtime "
                         f"{traffic['runtime']!r}")
    argv = ["--device", device, "--arch", c["arch"], "--full-size",
            "--runtime", traffic["runtime"],
            "--stages", str(traffic["stages"]),
            "--microbatches", str(traffic["microbatches"]),
            "--mb-rows", str(traffic["mb_rows"]),
            "--seq", str(traffic["seq"]), "--hint", traffic["hint"],
            "--w-defer-cap", str(traffic["w_defer_cap"]),
            "--steps", str(STEPS_BOUND), "--seed", str(seed),
            "--lr", repr(c["train"]["lr"])]
    if traffic["split_backward"]:
        argv.append("--split-backward")
    return train.parser().parse_args(argv)


def _stage_layers(counts) -> list[list[int]]:
    """Global layer of each stage slot (-1: a disabled slot)."""
    out, g = [], 0
    l_max = int(max(counts))
    for n in counts:
        out.append([g + i if i < int(n) else -1 for i in range(l_max)])
        g += int(n)
    return out


class _Loader:
    """``init_params`` for the program: the benchmark's weights copied into
    the modules the program allocates.  A slot's parameter of another
    layer kind (the program keeps the union of its kinds in every slot) or
    of a disabled slot is zero, and the program never reads it."""

    def __init__(self, c: dict, seed: int):
        self.c, self.seed = c, seed
        self.specs = weights.leaves(c)
        self.layers = {lf.path: lf.layers for lf in self.specs}
        #: id(program parameter) -> leaf key, for the benchmark's leaves
        self.keys: dict[int, str] = {}
        #: leaf key -> program parameter
        self.params: dict[str, torch.Tensor] = {}

    def _fill(self, p, ours: dict, path: str, g: int | None, name: str):
        if path not in self.layers:
            raise SystemExit(f"program parameter {name}: the benchmark has "
                             f"no weight {path!r}")
        layers = self.layers[path]
        if layers is not None and g not in layers:
            p.zero_()
            return
        t = ours[path] if layers is None else ours[path][layers.index(g)]
        if t.dtype != p.dtype or t.shape != p.shape:
            raise SystemExit(f"program parameter {name} {p.dtype} "
                             f"{tuple(p.shape)}: the benchmark's weight is "
                             f"{t.dtype} {tuple(t.shape)}")
        p.copy_(t)
        key = weights.leaf_key(path, g)
        self.keys[id(p)] = key
        self.params[key] = p

    @torch.no_grad()
    def __call__(self, model, device):
        ours = weights.draw_all(self.c, self.seed, device)
        stages = []
        for s, slots in enumerate(_stage_layers(model.counts)):
            sp = model.init_stage_params(s, seed=None, device=device)
            for name, p in sp.named_parameters():
                _, i, path = name.split(".", 2)
                g = slots[int(i)]
                self._fill(p, ours, path, g if g >= 0 else None, name)
            stages.append(sp)
        io = model.init_io_params(seed=None, device=device)
        for name, p in io.named_parameters():
            self._fill(p, ours, name, None, name)
        del ours
        return stages, io

    @torch.no_grad()
    def change_norms(self, device) -> dict[str, float]:
        """Norm of each leaf slice's change since the seed's draw."""
        out = {}
        for i, lf in enumerate(self.specs):
            start = weights.draw(lf, i, self.seed, device)
            now = (self.params[lf.path] if lf.layers is None else
                   torch.stack([self.params[weights.leaf_key(lf.path, g)]
                                for g in lf.layers]))
            out.update(slice_norms(lf, now.float() - start.float()))
            del start, now
        return to_host(out)

    def grad_norms(self, params, grads) -> dict[str, float]:
        norms = {}
        for p, g in zip(params, grads):
            key = self.keys.get(id(p))
            if key is None:
                continue
            norms[key] = (torch.zeros((), device=p.device) if g is None else
                          torch.linalg.vector_norm(g, dtype=torch.float32))
        return to_host(norms)


def _train_run(train_mod):
    """The ``TrainRun`` the running ``train_actor`` fills: the first local
    of that type on the stack above the step hook."""
    frame = sys._getframe(2)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, train_mod.TrainRun):
                return value
        frame = frame.f_back
    raise RuntimeError("no TrainRun on the stack of the step hook: the "
                       "program's per-step losses cannot be read")


def run(c: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
        device: str, t_start: float, cfg=None,
        window: bool = True) -> ProgramRun:
    """One run of the program: set-up, then the window (none when
    ``window`` is false: the compared steps alone)."""
    from repro_torch.launch import train

    cfg = program_config(c, cfg)
    args = program_args(c, traffic, seed, device)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    loader = _Loader(c, seed)
    losses: list[float] = []
    grads: dict = {}
    state = {"change": None, "t0": None, "setup_s": None, "last": None}
    times: list[float] = []
    tracer = Tracer(traffic["trace_steps"]) if trace else None
    make_update = train.make_host_update

    def wrapped_make(opt_cfg):
        update = make_update(opt_cfg)

        def apply_update(params, grad_list, m, v, step):
            if step == 0 and not grads:
                grads.update(loader.grad_norms(params, grad_list))
            return update(params, grad_list, m, v, step)

        return apply_update

    def hook(step):
        if cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        if step < SETUP_STEPS:
            losses.append(_train_run(train).losses[-1])
            if step < SETUP_STEPS - 1:
                return
            state["change"] = loader.change_norms(dev)
            if not window:
                raise _WindowClosed
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            if tracer is not None:
                tracer.start()
            state["t0"] = state["last"] = time.perf_counter()
            state["setup_s"] = state["t0"] - t_start
            return
        times.append(now - state["last"])
        state["last"] = now
        if tracer is not None:
            if tracer.step(now):
                raise _WindowClosed
        elif now - state["t0"] >= seconds:
            raise _WindowClosed

    train.make_host_update = wrapped_make
    try:
        train.train_actor(args, cfg=cfg, init_params=loader, step_hook=hook)
        raise RuntimeError(f"the program ran its {STEPS_BOUND} steps and "
                           f"the window never closed")
    except _WindowClosed:
        pass
    finally:
        train.make_host_update = make_update
        if tracer is not None:
            tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    window_s = (state["last"] - state["t0"]) if times else 0.0
    readings = Readings(losses, dict(grads), state["change"])
    loader.params.clear()
    del loader
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return ProgramRun(readings, state["setup_s"] or 0.0, times, window_s,
                      peak, tracer.result() if tracer is not None else None)
