"""The training driver: the program's adversarial train step
(``tasks.trainer.make_train_step(train_d=True)``) back to back over a
ring of batches made on the device in set-up, synchronised only at the
window's ends; its first steps, taken in set-up through the same call,
are what the reference follows.

What is compared (``gaps``, each against the cell's ``limits``), with
the plain float32 reference (``reference.trainer.Step``) on the same
weights and batches:

* ``loss1``: the larger relative gap of the first step's G total loss
  and D loss;
* ``grad_leaf``: the first step's gradient as Adam got it (its first
  moment over 1 - b1), by the worst leaf of G and D: the gap between the
  two norms over the reference's norm of that leaf or the median leaf's,
  whichever is larger;
* ``change_leaf``: the same of each leaf's change over the first
  ``check_steps`` steps.

Leaves whose reference gradient is under a thousandth of their net's
median leaf's (biases under an instance norm: nought to rounding) are
left out of both. Read and not compared: ``loss3``, the gap of every
loss of the first steps (one Adam step on nets this young moves D's
loss from ~5 to ~30, and rounding moves that by percents: the control
and the faults do not separate from it), and ``grad_diff``, the median
leaf's norm of the gradients' difference over the reference's."""


from __future__ import annotations

import gc
import time

import numpy as np
import torch

from lwg_bench import trace, traffic, weights
from lwg_bench.reference import body as ref_body
from lwg_bench.reference import geometry as G
from lwg_bench.reference import nets as N
from lwg_bench.reference import trainer as RT

NETS = ("G", "D")


def ring(mix: dict, seed: int, image_size: int, batch: int, device):
    """``mix["ring"]`` seeded batches: images U(-1, 1) (B, 2, 3, S, S),
    θs (B, 2, 85) with the camera scale ``cam_scale`` and poses N(0,
    ``pose_std``); every row differs."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    out = []
    for _ in range(mix["ring"]):
        img = 2 * torch.rand(batch, 2, 3, image_size, image_size,
                             generator=gen, device=device) - 1
        smpl = torch.zeros(batch, 2, 85, device=device)
        smpl[..., 0] = mix["cam_scale"]
        smpl[..., 3:75] = mix["pose_std"] * torch.randn(
            batch, 2, 72, generator=gen, device=device)
        out.append({"images": img, "smpls": smpl})
    return out


def states(cfg: dict, seed: int, device) -> dict:
    """The benchmark's seeded weights of G, D, VGG19 and Sphere20a."""
    with torch.device("meta"):
        nets = {"G": N.Generator(4, 6, 6, cfg["conv_dim"], cfg["repeat_num"],
                                 cfg["n_down"]),
                "D": RT.PatchD(6, cfg["ndf"], cfg["d_layers"]),
                "vgg": RT.Vgg19(), "face": RT.Sphere20a()}
    rule = {"G": weights.gan_std, "D": weights.gan_std,
            "vgg": weights.facenet_std, "face": weights.facenet_std}
    return {k: weights.seeded_state(
        net, rule[k], seed + i, device,
        weights.prelu_slopes(net) if k == "face" else None)
        for i, (k, net) in enumerate(nets.items())}


def norms(leaves: dict) -> dict:
    """{net: {leaf: tensor}} -> {net: {leaf: its norm}}."""
    return {net: {k: float(v.double().norm()) for k, v in d.items()}
            for net, d in leaves.items()}


def leaf_gap(prog: dict, ref: dict, keep: dict) -> float:
    """max over kept leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, median
    ‖ref‖ of its net); {net: {leaf: norm}} each."""
    worst = 0.0
    for net in NETS:
        med = float(np.median(list(ref[net].values())))
        for k in keep[net]:
            worst = max(worst, abs(prog[net][k] - ref[net][k])
                        / max(ref[net][k], med))
    return worst


def median_diff(prog: dict, ref: dict, keep: dict) -> float:
    """The median over the kept leaves of ‖prog - ref‖ / ‖ref‖;
    {net: {leaf: tensor}} each."""
    return float(np.median([
        float((prog[net][k].double() - ref[net][k].double()).norm()
              / ref[net][k].double().norm())
        for net in NETS for k in keep[net]]))


class Cell:
    """One training cell on one device: the benchmark's inputs and the
    program's trainer, state and step built on them."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        from impersonator_tpu_torch.assets import SMPLAssets
        from impersonator_tpu_torch.config import TrainConfig
        from impersonator_tpu_torch.models import losses as L
        from impersonator_tpu_torch.models.discriminator import \
            PatchDiscriminator
        from impersonator_tpu_torch.models.facenet import Sphere20a
        from impersonator_tpu_torch.models.generator import \
            ImpersonatorGenerator
        from impersonator_tpu_torch.ops import cuda_raster
        from impersonator_tpu_torch.ops import smpl as smpl_ops
        from impersonator_tpu_torch.tasks import trainer as T
        from impersonator_tpu_torch.tasks.renderer import SMPLRenderer

        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        self.T, self.kernels = T, cuda_raster.KERNELS
        w_seed, t_seed = traffic.stream_seeds(seed)
        self.body = ref_body.body_arrays(**cfg["body"])
        self.uv_table = ref_body.uv_seg_table(self.body["f2uvs"])
        self.states = states(cfg, w_seed, self.device)
        tcfg = TrainConfig(**{k: cfg[k] for k in cfg["train_config"]})
        assets = SMPLAssets(**self.body)
        with torch.device(self.device):
            gen = ImpersonatorGenerator(4, 6, 6, cfg["conv_dim"],
                                        cfg["repeat_num"], cfg["n_down"])
            disc = PatchDiscriminator(6, cfg["ndf"], cfg["d_layers"],
                                      "instance")
            vgg, face = L.Vgg19(), Sphere20a()
        for net, key in ((gen, "G"), (disc, "D"), (vgg, "vgg"),
                         (face, "face")):
            net.load_state_dict(self.states[key])
        trainer = T.Trainer(
            tcfg, assets,
            SMPLRenderer.create(assets, self.device,
                                image_size=cfg["image_size"],
                                map_name=cfg["map_name"]),
            smpl_ops.SMPLParams.from_assets(assets, self.device),
            self.device, vgg.eval().requires_grad_(False),
            face.eval().requires_grad_(False))
        self.trainer = trainer
        self.state = trainer.init_state(generator=gen, discriminator=disc)
        self.step = T.make_train_step(trainer, train_d=True)
        self.ring = ring(mix, t_seed, cfg["image_size"], cfg["batch_size"],
                         self.device)
        self.steps = 0

    def named(self):
        return {"G": list(self.state.generator.named_parameters()),
                "D": list(self.state.discriminator.named_parameters())}

    def first_steps(self, n: int) -> dict:
        """The first ``n`` steps through the window's own call, on ring
        batches 0 .. n-1 -> their losses, the first step's gradient norms
        read back from Adam's first moment, and each leaf's change."""
        losses = []
        grad = None
        for i in range(n):
            _, m = self.step(self.state, self.ring[i])
            self.steps += 1
            losses.append((float(m["g_total"]), float(m["d_loss"])))
            if i == 0:
                grad = {}
                for net, opt in (("G", self.state.g_opt),
                                 ("D", self.state.d_opt)):
                    b1 = opt.param_groups[0]["betas"][0]
                    # no moment: the step left the optimiser untouched
                    grad[net] = {
                        k: (opt.state[p]["exp_avg"] / (1 - b1)
                            if p in opt.state else torch.zeros_like(p))
                        .detach().clone()
                        for k, p in self.named()[net]}
        change = {net: {k: float((p.detach() - self.states[net][k])
                                 .double().norm())
                        for k, p in params}
                  for net, params in self.named().items()}
        return {"losses": losses, "grad": grad, "change": change}

    def window(self, seconds: float):
        """Steps back to back on the ring until ``seconds`` of host time
        have passed, synchronised at both ends -> (steps, seconds)."""
        torch.cuda.synchronize(self.device) if self.device.type == "cuda" \
            else None
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.step(self.state, self.ring[self.steps % len(self.ring)])
            self.steps += 1
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n, time.perf_counter() - t0

    def traced(self, n_steps: int) -> dict:
        """``n_steps`` steps under the profiler (device activity only),
        then two with the host's ops recorded too, for the idle gaps ->
        the device summary with the breakdown and the z-buffer kernels'
        launches in the first stretch."""
        from torch.profiler import record_function
        cuda = self.device.type == "cuda"

        def steps(n):
            def go():
                for _ in range(n):
                    with record_function("bench.step"):
                        self.step(self.state,
                                  self.ring[self.steps % len(self.ring)])
                    self.steps += 1
            return go

        before = {k.__name__: k.launches for k in self.kernels}
        prof, wall = trace.profile(steps(n_steps), cuda, host=False)
        summary = trace.device_summary(prof, wall)
        summary["launches_zbuffer"] = {
            k.__name__: k.launches - before[k.__name__] for k in self.kernels}
        prof, _ = trace.profile(steps(2), cuda, host=True)
        summary["breakdown"] = {"device_ops": summary.pop("top_ops"),
                                "idle_gaps": trace.idle_by_host(prof)}
        return summary

    def body_flow_ms(self, reps: int = 20) -> float:
        """``tasks.trainer.body_recovery_flow`` on a ring batch: CUDA
        events, median of ``reps``."""
        tr = self.trainer
        batch = self.ring[0]
        img, smpl = batch["images"], batch["smpls"]
        times = []
        for _ in range(reps + 2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            self.T.body_recovery_flow(tr.renderer, tr.smpl_params,
                                      tr.assets.parents, img[:, 0],
                                      img[:, 1], smpl[:, 0], smpl[:, 1])
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times[2:]))

    def free_program(self):
        self.state = self.trainer = self.step = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_steps(cell: Cell, n: int, fp8: bool = False,
                    count_flops: bool = False) -> dict:
    """The reference's first ``n`` steps on the same weights and ring
    batches -> as :meth:`Cell.first_steps`, plus with ``count_flops`` the
    FLOPs of one step by precision."""
    from torch.utils.flop_counter import FlopCounterMode
    with G.full_fp32():
        ref = RT.Step(cell.cfg, cell.body, cell.uv_table, cell.states,
                      cell.device, fp8=fp8)
        losses, grad, flops = [], None, None
        for i in range(n):
            if count_flops and i == 0:
                face_fl = [0]
                face_fwd = ref.face.forward

                def counted(x):
                    with FlopCounterMode(display=False) as inner:
                        out = face_fwd(x)
                    face_fl[0] += inner.get_total_flops()
                    return out
                ref.face.forward = counted
                with FlopCounterMode(display=False) as fc:
                    out = ref.step(cell.ring[i])
                ref.face.forward = face_fwd
                b = cell.ring[0]
                with FlopCounterMode(display=False) as geo:
                    RT.body_flow(ref.body, ref.table, b["images"][:, 0],
                                 b["images"][:, 1], b["smpls"][:, 0],
                                 b["smpls"][:, 1], ref.s)
                fp32 = face_fl[0] + geo.get_total_flops()
                flops = {"bfloat16": fc.get_total_flops() - fp32,
                         "float32": fp32}
            else:
                out = ref.step(cell.ring[i])
            losses.append((out["g_total"], out["d_loss"]))
            if i == 0:
                grad = {net: {k: g.detach().clone() for (k, _), g in
                              zip(ref.params[net], out["grads"][net])}
                        for net in NETS}
        change = {net: {k: float((p.detach() - cell.states[net][k])
                                 .double().norm())
                        for k, p in ref.params[net]}
                  for net in NETS}
    return {"losses": losses, "grad": grad, "change": change,
            "flops": flops}


def kept_leaves(ref_grad: dict) -> dict:
    """Per net, the leaves whose reference gradient norm is at least a
    thousandth of the median leaf's; {net: {leaf: norm}}."""
    keep = {}
    for net in NETS:
        med = float(np.median(list(ref_grad[net].values())))
        keep[net] = [k for k, v in ref_grad[net].items() if v >= 1e-3 * med]
    return keep


def gaps_of(prog: dict, ref: dict) -> dict:
    """The numbers compared (see the module's docstring), and ``loss1``
    and ``loss3``, which are read and not compared."""
    losses = [abs(p - r) / abs(r)
              for pa, ra in zip(prog["losses"], ref["losses"])
              for p, r in zip(pa, ra)]
    ref_norms = norms(ref["grad"])
    keep = kept_leaves(ref_norms)
    return {"grad_leaf": leaf_gap(norms(prog["grad"]), ref_norms, keep),
            "change_leaf": leaf_gap(prog["change"], ref["change"], keep),
            "grad_diff": median_diff(prog["grad"], ref["grad"], keep),
            "loss1": max(losses[:2]), "loss3": max(losses)}


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device="cuda", t_start: float | None = None) -> dict:
    """One run of a training cell -> the record the metric readers
    read."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(cfg, mix, seed, device)
    cuda = cell.device.type == "cuda"
    prog = cell.first_steps(mix["check_steps"])
    for _ in range(mix["warm_steps"]):
        cell.step(cell.state, cell.ring[cell.steps % len(cell.ring)])
        cell.steps += 1
    if cuda:
        torch.cuda.synchronize(cell.device)
        torch.cuda.reset_peak_memory_stats(cell.device)
    rec = {"setup_s": time.perf_counter() - t_start, "traced": traced}
    steps, window_s = cell.window(seconds)
    phase = {"setup": rec["setup_s"], "window": window_s}
    rec.update(steps=steps, window_s=window_s, batch=cfg["batch_size"],
               attempted=steps, failed=0)
    t = time.perf_counter()
    if traced:
        rec["profile"] = cell.traced(mix["profile_steps"])
        rec["body_flow_ms"] = cell.body_flow_ms() if cuda else None
        phase["traced"] = time.perf_counter() - t
        t = time.perf_counter()
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(cell.device)
                                if cuda else 0)
    cell.free_program()
    ref = reference_steps(cell, mix["check_steps"], count_flops=traced)
    rec["gaps"] = gaps_of(prog, ref)
    phase["check"] = time.perf_counter() - t
    info = {"memory_peak_bytes": rec["memory_peak_bytes"], "steps": steps,
            "gaps": rec["gaps"],
            "losses": prog["losses"], "ref_losses": ref["losses"],
            "phase_s": phase}
    if traced:
        per_sample = {k: v / cfg["batch_size"]
                      for k, v in ref["flops"].items()}
        rec["useful_flops"] = {k: v * steps * cfg["batch_size"]
                               for k, v in per_sample.items()}
        rec["peak"] = trace.PEAK
        info["flops_per_sample"] = per_sample
        info["launches"] = rec["profile"]["launches_zbuffer"]
    rec["info"] = info
    return rec


def half_batch(step):
    """The fault "half of the batch left out": ``step`` on the first half
    of each batch's rows, its losses the mean over those."""
    def broken(state, batch):
        n = batch["images"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()})
    return broken


def readings(cfg: dict, mix: dict, seed: int, seconds: float,
             control: bool, device="cuda", fault: bool | None = None) -> dict:
    """The program's gaps on one seed (its first steps; no window), with
    ``control`` those of the control (the reference on float8
    convolutions), and with ``fault`` (by default as ``control``) those
    of the program with half of each batch left out (see
    ``lwg_bench/controls.py``)."""
    fault_on = control if fault is None else fault
    cell = Cell(cfg, mix, seed, device)
    prog = cell.first_steps(mix["check_steps"])
    cell.free_program()
    fault = None
    if fault_on:
        broken = Cell(cfg, mix, seed, device)
        broken.step = half_batch(broken.step)
        fault = broken.first_steps(mix["check_steps"])
        broken.free_program()
        del broken
    ref = reference_steps(cell, mix["check_steps"])
    row = {"program": gaps_of(prog, ref), "losses": prog["losses"],
           "ref_losses": ref["losses"]}
    if fault is not None:
        row["half_batch"] = gaps_of(fault, ref)
    if control:
        row["control"] = gaps_of(reference_steps(cell, mix["check_steps"],
                                                 fp8=True), ref)
    return row
