"""The post-tune driver: imitate-smpl's closed loop of jobs with the
published motion-imitation preset's post-tune in each (``runner.sh
--post_tune``, as ``cli.run_imitator --post_tune`` runs it): the
released weights back in the program's float32 master, then
``Imitator.personalize``, ``tasks.post_tune.adaptive_personalize`` on
the configuration's prior poses with the seeded Sphere20a (the pair
batch, the tune steps, the refresh and the second personalise), then
``inference_by_smpls`` and the frames to the host.

What is compared (``gaps``, each against the cell's ``limits``), on one
job drawn from the seed and run after the window through the same
calls, with the plain float32 reference (``reference.post_tune``) on
the same weights and source. Wrappers around ``post_tune``'s
``build_meta_pairs`` and ``tune_loss`` and an optimiser step pre-hook
read what the program produced, with no edit to it:

* ``pairs_flow``, ``pairs_init``, ``pairs_mask``, ``pairs_inputs``:
  the RMS of the pair batch's T and T_cycle, ``init_preds``, crop masks,
  and its other float keys (the generator's inputs, the source images,
  the 2-D joints; the largest key's) against the reference's;
  ``pairs_fim``: the share of the source's and the poses' face-index
  pixels that differ from the reference's;
* ``step_count``: how far the program's count of tune steps is from
  the reference's;
* ``loss``: the largest relative gap of a step's loss against the
  reference's at the program's parameters, on the minibatch that the
  reference's own plan (``reference.post_tune.minibatches``) picks for
  that step from the program's pair batch, over the program's source
  background: a step that trains on other pairs, or on rows out of
  line with them, reads as a gap of its loss;
* ``grad_leaf`` and ``grad_diff``: from step 2 on, the worst leaf's gap
  of the gradient norms, and its norm of the gradients' difference,
  over the reference's norm of that leaf or the median leaf's,
  whichever is larger (train-b16's measure). Step 1 is left out: there
  ``init_preds`` and the pass it anchors agree up to rounding, so the
  structure term's L1 subgradient is rounding in both;
* ``adam``: the reference's Adam replayed on the program's gradients,
  its parameters after each step against the program's, over the size
  of the step;
* ``rms``, ``worst_frame_rms``: the clip's frames against the reference
  imitating with the program's tuned master, as imitate-smpl compares.

Leaves whose reference gradient is under a thousandth of the median
leaf's (biases under an instance norm, the background stream) are left
out of the gradient gaps."""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from lwg_bench import span_rows, trace, traffic, weights
from lwg_bench.drivers import imitate as I
from lwg_bench.reference import geometry as G
from lwg_bench.reference import post_tune as RP
from lwg_bench.reference import trainer as RT


def face_state(seed: int, device) -> dict:
    """Sphere20a's seeded state, as the training cell seeds it."""
    with torch.device("meta"):
        net = RT.Sphere20a()
    return weights.seeded_state(net, weights.facenet_std, seed, device,
                                weights.prelu_slopes(net))


class Capture:
    """Within the block: the pair batch the program's post-tune builds,
    its source's background, and each tune step's loss, parameters and
    gradients (as the optimiser gets them), by name; on the device."""

    def __init__(self, post_tune, gen):
        self.mod, self.names = post_tune, [n for n, _ in
                                           gen.named_parameters()]
        self.pairs, self.bg, self.steps = None, None, []

    def __enter__(self):
        mod = self.mod
        self.saved = mod.build_meta_pairs, mod.tune_loss
        build, loss = self.saved

        def pairs(imit, prior_smpls, src_info=None):
            out = build(imit, prior_smpls, src_info)
            src = imit.src_info if src_info is None else src_info
            self.pairs, self.bg = out, src["bg"].detach().clone()
            return out

        def tune_loss(*a, **k):
            total, parts = loss(*a, **k)
            self.steps.append({"loss": total.detach().clone()})
            return total, parts

        mod.build_meta_pairs, mod.tune_loss = pairs, tune_loss
        self.hook = register_optimizer_step_pre_hook(self.before_step)
        return self

    def before_step(self, opt, args, kwargs):
        params = opt.param_groups[0]["params"]
        self.steps[-1]["params"] = {n: p.detach().clone()
                                    for n, p in zip(self.names, params)}
        self.steps[-1]["grads"] = {
            n: None if p.grad is None else p.grad.detach().clone()
            for n, p in zip(self.names, params)}

    def __exit__(self, *exc):
        self.mod.build_meta_pairs, self.mod.tune_loss = self.saved
        self.hook.remove()


class Cell(I.Cell):
    """One post-tune cell on one device: the imitation cell's inputs and
    program, the seeded face net, and the released weights kept to be
    put back for each new user."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        super().__init__(cfg, mix, seed, device)
        from impersonator_tpu_torch.models.facenet import Sphere20a
        from impersonator_tpu_torch.tasks import post_tune
        self.post_tune, self.pt = post_tune, cfg["post_tune"]
        self.master = self.imitator.nets.generator
        self.face_state = self.face = None
        if self.pt["use_face"]:
            w_seed, _ = traffic.stream_seeds(seed)
            self.face_state = face_state(w_seed + 3, self.device)
            with torch.device(self.device):
                face = Sphere20a()
            face.load_state_dict(self.face_state)
            self.face = face.eval().requires_grad_(False)

    def run_job(self, job, into=None, thetas=None):
        """One new user's clip: the released weights back in the master
        and its compute copy, personalise, post-tune, imitate, frames to
        the host -> the frames."""
        imi, pt = self.imitator, self.pt
        self.master.load_state_dict(self.gen_state)
        imi.refresh_compute_nets()
        imi.personalize(job.src_img, job.src_theta)
        priors = self.post_tune.default_prior_poses(
            imi.src_info["theta"], pt["prior_poses"], pt["prior_std"])
        self.post_tune.adaptive_personalize(
            imi, priors, epochs=pt["epochs"], lr=pt["lr"],
            batch_size=pt["batch_size"], use_face=pt["use_face"],
            face=self.face)
        host = (self.host if into is None else into)[:job.length]
        host.copy_(self.imitate(job))
        return host

    def warm_up(self):
        """The imitation cell's warm-up, post-tune included; it ends the
        run where a tune step's optimiser sees TF32 on, which the
        configuration's float32 rules out. (Such a program fails the
        check after the window too; ending it here keeps it from being
        measured as if it ran the configuration.)"""
        seen = []
        hook = register_optimizer_step_pre_hook(
            lambda *_: seen.append(torch.backends.cudnn.allow_tf32
                                   or torch.backends.cuda.matmul.allow_tf32))
        try:
            super().warm_up()
        finally:
            hook.remove()
        if any(seen):
            raise SystemExit("the program's post-tune ran with TF32 on; "
                             "the configuration states float32 without it")

    def traced(self, n_pers: int, n_jobs: int, first: int):
        """After the window: each of ``n_pers`` jobs from index ``first``
        personalised alone, timed to a synchronise after it; then
        ``n_jobs`` jobs whole under the profiler (device activity only),
        then one with the host's ops recorded too, for the idle gaps and
        the span table. -> (device summary with the breakdown, span rows
        of the host-recorded job, personalise ms of each job)."""
        from torch.profiler import record_function
        cuda = self.device.type == "cuda"
        jobs = [self.jobs[i % len(self.jobs)]
                for i in range(first, first + n_jobs + 1)]
        pers = []
        for i in range(first, first + n_pers):
            job = self.jobs[i % len(self.jobs)]
            I._sync(self.device)
            t = time.perf_counter()
            self.imitator.personalize(job.src_img, job.src_theta)
            I._sync(self.device)
            pers.append(1e3 * (time.perf_counter() - t))

        def run(batch):
            def go():
                for job in batch:
                    with record_function("bench.job"):
                        self.run_job(job)
            return go

        prof, wall = trace.profile(run(jobs[:n_jobs]), cuda, host=False)
        summary = trace.device_summary(prof, wall)
        prof, _ = trace.profile(run(jobs[n_jobs:]), cuda, host=True)
        rows = span_rows.table(prof, span_rows.POSTTUNE)
        summary["breakdown"] = {"device_ops": summary.pop("top_ops"),
                                "idle_gaps": trace.idle_by_host(prof)}
        return summary, rows, pers

    def free_program(self):
        self.master = self.face = None
        super().free_program()

    def check_job(self, job) -> dict:
        """``job`` through :meth:`run_job` with the program's post-tune
        read -> {"pairs", "bg", "steps", "tuned", "frames" (on the
        host)}."""
        with Capture(self.post_tune, self.master) as cap:
            frames = self.run_job(job, into=self.host_buffer())
        return {"pairs": cap.pairs, "bg": cap.bg, "steps": cap.steps,
                "tuned": {k: v.detach().clone()
                          for k, v in self.master.state_dict().items()},
                "frames": frames}


def check_index(mix: dict, seed: int) -> int:
    """The job the check compares: one of the first ``check_within``,
    drawn from the seed."""
    return int(np.random.default_rng(seed).integers(mix["check_within"]))


def reference(cell: Cell, control=None) -> RP.PostTune:
    """The plain reference on the cell's body, weights and device; with
    ``control`` ("tf32" or "bf16") in that precision."""
    return RP.PostTune(cell.cfg, cell.body, cell.uv_table, cell.gen_state,
                       cell.face_state, cell.bgnet_state, cell.device,
                       control=control)


def source_of(ref: RP.PostTune, job, pt: dict):
    """(the reference's source state, the prior θs) of a job."""
    theta = job.src_theta.reshape(1, 85).float()
    return (ref.source(job.src_img, theta),
            RP.prior_poses(theta, pt["prior_poses"], pt["prior_std"]))


def control_record(ctl: RP.PostTune, job, pt: dict) -> dict:
    """The control's job in the program's place, as :meth:`Cell.
    check_job` records the program's."""
    with ctl.precision():
        src, priors = source_of(ctl, job, pt)
    rec = ctl.tune(src, priors)
    rec["frames"] = ctl.frames(job.src_img, job.src_theta.reshape(1, 85),
                               job.targets, rec["tuned"]).cpu()
    return rec


def rms(a, b) -> float:
    return float((a.double() - b.double()).square().mean().sqrt())


# the pair batch's keys that the pair gaps compare: by RMS (each to its
# own gap), by the share of pixels that differ, and the rest by RMS
PAIRS_RMS = ("T", "T_cycle", "init_preds", "pseudo_masks")
PAIRS_FIM = ("src_fim", "tsf_fim")


def pair_gaps(got: dict, want: dict) -> dict:
    """The pair gaps (see the module's docstring) of the program's pair
    batch ``got`` against the reference's ``want``."""
    out = {"pairs_flow": rms(torch.cat([got["T"], got["T_cycle"]]),
                             torch.cat([want["T"], want["T_cycle"]])),
           "pairs_init": rms(got["init_preds"], want["init_preds"]),
           "pairs_mask": rms(got["pseudo_masks"], want["pseudo_masks"])}
    fim = torch.cat([(got[k].long() != want[k].long()).flatten()
                     for k in PAIRS_FIM])
    out["pairs_fim"] = float(fim.double().mean())
    out["pairs_inputs"] = max(rms(got[k], want[k]) for k in want
                              if k not in PAIRS_RMS + PAIRS_FIM)
    return out


def gaps_of(ref: RP.PostTune, job, rec: dict) -> dict:
    """The numbers compared (see the module's docstring) of a record
    (:meth:`Cell.check_job`'s, or :func:`control_record`'s) against the
    float32 reference ``ref``."""
    out = {}
    ref.reset()
    with ref.precision():
        src, priors = source_of(ref, job, ref.pt)
        want, got = ref.pairs(src, priors), rec["pairs"]
        out.update(pair_gaps(got, want))
        n = priors.shape[0]
        plan = RP.minibatches(n, ref.pt["batch_size"], ref.pt["epochs"])
        steps = rec["steps"]
        out["step_count"] = abs(len(steps) - len(plan))
        bg = rec["bg"].expand(n, *rec["bg"].shape[1:])
        losses, leaf, diff, adam, state = [], 0.0, 0.0, 0.0, {}
        for s, (step, idx) in enumerate(zip(steps, plan)):
            ref.set_params(step["params"])
            loss, grads = ref.loss_and_grads(
                RP.take(got, idx),
                bg[torch.as_tensor(idx, device=bg.device)])
            losses.append(abs(float(step["loss"]) - float(loss))
                          / abs(float(loss)))
            if s > 0:
                a, b = grad_gaps(step["grads"], grads)
                leaf, diff = max(leaf, a), max(diff, b)
            ref.adam(state, step["grads"])
            after = (steps[s + 1]["params"] if s + 1 < len(steps)
                     else rec["tuned"])
            adam = max(adam, step_gap(ref, step["params"], after))
            del grads
        out.update(loss=max(losses, default=0.0), grad_leaf=leaf,
                   grad_diff=diff, adam=adam,
                   losses=[float(s["loss"]) for s in steps])
    frames = ref.frames(job.src_img, job.src_theta.reshape(1, 85),
                        job.targets, rec["tuned"]).cpu()
    out.update(I.gaps_of({0: (rec["frames"], None)}, {0: (frames, None)}))
    return out


def grad_gaps(prog: dict, ref: dict) -> tuple:
    """(the worst kept leaf's |‖prog‖ - ‖ref‖|, its ‖prog - ref‖), each
    over the larger of ‖ref‖ and the median leaf's; a leaf the program
    left without a gradient counts as zeros."""
    norms = {k: float(v.double().norm()) for k, v in ref.items()}
    live = [v for v in norms.values() if v > 0]
    if not live:
        return 0.0, 0.0
    med = float(np.median(live))
    leaf = diff = 0.0
    for k, r in norms.items():
        if r < 1e-3 * med:
            continue
        p = prog[k] if prog[k] is not None else torch.zeros_like(ref[k])
        scale = max(r, med)
        leaf = max(leaf, abs(float(p.double().norm()) - r) / scale)
        diff = max(diff, float((p.double() - ref[k].double()).norm())
                   / scale)
    return leaf, diff


def step_gap(ref: RP.PostTune, before: dict, after: dict) -> float:
    """‖the reference's parameters - ``after``‖ over ‖``after`` -
    ``before``‖, over every parameter."""
    num = den = 0.0
    for n, p in zip(ref.names, ref.params):
        num += float((p.detach().double() - after[n].double())
                     .square().sum())
        den += float((after[n].double() - before[n].double())
                     .square().sum())
    return math.sqrt(num / den) if den > 0 else (0.0 if num == 0
                                                 else math.inf)


def tune_flops(ref: RP.PostTune, job) -> dict:
    """FLOPs of one job's post-tune, counted by ``FlopCounterMode`` over
    the reference in float32: {"pairs": the pair batch, "step": one
    tune step's forward and backward}."""
    from torch.utils.flop_counter import FlopCounterMode
    ref.reset()
    with ref.precision():
        src, priors = source_of(ref, job, ref.pt)
        with FlopCounterMode(display=False) as fc:
            pairs = ref.pairs(src, priors)
        n = priors.shape[0]
        idx = RP.minibatches(n, ref.pt["batch_size"], 1)[0]
        bg = src["bg"].expand(len(idx), -1, -1, -1)
        with FlopCounterMode(display=False) as fs:
            ref.loss_and_grads(RP.take(pairs, idx), bg)
    return {"pairs": fc.get_total_flops(), "step": fs.get_total_flops()}


def flow_least_s(cell: Cell, ref: RP.PostTune, first: int, n_jobs: int):
    """Least time of every ``zbuffer_bucket_flow`` launch of jobs
    ``first`` .. ``first + n_jobs - 1``: the clip's, as
    ``drivers.imitate.flow_least_s`` counts them, and the pair batch's
    one over the job's prior poses (its ``init_preds``), counted the
    same way. -> (seconds, launches)."""
    total, launches = I.flow_least_s(cell, ref.imitator, first, n_jobs)
    s, pt = cell.cfg["image_size"], cell.pt
    nf = ref.body.faces.shape[0]
    with G.full_fp32(), torch.no_grad():
        for i in range(first, first + n_jobs):
            job = cell.jobs[i % len(cell.jobs)]
            theta = job.src_theta.reshape(1, 85).float()
            priors = RP.prior_poses(theta, pt["prior_poses"],
                                    pt["prior_std"])
            sw = G.swap_smpl(theta[:, :3], theta[:, 75:], priors,
                             priors[0:1, :3])
            verts, _, cam = G.smpl(ref.body, sw)
            _, _, (n_box, n_hit) = G.zbuffer(
                G.face_verts(ref.body, verts, cam), s, count=True)
            total += trace.bound_s(G.OPS_TEST * n_box + G.OPS_HIT * n_hit,
                                   G.flow_bytes(priors.shape[0], nf, s))
            launches += 1
    return total, launches


def window_flops(fl: dict, tfl: dict, recs, steps: int) -> dict:
    """Useful FLOPs of the window's jobs by precision: each delivered
    frame and each job's two personalisations as ``mfu.imitate`` counts
    them, and each job's pair batch and each tune step in float32."""
    frames, jobs = sum(r[1] for r in recs), len(recs)
    return {"bfloat16": frames * fl["frame"][0]
            + 2 * jobs * fl["personalize"][0],
            "float32": frames * fl["frame"][1]
            + 2 * jobs * fl["personalize"][1]
            + jobs * tfl["pairs"] + steps * tfl["step"]}


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device="cuda", t_start: float | None = None) -> dict:
    """One run of a post-tune cell -> the record the metric readers
    read: set-up seconds, the window's jobs, and with ``traced`` the
    profile and span table of a stretch after it; then the check
    (``gaps`` against ``mix["limits"]``) and, traced, the reference's
    counts."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(cfg, mix, seed, device)
    cell.warm_up()
    cuda = cell.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    rec = {"setup_s": time.perf_counter() - t_start, "traced": traced}
    steps0 = cell.post_tune.steps
    recs, window_s, _ = cell.window(seconds)
    steps = cell.post_tune.steps - steps0
    phase = {"setup": rec["setup_s"], "window": window_s}
    t = time.perf_counter()
    rec.update(jobs=recs, window_s=window_s, attempted=len(recs), failed=0)
    info = {"jobs": len(recs), "frames": sum(r[1] for r in recs),
            "tune_steps": steps}
    if traced:
        first = len(recs)
        summary, rows, pers = cell.traced(mix["personalize_jobs"],
                                          mix["profile_jobs"], first)
        rec["profile"], rec["spans"] = summary, rows
        rec["personalize_ms"] = info["personalize_ms"] = pers
        rec["posttune_ms"] = span_rows.per_count_ms(rows, "posttune",
                                                    "posttune")
        info["spans"] = {k: v for k, v in rows.items()
                         if k in span_rows.POSTTUNE or k == "personalize"}
        phase["traced"] = time.perf_counter() - t
        t = time.perf_counter()
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(cell.device)
                                if cuda else 0)
    info["memory_peak_bytes"] = rec["memory_peak_bytes"]
    index = check_index(mix, cell.t_seed)
    job = cell.jobs[index % len(cell.jobs)]
    prog = cell.check_job(job)
    cell.free_program()
    ref = reference(cell)
    rec["gaps"] = gaps_of(ref, job, prog)
    del prog
    phase["check"] = time.perf_counter() - t
    t = time.perf_counter()
    info.update(checked_job=index, checked_frames=job.length,
                gaps=rec["gaps"])
    if traced:
        rec["flow_least_s"], counted = flow_least_s(cell, ref, first,
                                                    mix["profile_jobs"])
        fl = I.useful_flops(ref.imitator, cell.jobs[0], True)
        tfl = tune_flops(ref, cell.jobs[0])
        rec["useful_flops"] = window_flops(fl, tfl, recs, steps)
        rec["peak"] = trace.PEAK
        info.update(flow_launches_counted=counted, flops_per_unit=fl,
                    tune_flops=tfl, useful_flops=rec["useful_flops"])
        phase["counts"] = time.perf_counter() - t
    info["phase_s"] = phase
    rec["info"] = info
    return rec


def readings(cfg: dict, mix: dict, seed: int, seconds: float,
             control: bool, device="cuda", fault=None) -> dict:
    """The program's gaps on one seed after a short window at the cell's
    load, and with ``control`` those of the reference in the program's
    place in TF32 (``control_tf32``) and with the generator's
    convolutions in bfloat16 (``control_bf16``), on the same job (see
    ``lwg_bench/controls.py``; ``fault`` is the training driver's)."""
    cell = Cell(cfg, mix, seed, device)
    cell.warm_up()
    recs, _, _ = cell.window(seconds)
    index = check_index(mix, cell.t_seed)
    job = cell.jobs[index % len(cell.jobs)]
    prog = cell.check_job(job)
    cell.free_program()
    ref = reference(cell)
    row = {"jobs": len(recs), "checked_job": index,
           "program": gaps_of(ref, job, prog)}
    del prog
    if control:
        for mode in ("tf32", "bf16"):
            ctl = control_record(reference(cell, control=mode), job,
                                 cell.pt)
            row[f"control_{mode}"] = gaps_of(ref, job, ctl)
            del ctl
    return row
