"""The imitation driver: a closed loop of jobs from one client through
the program's ``Imitator`` (``personalize``, then ``inference_by_smpls``
or ``inference`` at the configuration's batch, then the frames to the
host), the traced stretch, and the check of the window's frames, and of
the θs the program's HMR gave, against the plain reference."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from lwg_bench import trace, traffic, weights
from lwg_bench.reference import body as ref_body
from lwg_bench.reference import geometry as G
from lwg_bench.reference import nets as N
from lwg_bench.reference.imitator import Reference


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    """One imitation cell on one device: the benchmark's inputs (body,
    weights, jobs) and the program built on them."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        # the program is imported only here: the reference and the tests
        # of the harness's arithmetic never load it
        from impersonator_tpu_torch.assets import SMPLAssets
        from impersonator_tpu_torch.config import TestConfig
        from impersonator_tpu_torch.models.generator import \
            ImpersonatorGenerator
        from impersonator_tpu_torch.models.hmr import HumanModelRecovery
        from impersonator_tpu_torch.models.inpaintor import InpaintSANet
        from impersonator_tpu_torch.ops import cuda_raster
        from impersonator_tpu_torch.tasks.imitator import (Imitator,
                                                           ImitatorNets)

        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        self.cuda_raster = cuda_raster
        self.hmr_needed = (mix["source_theta"] != "given"
                           or mix["targets"] == "crops")
        w_seed, t_seed = traffic.stream_seeds(seed)
        self.t_seed = t_seed
        self.body = ref_body.body_arrays(**cfg["body"])
        self.uv_table = ref_body.uv_seg_table(self.body["f2uvs"])
        self.deepfill = cfg["bg_model"] != "ORIGINAL"
        with torch.device("meta"):
            ref_gen = N.Generator(4, 6, 6, cfg["conv_dim"],
                                  cfg["repeat_num"], cfg["n_down"])
            ref_bgnet = N.DeepFill() if self.deepfill else None
        self.gen_state = weights.seeded_state(ref_gen, weights.gan_std,
                                              w_seed, self.device)
        self.bgnet_state = None
        if ref_bgnet is not None:
            self.bgnet_state = weights.seeded_state(
                ref_bgnet, weights.bgnet_std, w_seed + 2, self.device,
                {"refine_attn.gamma": cfg["bgnet_attn_gamma"]})
        self.hmr_state = None
        if self.hmr_needed:
            self.hmr_state = self.hmr_weights(w_seed + 1)
        with torch.device(self.device):
            gen = ImpersonatorGenerator(4, 6, 6, cfg["conv_dim"],
                                        cfg["repeat_num"], cfg["n_down"])
            gen.load_state_dict(self.gen_state)
            hmr = bgnet = None
            if self.hmr_state is not None:
                hmr = HumanModelRecovery()
                hmr.load_state_dict(self.hmr_state)
            if self.bgnet_state is not None:
                bgnet = InpaintSANet(c_dim=4)
                bgnet.load_state_dict(self.bgnet_state)
        self.hmr = hmr
        tcfg = TestConfig(image_size=cfg["image_size"],
                          repeat_num=cfg["repeat_num"],
                          compute_dtype=cfg["compute_dtype"],
                          bg_ks=cfg["bg_ks"], ft_ks=cfg["ft_ks"],
                          bg_model=cfg["bg_model"],
                          front_warp=cfg["front_warp"],
                          cam_strategy=cfg["cam_strategy"])
        self.imitator = Imitator(tcfg, SMPLAssets(**self.body),
                                 ImitatorNets(gen, hmr, bgnet),
                                 device=self.device)
        self.jobs = traffic.imitation_jobs(mix, t_seed, cfg["image_size"],
                                           self.device)
        self.host = self.host_buffer()

    def hmr_weights(self, seed: int) -> dict:
        """HMR's seeded state, set to ``hmr_calibration["images"]`` crops
        of the traffic's pattern at random phases (seeded by ``seed``;
        :func:`weights.hmr_state`), by the benchmark's own HMR."""
        cal = self.cfg["hmr_calibration"]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        calib = traffic.pattern(
            traffic.random_phases(cal["images"], gen, self.device), 224,
            gen, self.mix["crop_noise"])
        with G.full_fp32():
            net = N.HMR().to(self.device)
            state = weights.hmr_state(net, seed, self.device,
                                      self.body["mean_theta"], calib,
                                      cal["pose_rms"])
        del net
        return state

    def host_buffer(self):
        """A reusable host buffer for the longest job's frames, pinned on a
        card (a client that keeps its buffers, as a video pipeline does;
        a fresh pageable tensor a job page-faults 50-75 MB each time)."""
        s = self.cfg["image_size"]
        return torch.empty((max(j.length for j in self.jobs), s, s, 3),
                           pin_memory=self.device.type == "cuda")

    def imitate(self, job):
        """The job's frames on the device, from the personalised source."""
        imi, batch = self.imitator, self.cfg["batch"]
        if self.mix["targets"] == "theta":
            return imi.inference_by_smpls(job.targets, "smooth", batch)
        return imi.inference(job.targets, "smooth", batch)

    def run_job(self, job, into=None, thetas=None):
        """One user's clip: personalise, imitate, frames to the host (into
        the host buffer ``into``, or the cell's own) -> the frames. With
        a list ``thetas``, every θ the program's HMR gives in the job is
        appended to it, as it comes out of the net."""
        hook = None
        if thetas is not None and self.hmr is not None:
            hook = self.hmr.register_forward_hook(
                lambda _m, _i, out: thetas.append(out.detach().clone()))
        try:
            self.imitator.personalize(job.src_img, job.src_theta)
            host = (self.host if into is None else into)[:job.length]
            host.copy_(self.imitate(job))
        finally:
            if hook is not None:
                hook.remove()
        return host

    def warm_up(self):
        """The window's shapes: one job of each of the two batch counts
        the shortest and the longest length need, twice."""
        lengths = sorted({j.length for j in self.jobs})
        picks = [next(j for j in self.jobs if j.length == lengths[0]),
                 next(j for j in self.jobs if j.length == lengths[-1])]
        for _ in range(2):
            for job in picks:
                self.run_job(job)
        _sync(self.device)

    def window(self, seconds: float, keep=()):
        """Jobs back to back from one client until ``seconds`` have
        passed; the job running then ends the window. -> (records
        (index, length, start, end) in seconds, window seconds, the kept
        jobs' (frames, the θs of HMR's calls or None) by index)."""
        bufs = {i: self.host_buffer() for i in keep}
        kept, recs = {}, []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            job = self.jobs[i % len(self.jobs)]
            thetas = [] if i in keep else None
            start = time.perf_counter()
            frames = self.run_job(job, bufs.get(i), thetas)
            end = time.perf_counter()
            recs.append((i, job.length, start - t0, end - t0))
            if i in keep:
                kept[i] = (frames, program_thetas(thetas, job))
            i += 1
        return recs, recs[-1][3], kept

    def traced(self, n_pers: int, n_jobs: int, n_idle: int, first: int):
        """After the window: each of ``n_pers`` jobs from index ``first``
        personalised alone, timed to a synchronise after it; then
        ``n_jobs`` jobs whole under the profiler (device activity only),
        then ``n_idle`` more with the host's ops recorded too, for the
        idle gaps. -> (device summary with the breakdown, personalise ms
        of each job, the kernels' launches in the device-only
        stretch)."""
        cuda = self.device.type == "cuda"
        jobs = [self.jobs[i % len(self.jobs)]
                for i in range(first, first + n_jobs + n_idle)]
        pers = []
        for i in range(first, first + n_pers):
            job = self.jobs[i % len(self.jobs)]
            _sync(self.device)
            t = time.perf_counter()
            self.imitator.personalize(job.src_img, job.src_theta)
            _sync(self.device)
            pers.append(1e3 * (time.perf_counter() - t))
        kernels = self.cuda_raster.KERNELS
        before = {k.__name__: k.launches for k in kernels}

        def run(batch):
            def go():
                for job in batch:
                    with record_function("bench.personalize"):
                        self.imitator.personalize(job.src_img,
                                                  job.src_theta)
                    with record_function("bench.imitate"):
                        out = self.imitate(job)
                    with record_function("bench.readback"):
                        self.host[:job.length].copy_(out)
            return go

        from torch.profiler import record_function
        prof, wall = trace.profile(run(jobs[:n_jobs]), cuda, host=False)
        launches = {k.__name__: k.launches - before[k.__name__]
                    for k in kernels}
        summary = trace.device_summary(prof, wall)
        prof, _ = trace.profile(run(jobs[n_jobs:]), cuda, host=True)
        summary["breakdown"] = {"device_ops": summary.pop("top_ops"),
                                "idle_gaps": trace.idle_by_host(prof)}
        return summary, pers, launches

    def hmr_ms(self, reps: int = 20):
        """``Imitator.regress_smpl`` on a staged batch of crops: CUDA
        events, median of ``reps``."""
        crops = self.jobs[0].targets[:self.cfg["batch"]]
        if crops.ndim != 4:
            return None
        times = []
        for _ in range(reps + 2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            self.imitator.regress_smpl(crops)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times[2:]))

    def free_program(self):
        """Drop the program's nets and state, keeping the inputs."""
        self.imitator = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def keep_indices(mix: dict, seed: int, jobs) -> dict:
    """The jobs whose frames the check compares, drawn from the seed
    before the window: ``mix["check_jobs"]`` indices among the first
    ``mix["check_within"]`` jobs, and the first job of the longest
    length. -> {index: job}."""
    rng = np.random.default_rng(seed)
    idx = set(int(i) for i in rng.choice(mix["check_within"],
                                         mix["check_jobs"], replace=False))
    longest = max(j.length for j in jobs)
    idx.add(next(j.index for j in jobs if j.length == longest))
    return {i: jobs[i % len(jobs)] for i in sorted(idx)}


def program_thetas(calls: list | None, job):
    """The θs the program's HMR gave in one job, in the reference's
    order: the source's, if regressed, then one a target frame (the
    padded last batch's extra rows left out) -> (n, 85) or None."""
    if not calls:
        return None
    src = [calls[0]] if job.src_theta is None else []
    rest = calls[len(src):]
    targets = torch.cat(rest)[:job.length] if rest else None
    out = src + ([targets] if targets is not None else [])
    return torch.cat(out).cpu()


def gaps_of(kept: dict, ref_out: dict) -> dict:
    """The numbers compared: the RMS of (program - reference) over every
    compared pixel, the largest RMS of one frame, and where HMR ran the
    largest gap of one θ value (camera, pose or shape) over every θ the
    kept jobs regressed."""
    sq, n, worst, theta, hmr = 0.0, 0, 0.0, 0.0, False
    for i, (got, got_theta) in kept.items():
        want, want_theta = ref_out[i]
        d = (got.double() - want.double()) ** 2
        per = d.reshape(d.shape[0], -1).mean(1).sqrt()
        worst = max(worst, float(per.max()))
        sq += float(d.sum())
        n += d.numel()
        if want_theta is not None:
            hmr = True
            theta = max(theta, float("inf") if got_theta is None
                        or got_theta.shape != want_theta.shape else
                        float((got_theta.double() - want_theta.double())
                              .abs().max()))
    if n == 0:   # nothing to judge: not correct
        return {"rms": float("inf"), "worst_frame_rms": float("inf"),
                "theta_max": float("inf")}
    out = {"rms": (sq / n) ** 0.5, "worst_frame_rms": worst}
    if hmr:
        out["theta_max"] = theta
    return out


def reference(cell: Cell, control=False) -> Reference:
    """The plain reference on the cell's body, weights and device; the
    control with ``control`` True (or ``"hmr"``: HMR alone in TF32)."""
    return Reference(cell.cfg, cell.body, cell.uv_table, cell.gen_state,
                     cell.hmr_state, cell.device, control=control,
                     bgnet_state=cell.bgnet_state)


def reference_frames(ref: Reference, jobs: dict, by_theta: bool) -> dict:
    """The reference's (frames, regressed θs or None) of each job, on
    the host."""
    out = {}
    with G.full_fp32():
        for i, job in jobs.items():
            frames, thetas = ref.job(job.src_img, job.src_theta,
                                     job.targets, by_theta)
            out[i] = (frames.cpu(),
                      None if thetas is None else thetas.cpu())
    return out


def useful_flops(ref: Reference, job, by_theta: bool) -> dict:
    """FLOPs of useful work, counted by ``FlopCounterMode`` over the
    reference at the cell's shapes and split by the configuration's
    precision: {"frame": (bf16, fp32), "personalize": (bf16, fp32),
    "hmr": fp32 per image or 0}."""
    from torch.utils.flop_counter import FlopCounterMode

    def count(fn):
        with FlopCounterMode(display=False) as fc:
            fn()
        return fc.get_total_flops()

    def gen_part(fn):
        """(flops inside the generator, all flops) of fn."""
        inner = [0]
        saved = {k: getattr(ref.gen, k) for k in ("decode",)}
        bg, srcm = ref.gen.bg_model.forward, ref.gen.src_model.inference

        def wrap(f):
            def g(*a, **k):
                with FlopCounterMode(display=False) as fc:
                    r = f(*a, **k)
                inner[0] += fc.get_total_flops()
                return r
            return g
        ref.gen.decode = wrap(saved["decode"])
        ref.gen.bg_model.forward = wrap(bg)
        ref.gen.src_model.inference = wrap(srcm)
        try:
            total = count(fn)
        finally:
            ref.gen.decode = saved["decode"]
            ref.gen.bg_model.forward = bg
            ref.gen.src_model.inference = srcm
        return inner[0], total

    with G.full_fp32(), torch.no_grad():
        theta = (job.src_theta[None] if job.src_theta is not None
                 else ref.source_theta(job.src_img))
        state = {}

        def pers():
            state["src"] = ref.personalize(job.src_img, theta)
        p_gen, p_all = gen_part(pers)
        tgt = job.targets[:1]
        th = tgt if by_theta else ref.regress(tgt)
        f_gen, f_all = gen_part(lambda: ref.imitate(state["src"], th,
                                                    th[:, :3]))
        hmr = 0 if ref.hmr is None else count(
            lambda: ref.regress(job.targets[:1] if not by_theta else
                                torch.zeros(1, 224, 224, 3,
                                            device=job.src_img.device)))
    return {"frame": (f_gen, f_all - f_gen),
            "personalize": (p_gen, p_all - p_gen), "hmr": hmr}


def flow_least_s(cell: Cell, ref: Reference, first: int, n_jobs: int):
    """Least time of every ``zbuffer_bucket_flow`` launch of jobs
    ``first`` .. ``first + n_jobs - 1``: per launch of ``batch`` frames
    (the last padded with its final frame), the larger of the bytes
    (:func:`geometry.flow_bytes`) over the peak bandwidth and the float
    operations of these faces' z-buffer (``OPS_TEST`` per pair of pixel
    and face in its pixel box, ``OPS_HIT`` more per pair inside it,
    counted from the benchmark's own projected vertices) over the
    float32 peak. -> (seconds, launches)."""
    batch, s = cell.cfg["batch"], cell.cfg["image_size"]
    nf = ref.body.faces.shape[0]
    total, launches = 0.0, 0
    by_theta = cell.mix["targets"] == "theta"
    with G.full_fp32(), torch.no_grad():
        for i in range(first, first + n_jobs):
            job = cell.jobs[i % len(cell.jobs)]
            src_theta = (job.src_theta[None] if job.src_theta is not None
                         else ref.source_theta(job.src_img))
            first_cam = None
            for c in range(0, job.length, batch):
                part = job.targets[c:c + batch]
                part = torch.cat([part, part[-1:].expand(
                    batch - part.shape[0], *part.shape[1:])])
                th = part if by_theta else ref.regress(part)
                if first_cam is None:
                    first_cam = th[0:1, :3]
                sw = G.swap_smpl(src_theta[:, :3], src_theta[:, 75:], th,
                                 first_cam)
                verts, _, cam = G.smpl(ref.body, sw)
                _, _, (n_box, n_hit) = G.zbuffer(
                    G.face_verts(ref.body, verts, cam), s, count=True)
                ops = G.OPS_TEST * n_box + G.OPS_HIT * n_hit
                total += trace.bound_s(ops, G.flow_bytes(batch, nf, s))
                launches += 1
    return total, launches


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device="cuda", t_start: float | None = None) -> dict:
    """One run of an imitation cell -> the record the metric readers
    read: set-up seconds, the window's jobs, and with ``traced`` the
    profile of a stretch after it; then the check (``gaps`` against
    ``mix["limits"]``) and, traced, the reference's counts."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(cfg, mix, seed, device)
    keep = keep_indices(mix, cell.t_seed, cell.jobs)
    cell.warm_up()
    cuda = cell.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    rec = {"setup_s": time.perf_counter() - t_start, "traced": traced}
    recs, window_s, kept = cell.window(seconds, keep)
    phase = {"setup": rec["setup_s"], "window": window_s}
    t = time.perf_counter()
    rec["jobs"] = recs
    rec["window_s"] = window_s
    rec["attempted"], rec["failed"] = len(recs), 0
    if traced:
        first = len(recs)
        red, pers, launches = cell.traced(mix["personalize_jobs"],
                                          mix["profile_jobs"],
                                          mix["idle_jobs"], first)
        rec["profile"] = red
        rec["personalize_ms"] = pers
        rec["launches"] = launches
        rec["hmr_ms"] = cell.hmr_ms() if cuda else None
        phase["traced"] = time.perf_counter() - t
        t = time.perf_counter()
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(cell.device)
                                if cuda else 0)
    cell.free_program()
    by_theta = mix["targets"] == "theta"
    ref = reference(cell)
    jobs = {i: cell.jobs[i % len(cell.jobs)] for i in kept}
    rec["gaps"] = gaps_of(kept, reference_frames(ref, jobs, by_theta))
    phase["check"] = time.perf_counter() - t
    t = time.perf_counter()
    info = {"memory_peak_bytes": rec["memory_peak_bytes"],
            "jobs": len(recs), "frames": sum(r[1] for r in recs),
            "checked_jobs": sorted(kept),
            "checked_frames": sum(v[0].shape[0] for v in kept.values())}
    if traced:
        rec["flow_least_s"], counted = flow_least_s(cell, ref, first,
                                                    mix["profile_jobs"])
        fl = useful_flops(ref, cell.jobs[0], by_theta)
        rec["useful_flops"] = window_flops(fl, recs, mix)
        rec["peak"] = trace.PEAK
        info.update(launches=rec["launches"], flow_launches_counted=counted,
                    personalize_ms=rec["personalize_ms"],
                    flops_per_unit=fl, useful_flops=rec["useful_flops"])
        phase["counts"] = time.perf_counter() - t
    info["phase_s"] = phase
    rec["info"] = info
    return rec


def window_flops(fl: dict, recs, mix: dict) -> dict:
    """Useful FLOPs of the window's jobs by precision: each delivered
    frame, each job's personalisation, and HMR on each regressed source
    and target."""
    frames = sum(r[1] for r in recs)
    jobs = len(recs)
    hmr_images = ((frames if mix["targets"] == "crops" else 0)
                  + (jobs if mix["source_theta"] != "given" else 0))
    return {"bfloat16": frames * fl["frame"][0]
            + jobs * fl["personalize"][0],
            "float32": frames * fl["frame"][1]
            + jobs * fl["personalize"][1] + hmr_images * fl["hmr"]}


def readings(cfg: dict, mix: dict, seed: int, seconds: float,
             control: bool, device="cuda", fault=None) -> dict:
    """The program's gaps on one seed after a short window at the cell's
    load, and with ``control`` the control's gaps on the same jobs, and
    where HMR runs those of HMR alone in TF32 (see
    ``lwg_bench/controls.py``; ``fault`` is the training driver's)."""
    cell = Cell(cfg, mix, seed, device)
    keep = keep_indices(mix, cell.t_seed, cell.jobs)
    cell.warm_up()
    recs, _, kept = cell.window(seconds, keep)
    cell.free_program()
    by_theta = mix["targets"] == "theta"
    jobs = {i: cell.jobs[i % len(cell.jobs)] for i in kept}
    ref_frames = reference_frames(reference(cell), jobs, by_theta)
    row = {"jobs": len(recs), "checked_jobs": sorted(kept),
           "program": gaps_of(kept, ref_frames)}
    if control:
        for name, mode in (("control", True), ("control_hmr", "hmr")):
            if mode == "hmr" and cell.hmr_state is None:
                continue
            ctl = reference_frames(reference(cell, control=mode), jobs,
                                   by_theta)
            row[name] = gaps_of(ctl, ref_frames)
    return row
