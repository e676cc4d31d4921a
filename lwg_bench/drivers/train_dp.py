"""The data-parallel training driver: train-b16's step on ``world``
processes, one a card (NCCL; gloo on the CPU), each on its own ring of
seeded batches, the gradients averaged by the program's ``step_nets``
(``parallel.distributed.all_reduce_mean_``) before Adam. The process
that runs the cell is rank 0 and starts the others (``python -m
lwg_bench.drivers.train_dp``), as ``cli.train.spawn_local`` starts one
process a card.

Every rank joins the group at a free local port with a timeout on the
rendezvous and on every collective; rank 0 ends the run, nonzero, as
soon as another rank exits with an error or the run outlives its
deadline, and the other ranks end themselves when rank 0 is gone. The
window's steps are counted before it (from a timed probe on rank 0, so
every rank runs the same collectives) and every rank is synchronised at
its ends.

What is compared (``gaps``, each against the cell's ``limits``): the
first ``check_steps`` steps, taken in set-up through the window's call,
against the float32 reference (``reference.trainer.Step``) on the same
weights and the same ``world`` × batch samples, which it runs as
``world`` blocks of one rank's batch with the mean of their gradients:
``loss1``, ``grad_leaf`` and ``change_leaf`` as train-b16 measures them
(``drivers/train.py``), so that the all-reduce may add float32
summation-order rounding and nothing more; and ``rank_drift``, the
largest |difference| of any parameter of G or D between rank 0 and
another rank after the window."""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from lwg_bench import span_rows, trace, traffic
from lwg_bench.drivers import train as T
from lwg_bench.reference import geometry as G
from lwg_bench.reference import trainer as RT

ROOT = Path(__file__).resolve().parents[2]


def rank_seed(seed: int, rank: int) -> int:
    """The traffic seed of one rank's ring."""
    ss = np.random.SeedSequence([seed % (1 << 128), rank])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", rank)
    return torch.device("cpu")


def sync_all(device):
    """Every rank here and its device idle: a one-value all-reduce, then
    a synchronise."""
    x = torch.zeros(1, device=device)
    dist.all_reduce(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Rank:
    """One rank of a data-parallel cell: the process group, the training
    cell on the rank's device (the weights rank 0's, its ring its
    own)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, rank: int,
                 world: int, port: int, device_type: str):
        self.rank, self.world = rank, world
        self.device = rank_device(rank, device_type)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            "nccl" if self.device.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=timedelta(seconds=mix["timeout_s"]))
        self.cell = cell = T.Cell(cfg, mix, seed, self.device)
        _, self.t_seed = traffic.stream_seeds(seed)
        cell.ring = T.ring(mix, rank_seed(self.t_seed, rank),
                           cfg["image_size"], cfg["batch_size"], self.device)
        self.share_weights()

    def share_weights(self):
        """Rank 0's seeded weights on every rank, loaded into the nets
        (as a data-parallel wrapper starts)."""
        cell = self.cell
        for state in cell.states.values():
            for t in state.values():
                dist.broadcast(t, 0)
        tr = cell.trainer
        for net, key in ((cell.state.generator, "G"),
                         (cell.state.discriminator, "D"),
                         (tr.vgg, "vgg"), (tr.face, "face")):
            net.load_state_dict(cell.states[key])

    def steps(self, n: int):
        cell = self.cell
        for _ in range(n):
            cell.step(cell.state, cell.ring[cell.steps % len(cell.ring)])
            cell.steps += 1

    def agree_steps(self, seconds: float, probe: int) -> int:
        """The window's step count: ``seconds`` over a step's time in a
        probe of ``probe`` steps on rank 0, the same on every rank."""
        sync_all(self.device)
        t = time.perf_counter()
        self.steps(probe)
        sync_all(self.device)
        per = (time.perf_counter() - t) / probe
        n = torch.tensor([max(1, round(seconds / per))], device=self.device)
        dist.broadcast(n, 0)
        return int(n.item())

    def window(self, n: int):
        """``n`` steps back to back, every rank synchronised at both
        ends -> seconds on this rank's clock."""
        sync_all(self.device)
        t = time.perf_counter()
        self.steps(n)
        sync_all(self.device)
        return time.perf_counter() - t

    def drift(self) -> float:
        """The largest |difference| of any parameter of G or D between
        rank 0 and another rank."""
        st = self.cell.state
        flat = torch.cat([p.detach().reshape(-1) for net in
                          (st.generator, st.discriminator)
                          for p in net.parameters()])
        zero = flat.clone()
        dist.broadcast(zero, 0)
        d = (flat - zero).abs().max().reshape(1)
        dist.all_reduce(d, op=dist.ReduceOp.MAX)
        return float(d.item())

    def traced(self, n_steps: int, span_steps: int) -> dict | None:
        """``n_steps`` steps under the profiler on rank 0 (device
        activity only), then ``span_steps`` with the host's ops recorded
        too, for the idle gaps and the span table; every other rank runs
        as many steps unrecorded. -> rank 0's device summary with the
        breakdown and the span rows, else None."""
        if self.rank != 0:
            self.steps(n_steps + span_steps)
            return None
        from torch.profiler import record_function
        cuda = self.device.type == "cuda"

        def steps(n):
            def go():
                for _ in range(n):
                    with record_function("bench.step"):
                        self.steps(1)
            return go

        prof, wall = trace.profile(steps(n_steps), cuda, host=False)
        summary = trace.device_summary(prof, wall)
        prof, _ = trace.profile(steps(span_steps), cuda, host=True)
        summary["breakdown"] = {"device_ops": summary.pop("top_ops"),
                                "idle_gaps": trace.idle_by_host(prof)}
        summary["spans"] = span_rows.table(prof, span_rows.ALLREDUCE)
        return summary


def reduced_bytes():
    """The program's count of bytes all-reduced, where it keeps one."""
    from impersonator_tpu_torch.parallel import distributed
    return getattr(distributed, "reduced_bytes", None)


def rank_main(cfg: dict, mix: dict, seed: int, seconds: float,
              traced: bool, rank: int, world: int, port: int,
              device_type: str, t_start: float) -> dict:
    """Everything one rank does with the others: set-up, the checked
    first steps, warm-up, the window, the drift, the traced stretch ->
    this rank's record (the program freed and the group left)."""
    r = Rank(cfg, mix, seed, rank, world, port, device_type)
    cell, cuda = r.cell, r.device.type == "cuda"
    prog = cell.first_steps(mix["check_steps"])
    r.steps(mix["warm_steps"])
    n = r.agree_steps(seconds, mix["probe_steps"])
    if cuda:
        torch.cuda.reset_peak_memory_stats(r.device)
    rec = {"setup_s": time.perf_counter() - t_start, "traced": traced}
    bytes0 = reduced_bytes()
    window_s = r.window(n)
    rec.update(steps=n, window_s=window_s, attempted=n, failed=0,
               batch=cfg["batch_size"] * world, prog=prog)
    if bytes0 is not None:
        rec["reduced_bytes_per_step"] = (reduced_bytes() - bytes0) / n
    rec["rank_drift"] = r.drift()
    if traced:
        summary = r.traced(mix["profile_steps"], mix["span_steps"])
        if summary is not None:
            rows = summary.pop("spans")
            rec["profile"], rec["spans"] = summary, rows
            rec["allreduce_ms"] = span_rows.per_count_ms(
                rows, "train.allreduce", "train.step")
            rec["body_flow_ms"] = cell.body_flow_ms() if cuda else None
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(r.device)
                                if cuda else 0)
    sync_all(r.device)
    dist.destroy_process_group()
    cell.free_program()
    rec["cell"] = cell
    return rec


def block_step(ref: RT.Step, blocks) -> dict:
    """One G + D update of the reference on the mean of the blocks'
    gradients (each block one rank's batch), as :meth:`RT.Step.step`
    makes one on a single batch."""
    cfg = ref.cfg
    gp = [p for _, p in ref.params["G"]]
    dp = [p for _, p in ref.params["D"]]
    g_sum = d_sum = None
    g_total = d_loss = 0.0
    for batch in blocks:
        total, d_loss_fn, _ = ref.losses(batch)
        g = torch.autograd.grad(total, gp, materialize_grads=True)
        dl = d_loss_fn()
        d = torch.autograd.grad(dl, dp, materialize_grads=True)
        g_sum = g if g_sum is None else [a + b for a, b in zip(g_sum, g)]
        d_sum = d if d_sum is None else [a + b for a, b in zip(d_sum, d)]
        g_total += float(total.detach())
        d_loss += float(dl.detach())
    k = len(blocks)
    g_mean, d_mean = [g / k for g in g_sum], [d / k for d in d_sum]
    ref.t += 1
    ref._adam("G", gp, g_mean, cfg["lr_G"], cfg["G_adam_b1"],
              cfg["G_adam_b2"])
    ref._adam("D", dp, d_mean, cfg["lr_D"], cfg["D_adam_b1"],
              cfg["D_adam_b2"])
    return {"g_total": g_total / k, "d_loss": d_loss / k,
            "grads": {"G": g_mean, "D": d_mean}}


def reference_steps(cell: T.Cell, rings: list, n: int) -> dict:
    """The reference's first ``n`` steps on the cell's weights, step i on
    batch i of every ring as one block each -> as
    ``drivers.train.reference_steps``."""
    with G.full_fp32():
        ref = RT.Step(cell.cfg, cell.body, cell.uv_table, cell.states,
                      cell.device)
        losses, grad = [], None
        for i in range(n):
            out = block_step(ref, [ring[i] for ring in rings])
            losses.append((out["g_total"], out["d_loss"]))
            if i == 0:
                grad = {net: {k: g.detach().clone() for (k, _), g in
                              zip(ref.params[net], out["grads"][net])}
                        for net in T.NETS}
        change = {net: {k: float((p.detach() - cell.states[net][k])
                                 .double().norm())
                        for k, p in ref.params[net]}
                  for net in T.NETS}
    return {"losses": losses, "grad": grad, "change": change}


class Guard:
    """Rank 0's watch over the other ranks: the run ends, nonzero, as
    soon as one of them exits with an error, or at ``deadline`` (host
    clock) whatever it is doing; the others are killed first."""

    def __init__(self, procs: list, deadline: float):
        self.procs, self.deadline = procs, deadline
        self.stopped = threading.Event()
        threading.Thread(target=self.watch, daemon=True).start()

    def watch(self):
        while not self.stopped.wait(0.5):
            bad = [p for p in self.procs if p.poll() not in (None, 0)]
            late = time.perf_counter() > self.deadline
            if bad or late:
                why = (f"rank {self.procs.index(bad[0]) + 1} exited with "
                       f"{bad[0].returncode}" if bad else "deadline passed")
                print(f"train_dp: {why}; ending the run", file=sys.stderr,
                      flush=True)
                self.kill()
                os._exit(1)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()

    def stop(self):
        self.stopped.set()


def spawn(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
          rank: int, port: int, device_type: str) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.Popen(
        [sys.executable, "-m", "lwg_bench.drivers.train_dp",
         "--cfg", json.dumps(cfg), "--mix", json.dumps(mix),
         "--seed", str(seed), "--seconds", str(seconds),
         "--traced", str(int(traced)), "--rank", str(rank),
         "--port", str(port), "--device", device_type],
        cwd=ROOT, env=env, stdout=sys.stderr, stdin=subprocess.DEVNULL)


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device="cuda", t_start: float | None = None) -> dict:
    """One run of a data-parallel training cell, this process rank 0 ->
    the record the metric readers read."""
    t_start = time.perf_counter() if t_start is None else t_start
    world, device_type = mix["world"], torch.device(device).type
    port = free_port()
    procs = [spawn(cfg, mix, seed, seconds, traced, r, port, device_type)
             for r in range(1, world)]
    guard = Guard(procs, time.perf_counter() + seconds + mix["deadline_s"])
    try:
        rec = rank_main(cfg, mix, seed, seconds, traced, 0, world, port,
                        device_type, t_start)
        for p in procs:
            p.wait(timeout=mix["timeout_s"])
    except BaseException:
        guard.kill()
        raise
    finally:
        guard.stop()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("a rank exited with "
                           f"{[p.returncode for p in procs]}")
    t = time.perf_counter()
    cell, prog = rec.pop("cell"), rec.pop("prog")
    _, t_seed = traffic.stream_seeds(seed)
    rings = [T.ring(dict(mix, ring=mix["check_steps"]), rank_seed(t_seed, r),
                    cfg["image_size"], cfg["batch_size"], cell.device)
             for r in range(world)]
    ref = reference_steps(cell, rings, mix["check_steps"])
    rec["gaps"] = dict(T.gaps_of(prog, ref), rank_drift=rec["rank_drift"])
    rec["info"] = {"memory_peak_bytes": rec["memory_peak_bytes"],
                   "steps": rec["steps"], "world": world,
                   "gaps": rec["gaps"], "losses": prog["losses"],
                   "ref_losses": ref["losses"],
                   "reduced_bytes_per_step": rec.get(
                       "reduced_bytes_per_step"),
                   "phase_s": {"setup": rec["setup_s"],
                               "window": rec["window_s"],
                               "check": time.perf_counter() - t}}
    if "spans" in rec:
        rec["info"]["spans"] = {k: v for k, v in rec["spans"].items()
                                if k in ("train.step", "train.allreduce")}
    if traced:
        # every rank's samples, each counted as train-b16 counts them
        flops = T.reference_steps(cell, 1, count_flops=True)["flops"]
        per_sample = {k: v / cfg["batch_size"] for k, v in flops.items()}
        rec["useful_flops"] = {k: v * rec["steps"] * rec["batch"]
                               for k, v in per_sample.items()}
        # over the peaks of every rank's card
        rec["peak"] = {k: v * world for k, v in trace.PEAK.items()}
        rec["info"].update(flops_per_sample=per_sample,
                           body_flow_ms=rec.get("body_flow_ms"))
    return rec


def watch_parent():
    """End this rank when rank 0's process is gone."""
    parent = os.getppid()

    def loop():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(1)
    threading.Thread(target=loop, daemon=True).start()


def main(argv=None) -> int:
    """A rank other than 0, started by :func:`run`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name, typ in (("--cfg", str), ("--mix", str), ("--seed", int),
                      ("--seconds", float), ("--traced", int),
                      ("--rank", int), ("--port", int), ("--device", str)):
        ap.add_argument(name, type=typ, required=True)
    args = ap.parse_args(argv)
    watch_parent()
    mix = json.loads(args.mix)
    if args.device == "cpu":
        torch.set_num_threads(1)
    rank_main(json.loads(args.cfg), mix, args.seed, args.seconds,
              bool(args.traced), args.rank, mix["world"], args.port,
              args.device, time.perf_counter())
    return 0


if __name__ == "__main__":
    sys.exit(main())
