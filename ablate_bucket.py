#!/usr/bin/env python3
"""Times each part of the bucket z-buffer design against the kernel
without it, on one NVIDIA GPU. Run from the repository root:

    python3 ablate_bucket.py [--parent PATH] [--rounds N]

impersonator_tpu_torch/csrc/zbuffer_bucket.cu takes three build switches
(ZB_TILE_CULL, ZB_HIT_QUEUE, ZB_ITEMS_FASTEST), each of which leaves the
results the same bits. This builds the kernel as it ships and once with
each switch off (and, with --parent, another zbuffer_bucket.cu with the
same C entry points, such as an earlier commit's), one nvcc per build,
all started together. On chip_smoke.py's 16 bench bodies at 256² (tile
16, span 2) it checks that the shipped build equals the plain twins and
every other build equals the shipped one, bit for bit (fim, weights,
flow), and times both kernels of each build: the median device time of
one launch under torch.profiler (chip_smoke.device_ms), in N rounds that
visit the builds in alternating order. Prints ptxas' registers, spills
and shared memory of each build, one line per (build, kernel) with its
times over the rounds, the card's name and power limit, and a JSON
record as the last line. Exits 1 on a failed build, launch or mismatch.
"""

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import chip_smoke as smoke

SWITCHES = {"shipped": (), "no_tile_cull": ("-DZB_TILE_CULL=0",),
            "no_hit_queue": ("-DZB_HIT_QUEUE=0",),
            "items_slowest": ("-DZB_ITEMS_FASTEST=0",)}
KERNELS = ("zbuffer_bucket_rows", "zbuffer_bucket_flow")


def build_all(cr, sources):
    """{build: (loaded C entry points, nvcc's output)} for sources {build:
    (path of the .cu, extra nvcc flags)}."""
    out_dir = cr.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, (src, flags) in sources.items():
        so = out_dir / f"zbuffer_bucket_{name}.so"
        running[name] = (so, subprocess.Popen(
            [cr._nvcc(), *cr.NVCC_FLAGS, *flags, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in running.items():
        log = proc.communicate()[0]
        smoke.check(proc.returncode == 0, f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fns = {}
        for sym, argtypes in cr.SYMBOLS["zbuffer_bucket.cu"].items():
            fns[sym] = getattr(lib, sym)
            fns[sym].argtypes = argtypes
            fns[sym].restype = ctypes.c_int
        built[name] = (fns, log)
    return built


def launchers(fns, verts, fid, srcxy, starts, geo):
    """{kernel: fn()} launching one build's kernel into outputs of its
    own; fn returns the outputs (fim, weights | flow)."""
    import torch
    s, tile, span, near, far = geo
    b, nf = verts.shape[0], verts.shape[1]

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=verts.device)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    fim_r, wim = empty(b, s, s, dtype=torch.int32), empty(b, s, s, 3)
    fim_f, flow = empty(b, s, s, dtype=torch.int32), empty(b, s, s, 2)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def rows():
        err = fns["zbuffer_bucket_rows"](
            ptr(verts), ptr(fid), ptr(starts), ptr(fim_r), ptr(wim), b, nf,
            s, tile, span, near, far, stream)
        smoke.check(err == 0, f"zbuffer_bucket_rows: cudaError {err}")
        return fim_r, wim

    def flow_():
        err = fns["zbuffer_bucket_flow"](
            ptr(verts), ptr(fid), ptr(srcxy), ptr(starts), ptr(fim_f),
            ptr(flow), b, nf, s, tile, span, near, far, stream)
        smoke.check(err == 0, f"zbuffer_bucket_flow: cudaError {err}")
        return fim_f, flow
    return {"zbuffer_bucket_rows": rows, "zbuffer_bucket_flow": flow_}


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="another zbuffer_bucket.cu to build and time")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    smoke.check(torch.cuda.is_available(), "torch.cuda.is_available() is "
                                           "false")
    from impersonator_tpu_torch.assets import bench_assets
    from impersonator_tpu_torch.ops import cuda_raster as cr
    from impersonator_tpu_torch.ops import rasterizer as rast
    from impersonator_tpu_torch.ops import smpl as smpl_ops

    smi = smoke.gpu_line()
    dev = torch.device("cuda")
    src = cr.CSRC / "zbuffer_bucket.cu"
    sources = {name: (src, flags) for name, flags in SWITCHES.items()}
    if args.parent is not None:
        sources["parent"] = (args.parent, ())
    built = build_all(cr, sources)
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill")):
                print(f"ptxas {name}: {line.strip()}")

    s, tile, span = smoke.GEOM["s"], smoke.GEOM["tile"], smoke.GEOM["span"]
    assets = bench_assets()
    params = smpl_ops.SMPLParams.from_assets(assets, dev)
    _, fv = smoke.body_scene(assets, params, 16, dev, rast, smpl_ops)
    verts, fid, starts, order = rast._bucket_sort(fv, s, tile, span,
                                                  rast.DEFAULT_FAR)
    b, nf = fv.shape[0], fv.shape[1]
    src_xy = fv[0:1, ..., :2].reshape(1, nf, 6).expand(b, nf, 6)
    srcxy = torch.gather(src_xy, 1, order[..., None].expand(b, nf, 6))
    srcxy = srcxy.contiguous()
    geo = (s, tile, span, rast.DEFAULT_NEAR, rast.DEFAULT_FAR)
    calls = {name: launchers(fns, verts, fid, srcxy, starts, geo)
             for name, (fns, _) in built.items()}

    want = {"zbuffer_bucket_rows": cr.zbuffer_bucket_rows_plain(
                verts, fid, starts, *geo),
            "zbuffer_bucket_flow": cr.zbuffer_bucket_flow_plain(
                verts, fid, srcxy, starts, *geo)}
    for name, fns in calls.items():
        for k in KERNELS:
            got = fns[k]()
            torch.cuda.synchronize()
            smoke.check(all(torch.equal(g, w) for g, w in zip(got, want[k])),
                        f"{name} {k} differs from the plain twin")
    print(f"every build's fim, weights and flow equal the plain twins' on "
          f"the 16 bench bodies ({nf} faces), batch 16, 256^2", flush=True)

    names = list(calls)
    times = {name: {k: [] for k in KERNELS} for name in names}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            for k in KERNELS:
                times[name][k].append(smoke.device_ms(calls[name][k], 30))

    def median(v):
        return sorted(v)[len(v) // 2]

    for k in KERNELS:
        base = median(times["shipped"][k])
        for name in names:
            v = times[name][k]
            print(f"{k} {name}: median {median(v):.4f} ms of device time "
                  f"per launch over {args.rounds} rounds ({min(v):.4f}–"
                  f"{max(v):.4f}), {median(v) / base:.3f}x the shipped "
                  f"build, batch 16 at 256^2 [{smi}]")
    print(smi)
    print(json.dumps({"card": smi, "device_ms": times}))


if __name__ == "__main__":
    main()
