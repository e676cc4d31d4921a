#!/usr/bin/env python3
"""Times each part of a z-buffer kernel's design against the kernel
without it, on one NVIDIA GPU. Run from the repository root:

    python3 ablate_bucket.py [--kernel bucket|tiles] [--parent PATH]
                             [--rounds N]

Each kernel source takes build switches, each of which leaves the results
the same bits:

* bucket (impersonator_tpu_torch/csrc/zbuffer_bucket.cu): ZB_TILE_CULL,
  ZB_HIT_QUEUE, ZB_ITEMS_FASTEST; timed on chip_smoke.py's 16 bench
  bodies at 256² (tile 16, span 2), both kernels;
* tiles (csrc/zbuffer_tiles.cu): ZT_GROUP, ZT_COMPACT, ZT_SPLIT,
  ZT_HIT_QUEUE, ZT_ITEMS_FASTEST; timed on its path,
  the slots of 16 posed 63,480-face bodies at the renderer's tile_params
  (8, 288, 2), and on the 16 bench bodies' slots at (8, 288, 3).

This builds the kernel as it ships and once with each switch changed
(and, with --parent, another source with the same C entry points, such
as an earlier commit's), one nvcc per build, all started together. It
checks that every build equals the plain twins bit for bit, then times
each (build, case) in N rounds that visit the builds in alternating
order: the median device time of one launch under torch.profiler
(chip_smoke.device_ms) and the median of a lone call (chip_smoke.
median_ms, CUDA events; it also counts the host's launch). Prints ptxas'
registers, spills and shared memory of each build, one line per (case,
build), the card's name and power limit, and a JSON record as the last
line. Exits 1 on a failed build, launch or mismatch.
"""

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import chip_smoke as smoke

SOURCES = {"bucket": "zbuffer_bucket.cu", "tiles": "zbuffer_tiles.cu"}
SWITCHES = {
    "bucket": {"shipped": (), "no_tile_cull": ("-DZB_TILE_CULL=0",),
               "no_hit_queue": ("-DZB_HIT_QUEUE=0",),
               "items_slowest": ("-DZB_ITEMS_FASTEST=0",)},
    "tiles": {"shipped": (), "no_group": ("-DZT_GROUP=0",),
              "no_compact": ("-DZT_COMPACT=0",),
              "no_split": ("-DZT_SPLIT=0",),
              "no_hit_queue": ("-DZT_HIT_QUEUE=0",),
              "items_slowest": ("-DZT_ITEMS_FASTEST=0",)},
}


def build_all(cr, source, builds):
    """{build: (loaded C entry points, nvcc's output)} for builds {build:
    (path of the .cu, extra nvcc flags)} of one csrc source's entry
    points."""
    out_dir = cr.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, (src, flags) in builds.items():
        so = out_dir / f"{Path(source).stem}_{name}.so"
        running[name] = (so, subprocess.Popen(
            [cr._nvcc(), *cr.NVCC_FLAGS, *flags, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in running.items():
        log = proc.communicate()[0]
        smoke.check(proc.returncode == 0, f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fns = {}
        for sym, argtypes in cr.SYMBOLS[source].items():
            fns[sym] = getattr(lib, sym)
            fns[sym].argtypes = argtypes
            fns[sym].restype = ctypes.c_int
        built[name] = (fns, log)
    return built


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def bucket_cases(cr, rast, smpl_ops, dev):
    """(description, {case: (make(fns) -> fn() returning the outputs,
    the plain twin's outputs)}) of the bucket kernels."""
    import torch
    from impersonator_tpu_torch.assets import bench_assets
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
    near, far = rast.DEFAULT_NEAR, rast.DEFAULT_FAR

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    def rows(fns):
        fim, wim = empty(b, s, s, dtype=torch.int32), empty(b, s, s, 3)

        def run():
            err = fns["zbuffer_bucket_rows"](
                _ptr(verts), _ptr(fid), _ptr(starts), _ptr(fim), _ptr(wim),
                b, nf, s, tile, span, near, far, _stream())
            smoke.check(err == 0, f"zbuffer_bucket_rows: cudaError {err}")
            return fim, wim
        return run

    def flow(fns):
        fim, out = empty(b, s, s, dtype=torch.int32), empty(b, s, s, 2)

        def run():
            err = fns["zbuffer_bucket_flow"](
                _ptr(verts), _ptr(fid), _ptr(srcxy), _ptr(starts), _ptr(fim),
                _ptr(out), b, nf, s, tile, span, near, far, _stream())
            smoke.check(err == 0, f"zbuffer_bucket_flow: cudaError {err}")
            return fim, out
        return run

    geo = (s, tile, span, near, far)
    return (f"the 16 bench bodies ({nf} faces), batch 16, 256^2", {
        "zbuffer_bucket_rows": (rows, cr.zbuffer_bucket_rows_plain(
            verts, fid, starts, *geo)),
        "zbuffer_bucket_flow": (flow, cr.zbuffer_bucket_flow_plain(
            verts, fid, srcxy, starts, *geo))})


def tiles_cases(cr, rast, smpl_ops, dev):
    """(description, cases) of zbuffer_tiles: its path (16 posed 63,480-
    face bodies) and the 16 bench bodies."""
    import torch
    from impersonator_tpu_torch.assets import bench_assets, synthetic_assets
    from impersonator_tpu_torch.tasks.renderer import SMPLRenderer
    s = smoke.GEOM["s"]
    near, far = rast.DEFAULT_NEAR, rast.DEFAULT_FAR
    big = synthetic_assets(rings=24, segments=60)
    scenes = {}
    for name, assets, point in (
            ("path", big, SMPLRenderer.create(big, dev,
                                              image_size=s).tile_params()),
            ("bench", bench_assets(), smoke.TILES)):
        params = smpl_ops.SMPLParams.from_assets(assets, dev)
        _, fv = smoke.body_scene(assets, params, 16, dev, rast, smpl_ops)
        tile, cap, span = point
        scenes[name] = (rast._tiled_candidates(fv, s, tile, cap, span, far),
                        tile, assets.nf)

    def make(slots, tile):
        packed, cand, valid = slots
        b, nf, n_slots = packed.shape[0], packed.shape[1], cand.shape[-1]

        def bind(fns):
            fim = torch.empty((b, s, s), dtype=torch.int32, device=dev)
            wim = torch.empty((b, s, s, 3), device=dev)

            def run():
                err = fns["zbuffer_tiles"](
                    _ptr(packed), _ptr(cand), _ptr(valid), _ptr(fim),
                    _ptr(wim), b, nf, s, tile, n_slots, near, far, _stream())
                smoke.check(err == 0, f"zbuffer_tiles: cudaError {err}")
                return fim, wim
            return run
        return bind, cr.zbuffer_tiles_plain(packed, cand, valid, s, tile,
                                            near, far)

    return ("batch 16, 256^2: its path, 16 posed "
            f"{scenes['path'][2]}-face bodies at tile_params (8, 288, 2), "
            f"and the 16 bench bodies ({scenes['bench'][2]} faces) at "
            f"{smoke.TILES}", {
                f"zbuffer_tiles {name}": make(slots, tile)
                for name, (slots, tile, _) in scenes.items()})


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="bucket")
    ap.add_argument("--parent", type=Path,
                    help="another source of the same kernel to build and "
                         "time, e.g. an earlier commit's")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    smoke.check(torch.cuda.is_available(), "torch.cuda.is_available() is "
                                           "false")
    from impersonator_tpu_torch.ops import cuda_raster as cr
    from impersonator_tpu_torch.ops import rasterizer as rast
    from impersonator_tpu_torch.ops import smpl as smpl_ops

    smi = smoke.gpu_line()
    dev = torch.device("cuda")
    source = SOURCES[args.kernel]
    builds = {name: (cr.CSRC / source, flags)
              for name, flags in SWITCHES[args.kernel].items()}
    if args.parent is not None:
        builds["parent"] = (args.parent, ())
    built = build_all(cr, source, builds)
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem")):
                print(f"ptxas {name}: {line.strip()}")

    cases_of = bucket_cases if args.kernel == "bucket" else tiles_cases
    what, cases = cases_of(cr, rast, smpl_ops, dev)
    calls = {name: {case: bind(fns) for case, (bind, _) in cases.items()}
             for name, (fns, _) in built.items()}
    for name, fns in calls.items():
        for case, (_, want) in cases.items():
            got = fns[case]()
            torch.cuda.synchronize()
            smoke.check(all(torch.equal(g, w) for g, w in zip(got, want)),
                        f"{name} {case} differs from the plain twin")
    print(f"every build's outputs equal the plain twins' on {what}",
          flush=True)

    names = list(calls)
    dev_ms = {name: {case: [] for case in cases} for name in names}
    lone_ms = {name: {case: [] for case in cases} for name in names}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            for case in cases:
                fn = calls[name][case]
                dev_ms[name][case].append(smoke.device_ms(fn, 30))
                lone_ms[name][case].append(smoke.median_ms(fn, 50))

    def median(v):
        return sorted(v)[len(v) // 2]

    for case in cases:
        base = median(dev_ms["shipped"][case])
        for name in names:
            v, lone = dev_ms[name][case], lone_ms[name][case]
            print(f"{case} {name}: median {median(v):.4f} ms of device time "
                  f"per launch over {args.rounds} rounds ({min(v):.4f}–"
                  f"{max(v):.4f}), {median(v) / base:.3f}x the shipped "
                  f"build; a lone call {median(lone):.4f} ms ({min(lone):.4f}"
                  f"–{max(lone):.4f}); {what} [{smi}]")
    print(smi)
    print(json.dumps({"card": smi, "kernel": args.kernel,
                      "device_ms": dev_ms, "lone_ms": lone_ms}))


if __name__ == "__main__":
    main()
