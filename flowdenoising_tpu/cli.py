"""Command-line interface, flag-compatible with the reference
``flowdenoising.py`` (/root/reference/src/flowdenoising.py:384-415).

Usage:
    python -m flowdenoising_tpu -i vol.mrc -o denoised.mrc -s 2.0 2.0 2.0

All reference flags are accepted.  Flags that are meaningless for a
device-batched pipeline (-p/--number_of_processes, --use_threads, --use_GPU)
are accepted and ignored with an informational log, so existing scripts
keep working.  Additions: --boundary {wrap,mean,replicate}, --slab_size,
--devices, --dtype and the flow options below.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

from flowdenoising_tpu.config import Boundary, FilterConfig, FlowConfig
from flowdenoising_tpu.kernels import get_gaussian_kernels
from flowdenoising_tpu.utils.fingerprint import file_fingerprint
from flowdenoising_tpu.utils.logging import setup_logging, log_volume_stats
from flowdenoising_tpu.utils.profiler import PhaseProfiler

SIGMA = 2.0
OF_LEVELS = 3
OF_WINDOW_SIZE = 5


def int_or_str(text):
    try:
        return int(text)
    except ValueError:
        return text


def float_or_str(text):
    try:
        return float(text)
    except ValueError:
        return text


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-i", "--input", type=int_or_str, default="./volume.mrc",
                   help="Input a MRC-file or a multi-image TIFF-file")
    p.add_argument("-o", "--output", type=int_or_str, default="./denoised_volume.mrc",
                   help="Output a MRC-file or a multi-image TIFF-file")
    p.add_argument("-s", "--sigma", nargs="+", default=(SIGMA, SIGMA, SIGMA),
                   help="Gaussian sigma for each dimension in the order (Z, Y, X)")
    p.add_argument("-l", "--levels", type=int_or_str, default=OF_LEVELS,
                   help="Number of levels of the Gaussian pyramid used by the optical flow estimator")
    p.add_argument("-w", "--winsize", type=int_or_str, default=OF_WINDOW_SIZE,
                   help="Size of the window used by the optical flow estimator")
    p.add_argument("-v", "--verbosity", type=int_or_str, default=0, help="Verbosity level")
    p.add_argument("-n", "--no_OF", action="store_true",
                   help="Disable optical flow compensation")
    p.add_argument("-m", "--memory_map", action="store_true",
                   help="Enable memory-mapping of MRC input")
    p.add_argument("-p", "--number_of_processes", type=int_or_str, default=None,
                   help="Accepted for reference compatibility; scheduling is "
                        "device-driven")
    p.add_argument("--recompute_flow", action="store_true",
                   help="Disable the use of adjacent optical flow fields")
    p.add_argument("--show_fingerprint", action="store_true",
                   help="Show a hash of this file")
    # GPU-variant flags (flowdenoising_GPU.py:597-598), accepted so existing
    # scripts keep working: all compute runs on JAX's default device(s).
    p.add_argument("--use_GPU", action="store_true",
                   help="Accepted for reference compatibility; all compute "
                        "runs on JAX's default device(s)")
    p.add_argument("--use_threads", action="store_true",
                   help="Accepted for reference compatibility; scheduling is "
                        "device-driven")
    # Extensions
    p.add_argument("--boundary", choices=[b.value for b in Boundary], default=Boundary.WRAP.value,
                   help="Boundary mode along the filtered axis (reference main CLI: wrap; "
                        "sequential variant: mean)")
    p.add_argument("--slab_size", type=int, default=None,
                   help="Process each pass in slabs of this many output "
                        "slices to bound device memory use")
    p.add_argument("--devices", type=int, default=None,
                   help="Shard the volume over this many devices (default: all available)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="Optical-flow compute dtype")
    p.add_argument("--precision", choices=["float32", "bfloat16"], default="float32",
                   help="Ambient matmul precision of the flow computation.  "
                        "Every matmul on the flow path pins float32, so "
                        "bfloat16 currently changes no result")
    p.add_argument("--tap_flow", choices=["solve", "compose"],
                   default="solve",
                   help="Per-tap flow strategy: 'solve' = reference parity "
                        "(one Farneback solve per tap pair); 'compose' = solve "
                        "adjacent pairs only and chain flow fields (~8x fewer "
                        "solves).  (A 'compose_refine' mode was removed in "
                        "v0.5.0: measured at or below plain compose on every "
                        "quality tier at ~2x its cost -- see QUALITY.md)")
    p.add_argument("--max_displacement", type=int_or_str, default=None,
                   help="Per-tap flow sampling bound in pixels; motions "
                        "beyond it are clamped during sampling.  Default "
                        "'auto': probe the volume's motion scale and pick "
                        "the smallest lossless bound (core/autodisp.py; "
                        "QUALITY.md shows it recovering large-drift quality "
                        "AND speeding up calm data, no tier regressions).  "
                        "Pass an integer to fix the bound (the library "
                        "default is 8), or 0 for unbounded sampling (exact "
                        "cv2 semantics for any motion).  Multi-process "
                        "--coordinator "
                        "runs default to the fixed bound (the probe needs "
                        "the volume on one host)")
    p.add_argument("--flow_presmooth", type=float_or_str, default=0.0,
                   help="Estimate flows from a copy of the volume pre-"
                        "smoothed in-plane with this Gaussian sigma (px); "
                        "tap warps still sample the raw volume.  Suppresses "
                        "per-pixel flow noise on noisy inputs (faster "
                        "sampling AND usually better quality, QUALITY.md); "
                        "0 keeps exact reference operand semantics.  "
                        "'auto' measures the input's noise level and "
                        "enables presmooth only when it is clearly noisy "
                        "(core/noise.py policy)")
    p.add_argument("--symmetric_adjacent", action="store_true",
                   help="Compose modes: approximate backward chain links as "
                        "negated forward fields (halves the adjacent solves; "
                        "first-order exact for sub-pixel adjacent motion)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="Persist the volume after each completed axis pass here and "
                        "resume from the last completed pass on restart")
    p.add_argument("--stream", action="store_true",
                   help="Disk-streamed passes for volumes larger than host "
                        "RAM: the volume stays memory-mapped on disk and "
                        "each pass streams axis slabs through the device(s) "
                        "(scratch memmaps ping-pong between passes; "
                        "bitwise-identical to the in-memory pipeline).  "
                        "Composes with --devices: each slab window runs "
                        "ring-halo sharded over the mesh, so a >RAM volume "
                        "on one multi-chip host uses every chip")
    p.add_argument("--tiff_quantize", action="store_true",
                   help="Quantize TIFF output like the reference sequential "
                        "variant: uint8 if max < 256 else uint16 "
                        "(flowdenoising_sequential.py:566-571)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of the jax.distributed coordinator; "
                        "launch one CLI process per host with matching "
                        "--num_hosts/--host_id.  Each process memory-map-"
                        "reads only its Z shard of the input and writes "
                        "only its shards of the output (shared storage), "
                        "so no host ever materializes the full volume")
    p.add_argument("--num_hosts", type=int, default=1,
                   help="Total number of distributed CLI processes")
    p.add_argument("--host_id", type=int, default=None,
                   help="This process's index in [0, num_hosts)")
    return p


def _main_distributed(args, cfg, prof) -> int:
    """Multi-process file-to-file run: shard-wise ingest, global-mesh
    compute, shard-wise output (parallel/distributed.py).  No process ever
    materializes the full volume."""
    import jax

    from flowdenoising_tpu.io.mrc import read_mrc_header
    from flowdenoising_tpu.io.volume import is_mrc_input, is_mrc_output
    from flowdenoising_tpu.parallel.distributed import run_distributed
    from flowdenoising_tpu.utils.progress import ProgressReporter

    if not (is_mrc_input(args.input) and is_mrc_output(args.output)):
        raise SystemExit("--coordinator runs need MRC input AND output "
                         "(sharded file I/O); convert TIFF stacks first")

    kernels = get_gaussian_kernels(cfg.sigma)
    logging.info(
        f"length of each filter (Z, Y, X) = {[len(k) for k in kernels]}")
    devices = jax.devices()
    logging.info(f"JAX backend: {devices[0].platform} with {len(devices)} "
                 f"global device(s), process {jax.process_index()}"
                 f"/{jax.process_count()}")

    hdr = read_mrc_header(args.input)
    progress = ProgressReporter(total_units=int(sum(hdr.shape)))

    with prof.phase("filter"), progress:
        def on_pass(i, _v):
            progress.advance(hdr.shape[i])

        run_distributed(args.input, args.output, cfg, kernels=kernels,
                        on_pass=on_pass)
    prof.report()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.show_fingerprint:
        print("fingerprint =", file_fingerprint(__file__))

    setup_logging(args.verbosity if isinstance(args.verbosity, int) else 0)

    # Flag validation that must fail fast BEFORE the distributed runtime
    # comes up (a post-init abort would have every host connect first).
    if args.max_displacement is None:
        # default: auto-probe on single-host flow runs; the fixed library
        # bound for multi-process runs (probe needs the volume on one host)
        # and -n runs (no flow, nothing to probe)
        args.max_displacement = (8 if (args.coordinator or args.no_OF)
                                 else "auto")
    auto_disp = args.max_displacement == "auto"
    if isinstance(args.max_displacement, str) and not auto_disp:
        raise SystemExit(f"--max_displacement must be an integer or 'auto', "
                         f"got {args.max_displacement!r}")
    if auto_disp and args.coordinator:
        raise SystemExit("--max_displacement auto needs the input volume on "
                         "one host to probe; pass an explicit bound with "
                         "--coordinator runs")
    if auto_disp and args.no_OF:
        logging.info("--max_displacement auto ignored: flow compensation is "
                     "disabled (-n), no displacement probe runs")
    auto_presmooth = args.flow_presmooth == "auto"
    if isinstance(args.flow_presmooth, str) and not auto_presmooth:
        raise SystemExit(f"--flow_presmooth must be a number or 'auto', "
                         f"got {args.flow_presmooth!r}")
    if auto_presmooth and args.coordinator:
        raise SystemExit("--flow_presmooth auto needs the input volume on "
                         "one host to measure; pass an explicit sigma with "
                         "--coordinator runs")
    if auto_presmooth and args.no_OF:
        logging.info("--flow_presmooth auto ignored: flow compensation is "
                     "disabled (-n)")

    if args.coordinator:
        # multi-process mode: the distributed runtime must come up before
        # any other jax use (backend/device discovery)
        if args.host_id is None or not (0 <= args.host_id < args.num_hosts):
            raise SystemExit("--coordinator requires --num_hosts and a "
                             "--host_id in [0, num_hosts)")
        if args.stream or args.checkpoint_dir:
            raise SystemExit("--stream/--checkpoint_dir are not supported "
                             "with --coordinator (multi-process runs)")
        from flowdenoising_tpu.parallel.distributed import init_distributed
        init_distributed(args.coordinator, args.num_hosts, args.host_id)
    from flowdenoising_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    prof = PhaseProfiler()

    sigma = tuple(float(s) for s in args.sigma)
    if len(sigma) == 1:
        sigma = sigma * 3
    logging.info(f"sigma={sigma}")

    cfg = FilterConfig(
        sigma=sigma,
        boundary=Boundary(args.boundary),
        use_flow=not args.no_OF,
        flow=FlowConfig(
            levels=int(args.levels),
            winsize=int(args.winsize),
            use_initial_flow=not args.recompute_flow,
            dtype=args.dtype,
            precision=args.precision,
            tap_mode=args.tap_flow,
            symmetric_adjacent=args.symmetric_adjacent,
            presmooth=(0.0 if auto_presmooth else args.flow_presmooth),
            max_displacement=(8 if auto_disp else
                              args.max_displacement
                              if args.max_displacement > 0 else None),
        ),
        slab_size=args.slab_size,
    )
    if args.recompute_flow:
        logging.info("No reusing adjacent OF fields as predictions")
    else:
        logging.info("Using adjacent OF fields as predictions")
    if args.number_of_processes is not None:
        logging.info(f"-p {args.number_of_processes} accepted for reference "
                     "compatibility; scheduling is device-driven")
    if args.use_GPU or args.use_threads:
        logging.info("--use_GPU/--use_threads accepted for reference "
                     "compatibility; all compute runs on JAX's default "
                     "device(s)")

    if args.coordinator:
        return _main_distributed(args, cfg, prof)

    from flowdenoising_tpu.io.volume import (
        is_mrc_input, read_volume, write_volume)

    if isinstance(args.input, str) and not os.path.exists(args.input):
        raise SystemExit(f"input volume not found: {args.input}")
    out_dir = os.path.dirname(os.path.abspath(str(args.output)))
    if not os.path.isdir(out_dir):
        raise SystemExit(f"output directory does not exist: {out_dir}")

    # Preserve the input's pixel calibration (MRC CELLA -> voxel size) into
    # the output header; the reference drops it (mrcfile.new writes cell 0).
    voxel_size = None
    if is_mrc_input(args.input) and os.path.exists(str(args.input)):
        from flowdenoising_tpu.io.mrc import read_mrc_header
        try:
            voxel_size = read_mrc_header(args.input).voxel_size
        except Exception:
            voxel_size = None

    # Start the probe programs' load/compile BEFORE the volume read, so
    # it overlaps the read + stats below; the MRC header alone tells which
    # programs THIS volume's probe will need (expected_probe_shapes).
    probe_warm = None
    if auto_disp and cfg.use_flow and is_mrc_input(args.input):
        from flowdenoising_tpu.core.autodisp import warm_probe_programs_async
        from flowdenoising_tpu.io.mrc import read_mrc_header
        probe_warm = warm_probe_programs_async(
            cfg.flow, tuple(read_mrc_header(args.input).shape))

    with prof.phase("read"):
        # as_f32 takes the native libfdio fused decode/convert path for MRC
        # (the pipeline always consumes float32).  Streamed mode keeps the
        # volume memory-mapped on disk in its stored dtype; windows are
        # converted per slab.
        if args.stream:
            vol = read_volume(args.input, memory_map=True)
        else:
            vol = read_volume(args.input, memory_map=args.memory_map,
                              as_f32=True)
    log_volume_stats(str(args.input), vol)

    if auto_disp and cfg.use_flow:
        from flowdenoising_tpu.core.autodisp import resolve_auto_displacement
        with prof.phase("probe"):
            if probe_warm is not None:
                probe_warm.join()
            cfg = resolve_auto_displacement(vol, cfg)
    if auto_presmooth and cfg.use_flow:
        from flowdenoising_tpu.core.noise import resolve_auto_presmooth
        cfg = resolve_auto_presmooth(vol, cfg)

    kernels = get_gaussian_kernels(sigma)
    logging.info(f"length of each filter (Z, Y, X) = {[len(k) for k in kernels]}")

    import jax
    devices = jax.devices()
    logging.info(f"JAX backend: {devices[0].platform} with {len(devices)} device(s)")
    n_devices = args.devices or len(devices)

    ckpt = None
    start_pass, start_vol, mean_val = 0, np.asarray(vol), None
    if args.checkpoint_dir and args.stream:
        logging.warning("--checkpoint_dir is ignored with --stream (the "
                        "streamed scratch files already persist per pass)")
        args.checkpoint_dir = None
    if args.checkpoint_dir:
        from flowdenoising_tpu.utils.checkpoint import CheckpointManager
        ckpt = CheckpointManager(args.checkpoint_dir, cfg, np.asarray(vol))
        resumed = ckpt.load_latest()
        if resumed is not None:
            start_pass, start_vol, mean_val = resumed

    from flowdenoising_tpu.utils.progress import ProgressReporter
    # One unit per output slice per pass, like the reference feedback
    # thread's percent = 100*progress/(Z+Y+X) (flowdenoising.py:292-295).
    progress = ProgressReporter(total_units=int(sum(np.asarray(vol).shape)))
    progress.advance(sum(np.asarray(vol).shape[i] for i in range(start_pass)))

    verbosity = args.verbosity if isinstance(args.verbosity, int) else 0
    # -v 2: trace the ACTUAL run for the measured per-stage report
    # (successor of the reference's in-run OFE/warping/convolution
    # accumulators, flowdenoising_GPU.py:760-766).
    import contextlib
    trace_ctx = contextlib.nullcontext({})
    if verbosity >= 2:
        from flowdenoising_tpu.utils.trace_report import traced_run
        trace_ctx = traced_run()

    with prof.phase("filter"), progress, trace_ctx as trace_state:
        def on_pass(i, v):
            progress.advance(np.asarray(vol).shape[i])
            if ckpt is not None:
                ckpt.save_pass(i, v)

        if args.stream:
            from flowdenoising_tpu.core.stream import denoise_streamed
            state = {"done": 0}

            def stream_progress(done, total):
                progress.advance(done - state["done"])
                state["done"] = done

            # >host-RAM x multi-chip composition: slabs stream from disk
            # and each window's pass runs ring-halo sharded over the mesh
            # (parallel.mesh.sharded_window_pass).  Sharding engages only
            # on an EXPLICIT --devices: single-device streaming is
            # documented bitwise-identical to the in-memory pipeline, and
            # the sharded program's float reassociation can differ by
            # 1-2 ulp on some backends/shapes.
            filtered = denoise_streamed(vol, cfg, kernels=kernels,
                                        slab_size=args.slab_size,
                                        progress=stream_progress,
                                        n_devices=(args.devices or 1))
            # final pass lives in a scratch memmap; remove its temp dir
            # once the output file has been written
            stream_scratch = getattr(filtered, "filename", None)
        elif n_devices > 1:
            from flowdenoising_tpu.parallel.mesh import denoise_sharded
            filtered = denoise_sharded(start_vol, cfg, kernels=kernels,
                                       n_devices=n_devices,
                                       start_pass=start_pass,
                                       mean_val=mean_val, on_pass=on_pass)
        else:
            from flowdenoising_tpu.core.pipeline import denoise
            filtered = denoise(start_vol, cfg, kernels=kernels,
                               start_pass=start_pass, mean_val=mean_val,
                               on_pass=on_pass)
        filtered = np.asarray(filtered)
    if ckpt is not None:
        ckpt.clear()

    log_volume_stats(str(args.output), filtered)

    with prof.phase("write"):
        write_volume(args.output, filtered, quantize=args.tiff_quantize,
                     voxel_size=voxel_size)
    if args.stream and stream_scratch is not None:
        import shutil
        del filtered
        shutil.rmtree(os.path.dirname(stream_scratch), ignore_errors=True)

    prof.report()

    if verbosity >= 2:
        # Per-stage device-time split (successor of the reference's
        # OFE/warping/convolution report, flowdenoising_GPU.py:760-766),
        # MEASURED from the run's profiler trace.
        import shutil
        from flowdenoising_tpu.utils.trace_report import measured_stage_report
        measured_stage_report(trace_state["log_dir"])
        # the trace export can run to hundreds of MB on big volumes
        shutil.rmtree(trace_state["log_dir"], ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
