#!/usr/bin/env python
"""Smoke test of the denoiser on NVIDIA GPUs: every phase must pass.

    python chip_smoke.py [--seed 0]   # one card
    python chip_smoke.py --four       # only the four-card phase

One card:

(a) device check: JAX's platform must be "gpu" (a child process, so the
    CLI runs below get the card to themselves);
(c) CLI end to end on a synthetic 160x512x512 int16 MRC tomogram (the
    upstream pamper_me.sh shape) with the upstream defaults, cold then warm
    compile cache, each in its own process; checks the output file and that
    denoising raises the PSNR against the clean phantom;
(e) one traced ``-v 2`` CLI run whose measured stage report is non-empty;
(d) ``denoise`` on the GPU against the same ``denoise`` on the host CPU
    backend at 32x512x512, parity (solve) and compose tap modes;
(b) the flow kernels at 512x512 planes against the NumPy references
    (tests/oracle_np.py).

Each child and each phase reports the slab model's predicted device working
set next to the measured ``peak_bytes_in_use``; the model must not
under-predict.  ``--four`` runs only ``denoise_sharded`` on four cards
against single-card ``denoise``, and the CLI with ``--devices 4``.

The card's name and power limit (nvidia-smi) are printed before the last
line; the last line of stdout is one JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
A failed phase prints ``FAILED`` with its reason, no such line, and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "smoke_work")   # gitignored scratch
CHILD_TIMEOUT_S = 600
TAG = "SMOKE_CHILD "
# Volume shapes (Z, Y, X) of the phases.
TOMO = (160, 512, 512)      # (c), (e): the pamper_me.sh tomogram
VS_CPU = (32, 512, 512)     # (d)
KERNELS = (8, 512, 512)     # (b): batch of 512x512 planes
# four cards: CLI --devices 4, then denoise_sharded on the same shape and
# config (the parent loads the child's sharded programs from the cache)
SHARDED = (64, 512, 512)


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def say(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    """Card name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise PhaseFailed(f"nvidia-smi unavailable: {e}")
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


# ---------------------------------------------------------------- children

def _device_child():
    import jax
    devs = jax.devices()
    print(TAG + json.dumps({
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs), "jax": jax.__version__,
        "XLA_FLAGS": os.environ.get("XLA_FLAGS", "")}), flush=True)


def _cli_child(cli_args):
    """Run the CLI in this process; report wall time, compile activity and
    device memory as one JSON line."""
    from jax import monitoring
    comp = {"backend_compile_s": 0.0, "compiles": 0, "cache_hits": 0,
            "cache_misses": 0}

    def on_duration(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            comp["backend_compile_s"] += duration
            comp["compiles"] += 1

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            comp["cache_hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            comp["cache_misses"] += 1

    monitoring.register_event_duration_secs_listener(on_duration)
    monitoring.register_event_listener(on_event)

    import jax
    from flowdenoising_tpu import cli
    from flowdenoising_tpu.config import FilterConfig, FlowConfig
    from flowdenoising_tpu.core.pipeline import predicted_peak_bytes
    from flowdenoising_tpu.io.mrc import read_mrc_header

    t0 = time.perf_counter()
    rc = cli.main(cli_args)
    wall = time.perf_counter() - t0
    shape = read_mrc_header(cli_args[cli_args.index("-i") + 1]).shape
    cfg = FilterConfig(sigma=(2.0,) * 3, flow=FlowConfig(levels=3, winsize=5))
    stats = jax.devices()[0].memory_stats() or {}
    print(TAG + json.dumps({
        "rc": rc, "wall_s": wall, "compile": comp,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "bytes_limit": stats.get("bytes_limit"),
        "predicted_bytes": predicted_peak_bytes(cfg, shape),
        "cache_dir": jax.config.jax_compilation_cache_dir}), flush=True)


def run_child(args, env=None, timeout=CHILD_TIMEOUT_S):
    """Run ``chip_smoke.py --child ...``; returns (record, stderr)."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child"] + args
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=timeout, cwd=REPO)
    except subprocess.TimeoutExpired:
        raise PhaseFailed(f"child {args[:1]} exceeded {timeout} s")
    recs = [line[len(TAG):] for line in p.stdout.splitlines()
            if line.startswith(TAG)]
    check(p.returncode == 0 and recs,
          f"child {args[:1]} failed (rc {p.returncode}):\n"
          f"{p.stderr[-3000:]}")
    return json.loads(recs[-1]), p.stderr


# ---------------------------------------------------------------- data

def phantom(n, h, w, seed):
    """(clean, noisy) float32 volumes: a drifting blob field (the bench
    volume's structure) and the same plus Gaussian noise."""
    sys.path.insert(0, REPO)
    from bench import _blob_params
    pad, blobs, iys, ixs = _blob_params(n, h, w, seed)
    yy, xx = np.mgrid[0:h + 2 * pad, 0:w + 2 * pad]
    base = np.zeros((h + 2 * pad, w + 2 * pad), np.float32)
    for cy, cx, rad, amp in blobs:
        base += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                             / (2 * rad * rad))
    clean = np.stack([base[iys[z]:iys[z] + h, ixs[z]:ixs[z] + w]
                      for z in range(n)]).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    noisy = clean + 25.0 * rng.standard_normal(clean.shape, np.float32)
    return clean, noisy


def psnr(x, ref):
    mse = float(np.mean((np.asarray(x, np.float64) - ref) ** 2))
    rng = float(ref.max() - ref.min())
    return 10.0 * np.log10(rng * rng / mse)


def parse_phases(stderr):
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[profile\] (\w+): ([0-9.]+)s", stderr)}


def rel_diffs(a, b, ref):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    rng = float(ref.max() - ref.min())
    return float(d.max() / rng), float(np.percentile(d, 99.9) / rng)


def memory_line(label, predicted, peak):
    check(peak is not None, f"{label}: device reports no peak_bytes_in_use")
    say(f"  memory {label}: model {predicted / 2**30:.3f} GiB, "
        f"measured peak {peak / 2**30:.3f} GiB "
        f"(model/peak {predicted / peak:.2f})")
    check(predicted >= peak,
          f"{label}: slab model under-predicts the device peak")


# ---------------------------------------------------------------- phases

def phase_device(want_count):
    dev, _ = run_child(["device"])
    say(f"(a) JAX {dev['jax']} platform={dev['platform']} "
        f"kind={dev['kind']} count={dev['count']} "
        f"XLA_FLAGS={dev['XLA_FLAGS']!r}")
    check(dev["platform"] == "gpu",
          f"JAX platform is {dev['platform']!r}, not 'gpu'")
    check(dev["count"] >= want_count,
          f"need {want_count} GPUs, JAX sees {dev['count']}")
    return dev


def write_tomogram(seed, shape):
    from flowdenoising_tpu.io.mrc import write_mrc
    clean, noisy = phantom(*shape, seed=seed)
    path = os.path.join(WORK, "tomo_{}x{}x{}.mrc".format(*shape))
    write_mrc(path, np.clip(np.rint(noisy), -32768, 32767).astype(np.int16),
              voxel_size=(2.5, 2.5, 2.5))
    return path, clean


def check_output(inp, out, clean):
    from flowdenoising_tpu.io.mrc import read_mrc, read_mrc_header
    data, hdr = read_mrc(out)
    hin = read_mrc_header(inp)
    check(hdr.shape == hin.shape, f"output shape {hdr.shape} != {hin.shape}")
    check(hdr.mode == 2, f"output MRC mode {hdr.mode}, expected 2 (float32)")
    check(hdr.voxel_size is not None
          and np.allclose(hdr.voxel_size, hin.voxel_size),
          f"voxel size {hdr.voxel_size} != input {hin.voxel_size}")
    check(np.isfinite(data).all(), "output has non-finite values")
    noisy, _ = read_mrc(inp)
    p_in, p_out = psnr(noisy, clean), psnr(data, clean)
    say(f"  PSNR vs clean phantom: noisy {p_in:.2f} dB -> denoised "
        f"{p_out:.2f} dB")
    check(p_out > p_in, "denoising did not raise the PSNR")


def phase_cli(seed):
    say("(c) CLI end to end, {}x{}x{} int16 MRC, -s 2 -l 3 -w 5, "
        "--max_displacement auto".format(*TOMO))
    inp, clean = write_tomogram(seed, TOMO)
    out = os.path.join(WORK, "tomo_denoised.mrc")
    env = dict(os.environ)
    preset = "JAX_COMPILATION_CACHE_DIR" in env
    if not preset:
        # a cache of the smoke's own, emptied so the first run is cold
        env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(WORK, "jax_cache")
        shutil.rmtree(env["JAX_COMPILATION_CACHE_DIR"], ignore_errors=True)
    args = ["-i", inp, "-o", out, "-s", "2", "-l", "3", "-w", "5",
            "--max_displacement", "auto", "-v", "1"]
    runs = {}
    for label in ("cold", "warm"):
        if os.path.exists(out):
            os.remove(out)
        rec, err = run_child(["cli"] + args, env=env)
        check(rec["rc"] == 0, f"CLI {label} run returned {rec['rc']}")
        runs[label] = rec
        c = rec["compile"]
        say(f"  {label}: wall {rec['wall_s']:.3f} s, phases "
            f"{parse_phases(err)}, backend compile "
            f"{c['backend_compile_s']:.3f} s over {c['compiles']} programs, "
            f"persistent cache hits "
            f"{c['cache_hits']} misses {c['cache_misses']}")
        memory_line(f"CLI {label}", rec["predicted_bytes"],
                    rec["peak_bytes_in_use"])
        check_output(inp, out, clean)
    say(f"  cache dir {runs['warm']['cache_dir']}"
        f"{' (preset by the environment)' if preset else ''}")
    cold, warm = runs["cold"]["compile"], runs["warm"]["compile"]
    check(warm["cache_hits"] > 0, "warm run found nothing in the cache")
    if cold["cache_misses"]:
        check(warm["backend_compile_s"] < 0.5 * cold["backend_compile_s"],
              "warm run did not compile measurably less than the cold one")
    return inp, env


def phase_traced(inp, env):
    say("(e) traced -v 2 CLI run")
    out = os.path.join(WORK, "tomo_traced.mrc")
    rec, err = run_child(["cli", "-i", inp, "-o", out, "-s", "2", "-l", "3",
                          "-w", "5", "--max_displacement", "auto",
                          "-v", "2"], env=env)
    lines = [ln.split("[stages]", 1)[1].rstrip() for ln in err.splitlines()
             if "[stages]" in ln]
    for ln in lines:
        say("  " + ln)
    check(lines and "MEASURED" in lines[0],
          "the -v 2 run printed no measured stage report")
    secs = [float(m.group(1)) for ln in lines[1:]
            for m in [re.search(r"\s([0-9.]+)s", ln)] if m]
    check(secs and max(secs) > 0, "measured stage report is empty")


def phase_gpu_vs_cpu(seed):
    import jax
    from flowdenoising_tpu.config import FilterConfig, FlowConfig
    from flowdenoising_tpu.core.pipeline import denoise, predicted_peak_bytes

    say("(d) GPU denoise vs host-CPU denoise, {}x{}x{} (bound: max |diff| "
        "<= 1e-2 and 99.9th percentile <= 1e-3 of the data range; the "
        "backends reassociate float32 sums and round transcendentals "
        "differently, which the iterative flow solve can amplify at "
        "ill-conditioned pixels)".format(*VS_CPU))
    _, vol = phantom(*VS_CPU, seed=seed + 7)
    cpu = jax.devices("cpu")[0]
    predicted = 0
    for mode in ("solve", "compose"):
        cfg = FilterConfig(sigma=(2.0,) * 3,
                           flow=FlowConfig(levels=3, winsize=5,
                                           tap_mode=mode))
        jax.block_until_ready(denoise(vol, cfg))  # compile
        t0 = time.perf_counter()
        g = np.asarray(jax.block_until_ready(denoise(vol, cfg)))
        t_gpu = time.perf_counter() - t0
        with jax.default_device(cpu):
            t0 = time.perf_counter()
            c = np.asarray(denoise(vol, cfg))
            t_cpu = time.perf_counter() - t0
        check(np.isfinite(g).all(), f"{mode}: non-finite GPU output")
        mx, p999 = rel_diffs(g, c, vol)
        say(f"  {mode}: GPU {t_gpu:.4f} s (warm), CPU backend {t_cpu:.2f} s "
            f"(incl. compile); |GPU-CPU|/range max {mx:.3e}, "
            f"p99.9 {p999:.3e}")
        check(mx <= 1e-2 and p999 <= 1e-3, f"{mode}: GPU and CPU disagree")
        predicted = max(predicted, predicted_peak_bytes(cfg, vol.shape))
        memory_line(f"denoise {mode} (process peak so far)", predicted,
                    (jax.devices()[0].memory_stats() or {}).get(
                        "peak_bytes_in_use"))


def phase_kernels(seed):
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle_np as O
    from flowdenoising_tpu.ops.farneback import (
        poly_expand, update_flow, update_matrices)
    from flowdenoising_tpu.ops.resize import (
        linear_resize_matrix, resize_linear)
    from flowdenoising_tpu.ops.warp import displace_sample

    b, h, w = KERNELS
    say(f"(b) kernels at {h}x{w}, batch {b}, vs NumPy float64 references")
    clean, _ = phantom(b, h, w, seed + 3)
    rng = np.random.default_rng(seed)
    span = float(clean.max() - clean.min())
    img = jnp.asarray(clean)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    # Tolerance 1e-5 of the data range: the f32 coordinate x+u carries up to
    # half an ulp of 512 (3e-5 px), times the phantom's steepest gradient
    # (< 50 per px) -- ~1.5e-6 of its range -- plus a few f32 roundings.
    for d in (4, 8, 24):
        u = rng.uniform(-2 * d, 2 * d, size=(b, h, w)).astype(np.float32)
        v = rng.uniform(-2 * d, 2 * d, size=(b, h, w)).astype(np.float32)
        uc, vc = np.clip(u, -d, d), np.clip(v, -d, d)
        want = O.bilinear_sample(clean, gx + uc, gy + vc)
        got = np.asarray(jax.jit(
            lambda s, a, b_, dd=d: displace_sample(s, a, b_, dd))(
                img, jnp.asarray(u), jnp.asarray(v)))
        err = float(np.abs(got - want).max()) / span
        say(f"  displace_sample D={d:2d} (flows to 2D, clamped): "
            f"max |diff|/range {err:.3e} (bound 1e-5)")
        check(err <= 1e-5, f"displace_sample D={d} disagrees")

    # TF32 check: the resize matmuls pin HIGHEST; a TF32 product would
    # miss the float64 reference by ~1e-3 relative.
    wr = linear_resize_matrix(h, h // 2)
    wc = linear_resize_matrix(w, w // 2)
    got = np.asarray(resize_linear(img, (h // 2, w // 2)))
    want = np.einsum("hH,nHW,wW->nhw", wr, clean.astype(np.float64), wc)
    err = float(np.abs(got - want).max()) / span
    say(f"  resize_linear (matmul) max |diff|/range {err:.3e} "
        "(bound 1e-5: TF32 would show ~1e-3)")
    check(err <= 1e-5, "resize matmul is not full float32 (TF32?)")

    # Farneback stages vs oracle_np on one 512x512 plane (the oracle is a
    # per-pixel Python loop); the JAX call runs the whole batch.
    r = np.asarray(jax.jit(poly_expand)(img))
    want = O.poly_expand(clean[0].astype(np.float64))
    err = float(np.abs(r[0] - want).max() / np.abs(want).max())
    say(f"  poly_expand max |diff|/max|ref| {err:.3e} (bound 1e-5: two "
        "11-tap f32 correlations)")
    check(err <= 1e-5, "poly_expand disagrees with the oracle")

    r1 = np.asarray(jax.jit(poly_expand)(jnp.roll(img, (1, -2), (1, 2))))
    flow = rng.uniform(-3, 3, size=(b, h, w, 2)).astype(np.float32)
    m = np.asarray(jax.jit(lambda a, b, f: update_matrices(a, b, f, 9))(
        jnp.asarray(r), jnp.asarray(r1), jnp.asarray(flow)))
    want_m = O.update_matrices(r[0].astype(np.float64),
                               r1[0].astype(np.float64),
                               flow[0].astype(np.float64))
    err = float(np.abs(m[0] - want_m).max() / np.abs(want_m).max())
    say(f"  update_matrices (D=9, |flow|<=3) max |diff|/max|ref| {err:.3e} "
        "(bound 1e-4: products of f32 sampled expansions)")
    check(err <= 1e-4, "update_matrices disagrees with the oracle")

    f = np.asarray(jax.jit(lambda mm: update_flow(mm, 5))(
        jnp.asarray(want_m[None].astype(np.float32))))[0]
    want_f = O.update_flow(want_m, 5)
    err = float(np.abs(f - want_f).max() / np.abs(want_f).max())
    say(f"  update_flow (winsize 5) max |diff|/max|ref| {err:.3e} "
        "(bound 1e-3: 25-term f32 box sums through a regularized 2x2 "
        "solve)")
    check(err <= 1e-3, "update_flow disagrees with the oracle")


def phase_four(seed):
    import jax
    from flowdenoising_tpu.config import FilterConfig, FlowConfig
    from flowdenoising_tpu.core.pipeline import denoise
    from flowdenoising_tpu.parallel.mesh import denoise_sharded

    say("(4) denoise_sharded on 4 GPUs vs single-card denoise, {}x{}x{} "
        "(bound: max |diff| <= 1e-3 of the range: only float "
        "reassociation differs)".format(*SHARDED))
    _, vol = phantom(*SHARDED, seed=seed + 11)
    cfg = FilterConfig(sigma=(2.0,) * 3, flow=FlowConfig(levels=3, winsize=5))
    one = np.asarray(jax.block_until_ready(denoise(vol, cfg)))
    t0 = time.perf_counter()
    one = np.asarray(jax.block_until_ready(denoise(vol, cfg)))
    t_one = time.perf_counter() - t0
    sharded = np.asarray(denoise_sharded(vol, cfg, n_devices=4))
    t0 = time.perf_counter()
    sharded = np.asarray(jax.block_until_ready(
        denoise_sharded(vol, cfg, n_devices=4)))
    t_four = time.perf_counter() - t0
    mx, p999 = rel_diffs(sharded, one, vol)
    say(f"  single card {t_one:.4f} s, 4 cards {t_four:.4f} s (warm, host "
        f"arrays in and out); |4-1|/range max {mx:.3e}, p99.9 {p999:.3e}")
    check(np.isfinite(sharded).all(), "non-finite sharded output")
    check(mx <= 1e-3, "sharded and single-card denoise disagree")


def phase_cli_four(seed):
    say("(4) CLI --devices 4, {}x{}x{} int16 MRC, --max_displacement 8"
        .format(*SHARDED))
    inp, clean = write_tomogram(seed, SHARDED)
    out = os.path.join(WORK, "tomo4_denoised.mrc")
    rec, err = run_child(["cli", "-i", inp, "-o", out, "-s", "2", "-l", "3",
                          "-w", "5", "--max_displacement", "8",
                          "--devices", "4", "-v", "1"])
    check(rec["rc"] == 0, f"CLI --devices 4 returned {rec['rc']}")
    check("4 device(s)" in err, "CLI did not see 4 devices")
    say(f"  wall {rec['wall_s']:.3f} s, phases {parse_phases(err)}")
    check_output(inp, out, clean)


# ---------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--child", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        kind, rest = args.child[0], args.child[1:]
        if kind == "device":
            return _device_child()
        return _cli_child(rest)

    os.makedirs(WORK, exist_ok=True)
    t_start = time.perf_counter()
    try:
        card = gpu_line()
        say(f"card: {card}")
        phase_device(4 if args.four else 1)
        if args.four:
            phase_cli_four(args.seed)
            phase_four(args.seed)
        else:
            inp, env = phase_cli(args.seed)
            phase_traced(inp, env)
            phase_gpu_vs_cpu(args.seed)
            phase_kernels(args.seed)
        import jax
        devs = jax.devices()
        check(devs[0].platform == "gpu", "parent process is not on a GPU")
    except PhaseFailed as e:
        say(f"FAILED: {e}")
        return 1
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(gpu_line())
    say(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
