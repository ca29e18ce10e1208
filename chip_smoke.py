#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout (it imports ``src/repro_torch``, never JAX
or the JAX package) and needs one CUDA card; with no card, or without the
rest of the repository, it exits non-zero before printing any result.

Phases, in order; any failure ends the run with a non-zero exit:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   TF32 off for matmuls and convolutions;
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once);
3. each kernel against its plain PyTorch version on the card at the
   shapes of pquant-1.3b's decode path, M in {1, 4, 5, 8, 32}: outputs must
   agree within rtol 1e-6 (the kernels are built to agree bit for bit);
   prints the kernel's median time (CUDA events, weights rotated through
   more copies than the 50 MB L2 holds), the plain version's, the bound
   (bytes over the card's memory rate, or operations over its int8 rate)
   and, where one PyTorch call computes the same product, its time;
4. the slice at full width: pquant-1.3b from a fixed seed, exported packed,
   served by ``DecodeEngine`` to 4 requests of 8-token prompts (prefill M =
   32 rows) with 32 greedy new tokens.  Checks finite logits, one host
   transfer per call, the launch count of every kernel (layers x (5, 2, 1)
   x forwards) and a repeatable stream; prints TTFT, decode tokens/s and
   the time per step (medians of 5 runs), and the device's busy share and
   kernel time by name from torch.profiler;
5. the same export cut to 2 layers on the card and on the CPU (plain
   versions): prefill logits allclose within the stated tolerance, equal
   greedy streams;
6. the status of every TPU kernel of the JAX package (ported and checked,
   or still to port).

The line before the last is the JSON record of the ported kernels; the
last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --pairs OTHER_CHECKOUT N

times phase 4's decode path of this checkout against another one (say, a
``git archive`` of the parent commit unpacked under ``_checkouts/``) in N
alternating pairs of fresh processes, and prints the comparison as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# pquant-1.3b decode-path shapes: (name, K, N[, r]) and the token rows
W1A8_SHAPES = ((2048, 2048), (5024, 2048))  # q/k/v/o; w1_down
DECOUPLED_SHAPE = (2048, 5024, 384)  # up/gate pairs: K, N, r
INT8_SHAPE = (384, 2048)  # w8_down: K, N
ROWS = (1, 4, 5, 8, 32)
MAIN_ROWS = 4  # decode rows of the main path (4 requests)
RTOL = 1e-6  # kernel vs plain version (built to agree exactly)

# end-to-end run
BATCH, PROMPT, NEW_TOKENS = 4, 8, 32
TIMED_RUNS = 5
CUT_LAYERS, CUT_NEW_TOKENS = 2, 8
# card vs CPU logits: the float ops around the kernels (norms, attention,
# SiLU, unembedding) round differently on the two devices, and a last-ulp
# difference ahead of a per-token int8 quantization can move one code by
# one step; that shifts logits by far less than this share of their range
LOGIT_TOL = 1e-3

# every pl.pallas_call of the JAX package: (name, file:line, ported by this path)
TPU_KERNELS = (
    ("w1a8_gemv", "src/repro/kernels/w1a8_gemv.py:119", "src/repro_torch/csrc/w1a8_gemv.cu"),
    ("decoupled_gemv", "src/repro/kernels/w1a8_gemv.py:223", "src/repro_torch/csrc/w1a8_gemv.cu"),
    ("int8_matmul", "src/repro/kernels/int8_matmul.py:61", "src/repro_torch/csrc/int8_matmul.cu"),
    ("w1a8_matmul", "src/repro/kernels/w1a8_matmul.py:92", None),
    ("decoupled_matmul", "src/repro/kernels/decoupled_matmul.py:108", None),
    ("paged_attention", "src/repro/kernels/paged_attention.py:227", None),
    ("rmsnorm_quant", "src/repro/kernels/rmsnorm_quant.py:51", None),
)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: the card
# ---------------------------------------------------------------------------


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[1] card: {name} x{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}; TF32 off")
    # published dense peaks (NVIDIA data sheets): bytes/s, int8 ops/s
    peaks = (2.0e12, 1513e12) if "PCIe" in name else (3.35e12, 1979e12)
    log(f"[1] bound peaks: {peaks[0] / 1e12} TB/s, {peaks[1] / 1e12} int8 TOP/s")
    return smi, name, peaks


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _time(torch, fn, iters: int, reps: int = 7) -> float:
    """Device time of one call in ms: the median over ``reps`` of the mean
    of ``iters`` back-to-back calls between two CUDA events; ``fn(i)`` is
    the i-th call.  A spin kernel queued first keeps the device busy while
    the host enqueues the calls, so the events time the device's work and
    not the host's launch rate."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        # ~0.25 ms of spinning per call queued: more than the host takes to
        # issue one (15-125 us measured), or the device would idle between calls
        torch.cuda._sleep(iters * 500_000)
        e0.record()
        for i in range(iters):
            fn(i)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


def _host_us(torch, fn, iters: int = 100) -> float:
    """Host time to issue one call, in microseconds (the wrapper's checks,
    allocation and launch), with the device kept busy so nothing waits."""
    torch.cuda.synchronize()
    torch.cuda._sleep(iters * 500_000)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def _copies(nbytes: int) -> int:
    """Weight copies to rotate through so that each call finds its weights
    outside the 50 MB L2, as a decode step does (197 MB of weights)."""
    return max(2, -(-120 * 2**20 // nbytes))


def _close(a, b) -> float:
    """max |a - b|; raises unless |a - b| <= RTOL * |b| everywhere."""
    import torch

    err = (a - b).abs()
    if not torch.all(err <= RTOL * b.abs()):
        raise AssertionError(f"kernel disagrees with its plain version: max |err| {err.max().item()}")
    return err.max().item()


def phase_kernels(torch, peaks):
    from repro_torch.kernels import w1a8_gemv as wg
    from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain

    bw, ops_rate = peaks
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f32 = dict(dtype=torch.float32, device=dev)

    def scalar(v):
        return torch.full((), v, **f32)

    def packed(k, n):
        return torch.randint(0, 256, (k // 8, n), generator=gen, device=dev, dtype=torch.uint8)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def bound(nbytes, nops):
        t_b, t_o = nbytes / bw * 1e3, nops / ops_rate * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    results = {}

    def record(name, m, shape, err, call, plain_call, b, library_call=None):
        ms = _time(torch, call, 200)
        host_us = _host_us(torch, call)
        plain_ms = _time(torch, plain_call, 3, 3)
        library_ms = None if library_call is None else _time(torch, library_call, 200)
        log(f"[3] {name} M={m} {shape}: max|err| {err:.3g}, kernel {ms * 1e3:.2f} us "
            f"(host {host_us:.1f} us/call), plain {plain_ms * 1e3:.1f} us, "
            f"bound {b[0] * 1e3:.3f} us ({b[1]}), "
            f"library {'none' if library_ms is None else f'{library_ms * 1e3:.2f} us'}")
        r = results.setdefault(name, {"max_abs_err": 0.0, "rows": {}})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["rows"][(m,) + shape] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                                       bound_by=b[1], library_ms=library_ms,
                                       host_us=host_us)

    lam = scalar(0.031)
    for k, n in W1A8_SHAPES:
        ws = [packed(k, n) for _ in range(_copies(k // 8 * n))]
        for m in ROWS:
            x = torch.randn((m, k), generator=gen, **f32)
            err = _close(wg.w1a8_gemv(x, ws[0], lam), wg.w1a8_gemv_plain(x, ws[0], lam))
            b = bound(m * k * 4 + k // 8 * n + 4 + m * n * 4, 2 * m * k * n)
            record("w1a8_gemv", m, (k, n), err,
                   lambda i: wg.w1a8_gemv(x, ws[i % len(ws)], lam),
                   lambda i: wg.w1a8_gemv_plain(x, ws[0], lam), b)

    k, n, r = DECOUPLED_SHAPE
    w1s = [packed(k, n) for _ in range(_copies(k // 8 * n + k * r))]
    w8s = [int8(k, r) for _ in w1s]
    sc = [scalar(0.027), scalar(1 / 0.0021), scalar(1.0), scalar(1.0)]
    for m in ROWS:
        x = torch.randn((m, k), generator=gen, **f32)
        got = wg.decoupled_gemv(x, w1s[0], w8s[0], *sc)
        want = wg.decoupled_gemv_plain(x, w1s[0], w8s[0], *sc)
        err = max(_close(got[0], want[0]), _close(got[1], want[1]))
        b = bound(m * k * 4 + k // 8 * n + k * r + 16 + m * (n + r) * 4, 2 * m * k * (n + r))
        record("decoupled_gemv", m, (k, n, r), err,
               lambda i: wg.decoupled_gemv(x, w1s[i % len(w1s)], w8s[i % len(w8s)], *sc),
               lambda i: wg.decoupled_gemv_plain(x, w1s[0], w8s[0], *sc), b)

    k, n = INT8_SHAPE
    ws = [int8(k, n) for _ in range(_copies(k * n))]
    wscale = scalar(1 / 0.0019)
    for m in ROWS:
        x = int8(m, k)
        gamma = torch.rand((m,), generator=gen, **f32) * 50 + 10
        err = _close(int8_matmul(x, ws[0], gamma, wscale), int8_matmul_plain(x, ws[0], gamma, wscale))
        b = bound(m * k + k * n + m * 4 + 4 + m * n * 4, 2 * m * k * n)
        # torch._int_mm's shape rule: M > 16, K and N multiples of 8
        library = (lambda i: torch._int_mm(x, ws[i % len(ws)])) if m > 16 else None
        record("int8_matmul", m, (k, n), err,
               lambda i: int8_matmul(x, ws[i % len(ws)], gamma, wscale),
               lambda i: int8_matmul_plain(x, ws[0], gamma, wscale), b, library)
    log("[3] library call: none computes a packed 1-bit product (w1a8_gemv, decoupled_gemv); "
        "int8_matmul's is torch._int_mm (integer product only, M > 16)")
    return results


# ---------------------------------------------------------------------------
# Phases 4 and 5: the slice end to end
# ---------------------------------------------------------------------------


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def _serving(torch):
    """pquant-1.3b at full width from ``SEED``, exported packed, with its
    ``DecodeEngine``, the prompts and the greedy sampler of the main path."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import DecodeEngine, SamplerConfig
    from repro_torch.train.quantized_serving import quantize_params_for_serving

    cfg = get_config("pquant-1.3b")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    latent = api.init_model(SEED, cfg, device=dev)
    params = quantize_params_for_serving(latent, cfg, packed=True)
    del latent
    torch.cuda.synchronize()
    log(f"[4] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"r {cfg.quant.r}; init + packed export {time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(SEED))
    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=NEW_TOKENS)
    eng = DecodeEngine(params, cfg, max_len=PROMPT + NEW_TOKENS, device=dev)
    return cfg, params, eng, prompts, greedy


def _time_generate(eng, prompts, greedy, stream):
    """TTFT and full-generate wall times (s) over ``TIMED_RUNS`` runs, each
    ended by its one device-to-host transfer; every stream must repeat
    ``stream``.  Returns (median TTFT, median generate, summary line)."""
    first = dataclasses.replace(greedy, max_new_tokens=1)
    ttfts, gens = [], []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        eng.generate(prompts, first)
        ttfts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        again = eng.generate(prompts, greedy)
        gens.append(time.perf_counter() - t0)
        if not (again == stream).all():
            raise AssertionError("a repeated generate gave another stream")
    ttft, t_gen = statistics.median(ttfts), statistics.median(gens)
    steps = NEW_TOKENS - 1
    line = (f"over {TIMED_RUNS} runs (host clock, each ended by its one transfer): TTFT median "
            f"{ttft * 1e3:.1f} ms (min {min(ttfts) * 1e3:.1f}, max {max(ttfts) * 1e3:.1f}); "
            f"generate median {t_gen * 1e3:.1f} ms (min {min(gens) * 1e3:.1f}, max "
            f"{max(gens) * 1e3:.1f}); decode {(t_gen - ttft) / steps * 1e3:.2f} ms/step, "
            f"{BATCH * steps / (t_gen - ttft):.1f} tokens/s at batch {BATCH}")
    return ttft, t_gen, line


def phase_slice(torch):
    from repro_torch.kernels import _cuda
    from repro_torch.models import api

    cfg, params, eng, prompts, greedy = _serving(torch)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[4] serving params {nbytes / 1e6:.1f} MB")
    dev = torch.device("cuda")
    logits, caches = api.prefill(params, {"tokens": prompts.to(dev)}, cfg, PROMPT + NEW_TOKENS)
    step_logits, _ = api.decode_step(params, logits.argmax(-1)[:, None], caches, PROMPT, cfg)
    if not (torch.isfinite(logits).all() and torch.isfinite(step_logits).all()):
        raise AssertionError("non-finite logits")
    eng.generate(prompts, greedy)  # warm-up (kernel libraries load)
    torch.cuda.synchronize()

    before = eng.host_transfers
    _cuda.reset_launches()
    t0 = time.perf_counter()
    stream = eng.generate(prompts, greedy)
    t_gen = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    if eng.host_transfers - before != 1:
        raise AssertionError(f"{eng.host_transfers - before} host transfers in one generate")
    forwards = NEW_TOKENS  # one prefill + NEW_TOKENS - 1 decode steps
    want = {"w1a8_gemv": 5, "decoupled_gemv": 2, "int8_matmul": 1}
    for name, per_layer in want.items():
        if launches.get(name, 0) != cfg.n_layers * per_layer * forwards:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches, want "
                                 f"{cfg.n_layers} x {per_layer} x {forwards}")
    log(f"[4] launches in one generate: {launches} (= {cfg.n_layers} layers x (5, 2, 1) x "
        f"{forwards} forwards)")

    _, t_gen, line = _time_generate(eng, prompts, greedy, stream)
    log(f"[4] stream (request 0): {stream[0].tolist()}")
    log(f"[4] {line}")
    _profile(torch, eng, prompts, greedy, t_gen)
    return params, cfg, prompts, launches


def _profile(torch, eng, prompts, greedy, wall):
    """Where a generate's time goes on the device: torch.profiler's device
    time of every kernel, summed by name, and the device's busy share of an
    unprofiled generate's wall time ``wall`` (the profiler slows the host,
    not the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, greedy)
    rows = {}
    for e in prof.events():
        # device-side kernels only: not CPU ops, not the annotate() spans
        if e.device_type != DeviceType.CUDA or e.name.startswith(("serve/", "kernels/")):
            continue
        us, n = rows.get(e.name, (0.0, 0))
        rows[e.name] = (us + e.device_time_total, n + 1)
    busy = sum(us for us, _ in rows.values()) / 1e6
    log(f"[4] device busy {busy * 1e3:.2f} ms in a {wall * 1e3:.1f} ms generate "
        f"({100 * busy / wall:.1f}%); kernels by device time:")
    for name, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[4]   {us / 1e3:8.3f} ms  {n:6d}x  {name[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_cut(torch, params, cfg, prompts):
    from repro_torch.models import api
    from repro_torch.serve.engine import DecodeEngine, SamplerConfig

    cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    gpu = dict(params)
    gpu["segments"] = [_tree(lambda t: t[:CUT_LAYERS].contiguous(), params["segments"][0])]
    cpu = _tree(lambda t: t.cpu(), gpu)
    max_len = PROMPT + CUT_NEW_TOKENS
    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=CUT_NEW_TOKENS)
    out = {}
    for name, tree, dev in (("card", gpu, torch.device("cuda")), ("cpu", cpu, torch.device("cpu"))):
        t0 = time.perf_counter()
        logits, _ = api.prefill(tree, {"tokens": prompts.to(dev)}, cut, max_len)
        stream = DecodeEngine(tree, cut, max_len=max_len, device=dev).generate(prompts, greedy)
        out[name] = (logits.cpu(), stream)
        log(f"[5] {CUT_LAYERS}-layer cut on the {name}: {time.perf_counter() - t0:.1f} s")
    (lg, sg), (lc, sc) = out["card"], out["cpu"]
    diff = (lg - lc).abs().max().item()
    scale = lc.abs().max().item()
    log(f"[5] prefill logits max|card - cpu| {diff:.3g} (|logits| <= {scale:.3g}, "
        f"tolerance {LOGIT_TOL} x that); streams equal: {bool((sg == sc).all())}")
    if diff > LOGIT_TOL * scale:
        raise AssertionError("card and CPU logits disagree")
    if not (sg == sc).all():
        raise AssertionError(f"card and CPU greedy streams differ:\n{sg}\n{sc}")


# ---------------------------------------------------------------------------
# Decode timing of two checkouts, side by side
# ---------------------------------------------------------------------------


def time_slice(torch, src: Path) -> int:
    """Phase 4's timing alone, of the ``repro_torch`` package under ``src``
    (no profile, no other phase): prints one JSON line of TTFT, generate
    time and decode ms/step (medians of ``TIMED_RUNS``) and the stream's
    digest."""
    import hashlib

    sys.path.insert(0, str(src))
    from repro_torch.kernels import _cuda

    _cuda.build()
    _, _, eng, prompts, greedy = _serving(torch)
    eng.generate(prompts, greedy)  # warm-up
    stream = eng.generate(prompts, greedy)
    ttft, t_gen, _ = _time_generate(eng, prompts, greedy, stream)
    print(json.dumps({"ttft_ms": ttft * 1e3, "generate_ms": t_gen * 1e3,
                      "ms_per_step": (t_gen - ttft) / (NEW_TOKENS - 1) * 1e3,
                      "stream": hashlib.sha256(stream.tobytes()).hexdigest()[:16]}))
    return 0


def pairs(other: Path, n: int) -> int:
    """Decode timing of this checkout against ``other`` (another commit's
    checkout, e.g. a ``git archive`` unpacked under ``_checkouts/``, which
    git ignores): ``n`` pairs of fresh processes, each running this file's
    :func:`time_slice` on one tree, in the order other, this / this, other
    by turns.  Prints each run, then one JSON line: per-pair decode ms/step
    and TTFT, this tree's wins, medians, the other tree's quartiles and the
    median per-pair ratio.  Fails if the greedy streams differ."""
    import numpy as np

    runs = {"other": [], "this": []}
    for i in range(n):
        order = (("other", other), ("this", ROOT))
        for side, tree in order if i % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--time-slice",
                                str(tree / "src")], capture_output=True, text=True, timeout=900)
            if p.returncode:
                raise RuntimeError(f"{side} run {i} failed:\n{p.stdout[-2000:]}{p.stderr[-4000:]}")
            r = json.loads(p.stdout.strip().splitlines()[-1])
            runs[side].append(r)
            log(f"[pairs] pair {i} {side}: {json.dumps(r)} ({time.perf_counter() - t0:.0f} s)")
    step = {k: np.array([r["ms_per_step"] for r in v]) for k, v in runs.items()}
    ttft = {k: np.array([r["ttft_ms"] for r in v]) for k, v in runs.items()}
    streams = {r["stream"] for v in runs.values() for r in v}
    print(json.dumps({
        "pairs": n,
        "ms_per_step": {k: v.tolist() for k, v in step.items()},
        "ttft_ms": {k: v.tolist() for k, v in ttft.items()},
        "wins_step": int((step["this"] < step["other"]).sum()),
        "wins_ttft": int((ttft["this"] < ttft["other"]).sum()),
        "median_step": {k: float(np.median(v)) for k, v in step.items()},
        "median_ttft": {k: float(np.median(v)) for k, v in ttft.items()},
        "other_step_quartiles": np.percentile(step["other"], [25, 75]).tolist(),
        "median_step_ratio": float(np.median(step["this"] / step["other"])),
        "streams_equal": len(streams) == 1,
    }))
    return 0 if len(streams) == 1 else 1


# ---------------------------------------------------------------------------


def main(torch) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda  # fails outside a checkout of the repo

    smi, name, peaks = phase_card(torch)

    t0 = time.perf_counter()
    built = _cuda.build()
    log(f"[2] kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'}) "
        f"into {_cuda.build_dir()}")

    results = phase_kernels(torch, peaks)
    params, cfg, prompts, launches = phase_slice(torch)
    phase_cut(torch, params, cfg, prompts)

    status = [{"name": n, "replaces": rep,
               "status": "ported" if src else "to port",
               **({"checked": n in results} if src else {})}
              for n, rep, src in TPU_KERNELS]
    log("[6] kernel status: " + json.dumps(status))

    record = []
    for n, rep, src in TPU_KERNELS:
        if not src:
            continue
        res = results[n]
        # the main path's decode shape: 4 rows against q/k/v/o, the up/gate
        # pairs, and w8_down
        key = next(k for k in res["rows"] if k[0] == MAIN_ROWS)
        row = res["rows"][key]
        record.append({
            "name": n, "route": "cuda", "source": src, "replaces": rep,
            "shape": list(key), "launches": launches.get(n, 0),
            "max_abs_err": res["max_abs_err"], **row,
        })
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the port on one CUDA card.")
    ap.add_argument("--pairs", nargs=2, metavar=("CHECKOUT", "N"),
                    help="time decode against another checkout in N alternating pairs")
    ap.add_argument("--time-slice", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if args.time_slice:
        sys.exit(time_slice(torch, Path(args.time_slice)))
    if args.pairs:
        sys.exit(pairs(Path(args.pairs[0]).resolve(), int(args.pairs[1])))
    sys.exit(main(torch))
