#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on any failure:

1. environment: a CUDA card of capability (9, 0), its name and power limit;
   TF32 off, so float32 comparisons are float32;
2. build: nvcc compiles ``src/repro_torch/kernels/csrc/*.cu`` into
   ``build/`` (seconds and the ptxas register / spill report are printed);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the full-width shapes of the served models (gemma2-2b attention:
   head_dim 256, window 4096, softcap 50; mamba2-130m SSD: 24 heads of 64,
   state 128, chunk 256) and at smoke width, in float32 and bfloat16, timed
   with CUDA events (median of several runs after warm-up); the bfloat16
   flash cases also show that their gate rejects the kernel run with the
   softcap dropped or the window cut;
4. model check: the four architectures at smoke width, float32, forward on
   the card (kernels) against forward on the CPU (plain versions);
5. serving: the serve_rtmm workload through ``repro_torch.launch.serve`` and
   ``repro_torch.serving``, in bfloat16, with gemma2-2b at its published
   width (4 layers, and 2 for its supernet variant) and mamba2-130m whole,
   both on 1024-token prompts. Before the run, the full-width bfloat16
   forwards of both are held, each kernel call inside them and the logits,
   against the plain versions in float32; after the run, the kernels'
   launch counters must match the frames the engine ran;
6. profile: one synchronised forward of context and of kws under
   ``torch.profiler``, device time by kernel.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
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
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# which set every kernel's bound, float32 on the CUDA cores, printed beside
# it for the kernels that compute in float32; HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_FP32_CORES = 67e12
PEAK_BYTES = 3.35e12
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
# A bfloat16 kernel is held against its plain version computed in float32 on
# the same inputs. It rounds at most twice where that version does not (the
# probabilities before the PV product, and the output), each by at most the
# unit roundoff of bfloat16 (8 significant bits), so its relative L2 error
# stays within 2 * 2**-8.
BF16_REL_L2 = 2 * 2.0 ** -8
# q and k of standard deviation 4 give scaled scores of deviation 16: a
# softcap of 50 bends the larger of them, and the softmax is sharp enough
# that a dropped key tile shows
BF16_QK_STD = 4.0
# the reference's own SSD tolerance (tests/test_kernels.py): kernel and plain
# version sum the chunk (256 terms) and the state (128 terms) in other orders
SSD_TOL_FP32 = 3e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each run."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def compare(name: str, got, want, tol: float) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol * |want|."""
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off by more "
                             f"than atol=rtol={tol}; max abs err "
                             f"{float(err.max())}")
    return float(err.max())


def rel_l2(got, want) -> float:
    """||got - want|| / ||want||, in float32."""
    import torch
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def check_bf16(name: str, got, want) -> tuple[float, float]:
    """(max abs err, relative L2 err) of a bf16 kernel's output against its
    plain version in float32; raises past TOL or BF16_REL_L2."""
    err = compare(name, got, want, TOL["bfloat16"])
    rel = rel_l2(got, want)
    if rel > BF16_REL_L2:
        raise AssertionError(f"{name}: relative L2 error {rel} above "
                             f"{BF16_REL_L2}")
    return err, rel


def bound(flops: int, nbytes: int) -> tuple[float, str]:
    t_ops = flops / PEAK_BF16 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(torch, gen):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    import torch.nn.functional as F

    cases = [
        # label, B, S, N, K, H, window, softcap
        ("gemma2-2b local", 1, 8192, 8, 4, 256, 4096, 50.0),
        ("gemma2-2b global", 1, 8192, 8, 4, 256, None, 50.0),
        ("gemma2-2b serving", 1, 1024, 8, 4, 256, 4096, 50.0),
        ("smoke MQA", 1, 32, 4, 1, 16, None, None),
        ("smoke MHA", 1, 32, 4, 4, 16, None, None),
        ("smoke gemma2", 1, 32, 4, 4, 16, 8, 50.0),
    ]
    headline = None
    for label, b, s, n, k, h, win, cap in cases:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            # float32 keeps unit inputs, where its 3e-5 sits above rounding
            amp = BF16_QK_STD if dtype == torch.bfloat16 else 1.0
            q = (amp * torch.randn((b, s, n, h), generator=gen,
                                   device="cuda")).to(dtype)
            kk = (amp * torch.randn((b, s, k, h), generator=gen,
                                    device="cuda")).to(dtype)
            v = torch.randn((b, s, k, h), generator=gen, device="cuda").to(dtype)
            run = lambda **kw: ops.flash_attention(
                q, kk, v, **{"window": win, "softcap": cap, **kw})
            plain = lambda: ref.attention(q, kk, v, window=win, softcap=cap)
            got = run()
            torch.cuda.synchronize()
            name = f"flash {label} {dname}"
            rel = None
            if dname == "float32":
                err = compare(name, got, plain(), TOL[dname])
            else:
                want = ref.attention(q.float(), kk.float(), v.float(),
                                     window=win, softcap=cap)
                err, rel = check_bf16(name, got, want)
                # the gate must reject the kernel run with the softcap dropped,
                # and with the window cut by one key tile (64 keys)
                faults = [("no softcap", dict(softcap=None))] if cap else []
                if win and s > win:
                    faults.append((f"window {win} - {min(64, win // 2)}",
                                   dict(window=win - min(64, win // 2))))
                for what, kw in faults:
                    r = rel_l2(run(**kw), want)
                    log(f"[kernels] flash_attention {label} bf16 with {what}: "
                        f"relative L2 err {r} (gate {BF16_REL_L2})")
                    if r <= BF16_REL_L2:
                        raise AssertionError(f"{name}: the gate does not "
                                             f"reject the kernel with {what}")
                del want
            del got
            big = s >= 1024
            ms = time_ms(run, reps=5 if big else 20)
            plain_ms = time_ms(plain, reps=5 if big else 20)
            flops = fa.flops(b, s, s, n, h, True, win)
            nbytes = (2 * q.numel() + 2 * kk.numel()) * q.element_size()
            bound_ms, bound_by = bound(flops, nbytes)
            lib_ms = None
            if label == "gemma2-2b global":
                # yardstick the port never calls: SDPA, causal, no softcap
                qt = q.transpose(1, 2).contiguous()
                kt = kk.repeat_interleave(n // k, dim=2).transpose(1, 2).contiguous()
                vt = v.repeat_interleave(n // k, dim=2).transpose(1, 2).contiguous()
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), reps=5)
                del qt, kt, vt
            core = (f" fp32_cuda_core_bound_ms={flops / PEAK_FP32_CORES * 1e3}"
                    if dname == "float32" else "")
            log(f"[kernels] flash_attention {label} {dname} B={b} S={s} N={n} "
                f"K={k} H={h} window={win} softcap={cap}: max_abs_err={err} "
                f"rel_l2_err={rel} ms={ms} plain_ms={plain_ms} "
                f"bound_ms={bound_ms} ({bound_by}){core} library_ms={lib_ms}")
            if label == "gemma2-2b global" and dname == "bfloat16":
                headline = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=lib_ms)
            del q, kk, v
            torch.cuda.empty_cache()
    return headline


def check_ssd(torch, gen):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd as ssd_mod
    import torch.nn.functional as F

    cases = [
        # label, B, S, H, P, N, chunk
        ("mamba2-130m", 1, 4096, 24, 64, 128, 256),
        ("mamba2-130m serving", 1, 1024, 24, 64, 128, 256),
        ("smoke", 1, 16, 4, 32, 16, 8),
        ("ragged", 2, 100, 3, 16, 32, 32),
    ]
    headline = None
    for label, b, s, h, p, n, ch in cases:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
            dt = F.softplus(torch.randn((b, s, h), generator=gen,
                                        device="cuda") - 4.0)
            A = -torch.linspace(1.0, 16.0, h, device="cuda")
            B = torch.randn((b, s, n), generator=gen, device="cuda")
            C = torch.randn((b, s, n), generator=gen, device="cuda")
            D = torch.ones((h,), device="cuda")
            run = lambda: ops.ssd(x, dt, A, B, C, D, chunk=ch)
            sp = s + (-s) % min(ch, s)
            pad = lambda t: F.pad(t, [0, 0] * (t.ndim - 2) + [0, sp - s])

            def plain():
                y, fin = ref.ssd_chunked(pad(x), pad(dt), A, pad(B), pad(C),
                                         D, chunk=min(ch, s))
                return y[:, :s], fin

            y, fin = run()
            torch.cuda.synchronize()
            y_ref, fin_ref = plain()
            tol = SSD_TOL_FP32 if dname == "float32" else TOL[dname]
            err = compare(f"ssd {label} {dname} y", y, y_ref, tol)
            err = max(err, compare(f"ssd {label} {dname} state", fin,
                                   fin_ref, SSD_TOL_FP32))
            rel = None
            if dname == "bfloat16":
                # and against the plain version in float32 on the same x
                y32, _ = ref.ssd_chunked(pad(x.float()), pad(dt), A, pad(B),
                                         pad(C), D, chunk=min(ch, s))
                _, rel = check_bf16(f"ssd {label} bf16 y", y, y32[:, :s])
                del y32
            if s <= 128:   # the sequential definition, too
                y_seq, fin_seq = ref.ssd(x, dt, A, B, C, D)
                compare(f"ssd {label} {dname} y (sequential)", y, y_seq, tol)
                compare(f"ssd {label} {dname} state (sequential)", fin,
                        fin_seq, SSD_TOL_FP32)
            big = s >= 1024
            ms = time_ms(run, reps=5 if big else 20)
            plain_ms = time_ms(plain, reps=5 if big else 20)
            flops = ssd_mod.flops(b, sp, h, p, n, min(ch, s))
            nbytes = (2 * x.numel() * x.element_size()
                      + 4 * (dt.numel() + B.numel() + C.numel() + 2 * h
                             + fin.numel()))
            bound_ms, bound_by = bound(flops, nbytes)
            log(f"[kernels] ssd {label} x={dname} B={b} S={s} H={h} P={p} "
                f"N={n} chunk={ch}: max_abs_err={err} rel_l2_err={rel} "
                f"ms={ms} plain_ms={plain_ms} bound_ms={bound_ms} "
                f"({bound_by}) fp32_cuda_core_bound_ms="
                f"{flops / PEAK_FP32_CORES * 1e3} library_ms=None")
            if label == "mamba2-130m" and dname == "bfloat16":
                headline = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=None)
            del x, dt, B, C, y, fin, y_ref, fin_ref
            torch.cuda.empty_cache()
    return headline


# ---------------------------------------------------------------------------
# phase 4: the models, card against CPU
# ---------------------------------------------------------------------------


def check_models(torch) -> None:
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M

    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 40)).astype(np.int32))
    for arch in ("gemma-2b", "qwen1.5-4b", "gemma2-2b", "mamba2-130m"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        gen = torch.Generator(device="cpu").manual_seed(0)
        p_cpu = M.init_params(gen, cfg, "cpu")
        p_gpu = M.tree_map(lambda t: t.to("cuda"), p_cpu)
        with torch.inference_mode():
            want, _ = M.forward(p_cpu, cfg, tokens)
            got, _ = M.forward(p_gpu, cfg, tokens.to("cuda"))
        err = compare(f"forward {arch} (card vs CPU)", got.cpu(), want, 1e-4)
        log(f"[model] {arch} smoke fp32 S=40: card (kernels) vs CPU (plain) "
            f"max_abs_err={err}")


def check_served_forward(torch, cases) -> None:
    """The full-width bf16 forwards the engine serves, kernel by kernel and
    whole.

    Each kernel call inside the forward is held, on the inputs the model
    gave it, against the plain version in float32 (within BF16_REL_L2), and
    the arguments it got are checked: gemma2-2b's GQA heads and softcap on
    every layer, its window on the local layers only, the SSD's mixed dtypes
    on every mamba2 layer. The logits are then held against the plain
    forward in float32 on the same (bf16-valued) parameters: both bf16
    paths round the same activations at the same points, except inside the
    kernels, which keep float32 the longer, so the kernel forward must be no
    further from it than twice the plain bf16 forward is.
    """
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M

    calls = []
    flash, ssd = ops.flash_attention, ops.ssd

    def tapped_flash(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        want = ref.attention(q.float(), k.float(), v.float(), **kw)
        calls.append(("flash", tuple(q.shape), tuple(k.shape), q.dtype,
                      kw.get("window"), kw.get("softcap"),
                      rel_l2(out, want)))
        return out

    def tapped_ssd(x, dt, A, B, C, D, *, chunk):
        y, fin = ssd(x, dt, A, B, C, D, chunk=chunk)
        s = x.shape[1]
        xp, dtp, Bp, Cp, ch = ops.pad_to_chunk(chunk, x.float(), dt, B, C)
        y32, fin32 = ref.ssd_chunked(xp, dtp, A, Bp, Cp, D, chunk=ch)
        calls.append(("ssd", tuple(x.shape), tuple(B.shape), x.dtype,
                      (dt.dtype, B.dtype, C.dtype), chunk,
                      max(rel_l2(y, y32[:, :s]), rel_l2(fin, fin32))))
        return y, fin

    gen = torch.Generator(device="cuda").manual_seed(4)
    for h, s in cases:
        cfg = h.cfg
        tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                               device="cuda", dtype=torch.int32)
        with torch.inference_mode():
            calls.clear()
            ops.flash_attention, ops.ssd = tapped_flash, tapped_ssd
            try:
                got = M.forward(h.params, cfg, tokens)[0]
            finally:
                ops.flash_attention, ops.ssd = flash, ssd
            if not torch.isfinite(got).all():
                raise AssertionError(f"{h.name} S={s}: non-finite logits")
            if cfg.family == "ssm":
                n = cfg.ssm_heads
                p = cfg.ssm_expand * cfg.d_model // n
                expect = [("ssd", (1, s, n, p), (1, s, cfg.ssm_state),
                           torch.bfloat16, (torch.float32,) * 3, cfg.ssm_chunk)
                          ] * cfg.num_layers
            else:
                hd = cfg.resolved_head_dim
                expect = [("flash", (1, s, cfg.num_heads, hd),
                           (1, s, cfg.num_kv_heads, hd),
                           torch.bfloat16,
                           cfg.local_window if kind == "local" else None,
                           cfg.attn_logit_softcap)
                          for _ in range(M.num_groups(cfg))
                          for kind in M.group_pattern(cfg)]
            seen = [c[:-1] for c in calls]
            if seen != expect:
                raise AssertionError(f"{h.name}: kernel calls {seen}, "
                                     f"expected {expect}")
            worst = max(c[-1] for c in calls)
            log(f"[model] {h.name} ({cfg.name}) bf16 S={s}: {len(calls)} "
                f"{calls[0][0]} calls as the config sets them; the worst "
                f"relative L2 err against the float32 plain version on the "
                f"same inputs {worst} (gate {BF16_REL_L2})")
            if worst > BF16_REL_L2:
                raise AssertionError(f"{h.name}: a kernel call off by {worst}")

            p32 = M.tree_map(lambda t: t.float(), h.params)
            want = M.forward(p32, dataclasses.replace(cfg, dtype="float32"),
                             tokens, "torch", "torch")[0]
            del p32
            kern = rel_l2(got, want)
            del got
            plain = rel_l2(M.forward(h.params, cfg, tokens, "torch",
                                     "torch")[0], want)
            gate = 2 * plain
            log(f"[model] {h.name} bf16 S={s}: relative L2 err of the logits "
                f"against the float32 forward: kernels {kern}, plain {plain} "
                f"(gate {gate})")
            if not kern <= gate:
                raise AssertionError(f"{h.name}: kernel forward off by {kern}, "
                                     f"above {gate}")
            del want
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: serving
# ---------------------------------------------------------------------------


def serve(torch) -> dict:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import to_compute_dtype
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.launch.serve import build_handle
    from repro_torch.models import model as M
    from repro_torch.serving import (ModelHandle, RequestQueue,
                                     ServingEngine, VirtualAccelerator)

    def full_width(arch: str, name: str, layers: int | None, seed: int):
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = to_compute_dtype(M.init_params(gen, cfg, "cuda"),
                                  M.compute_dtype(cfg))

        @torch.inference_mode()
        def fn(p, tokens):
            return M.forward(p, cfg, tokens)[0]
        return ModelHandle(name=name, cfg=cfg, params=params, fn=fn)

    t0 = time.perf_counter()
    accs = [VirtualAccelerator("big0", speed=1.0, power=1.0),
            VirtualAccelerator("small0", speed=0.45, power=0.4),
            VirtualAccelerator("small1", speed=0.45, power=0.4)]
    engine = ServingEngine(accs, adaptivity=True, frame_drop=True,
                           supernet_switch=True)
    det = build_handle("gemma-2b", "detector", layers=2)
    verif = build_handle("qwen1.5-4b", "verifier", layers=2)
    ctx = full_width("gemma2-2b", "context", 4, seed=1)
    ctx_v1 = full_width("gemma2-2b", "context@v1", 2, seed=2)
    ctx.supernet = ("context@v1",)
    kws = full_width("mamba2-130m", "kws", None, seed=3)
    handles = (det, verif, ctx, ctx_v1, kws)
    prompt = 1024
    # context past its 4096 window, so that the local layers' window binds
    check_served_forward(torch, [(ctx, 6144), (kws, prompt)])

    # count the engine's calls of each model, to hold the kernels' launch
    # counters against the layers those calls ran
    calls = {h.name: 0 for h in handles}
    for h in handles:
        def counted(p, tokens, _fn=h.fn, _name=h.name):
            calls[_name] += 1
            return _fn(p, tokens)
        h.fn = counted
    for h in (det, verif):
        engine.register(h, np.zeros((1, 32), np.int32))
    for h in (ctx, ctx_v1, kws):
        engine.register(h, np.zeros((1, prompt), np.int32))
    for acc in accs:
        log(f"[serve] lat_table {acc.name}: " + " ".join(
            f"{h.name}={engine.lat_table[(h.name, acc.name)] * 1e3:.3f}ms"
            for h in handles))
    log(f"[serve] set-up (build handles + calibrate) "
        f"{time.perf_counter() - t0:.1f} s")

    q = RequestQueue(clock=lambda: 0.0)
    q.add_stream("detector", fps=8, batch=1, seq=32, vocab=128)
    q.add_stream("verifier", fps=8, batch=1, seq=32, vocab=128,
                 depends_on="detector", trigger_prob=0.5)
    q.add_stream("context", fps=4, batch=1, seq=prompt,
                 vocab=ctx.cfg.vocab_size)
    q.add_stream("kws", fps=12, batch=1, seq=prompt, vocab=kws.cfg.vocab_size)

    torch.cuda.reset_peak_memory_stats()
    for h in handles:
        calls[h.name] = 0
    fa.launches = 0
    ssd_mod.launches = 0
    report = engine.run(q, duration_s=5.0)
    launches = {"flash_attention": fa.launches, "ssd": ssd_mod.launches}

    log(f"[serve] {report.summary()}")
    log(f"[serve] (alpha, beta) = ({report.alpha}, {report.beta}); "
        f"aborted={engine.aborted}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, st in sorted(report.per_model.items()):
        log(f"[serve]   {name:>12s} frames={st['frames']:4d} "
            f"violated={st['violated']:4d} energy={st['energy']}")
    log(f"[serve] model calls {calls}; kernel launches {launches}")

    attn_layers = {h.name: (0 if h.cfg.family == "ssm" else h.cfg.num_layers)
                   for h in handles}
    want_flash = sum(calls[n] * attn_layers[n] for n in calls)
    want_ssd = calls["kws"] * kws.cfg.num_layers
    if launches != {"flash_attention": want_flash, "ssd": want_ssd}:
        raise AssertionError(f"launch counts {launches} do not match the "
                             f"served calls: flash {want_flash}, ssd {want_ssd}")
    if not (launches["flash_attention"] > 0 and launches["ssd"] > 0):
        raise AssertionError(f"a kernel was not launched: {launches}")
    for stream in ("detector", "verifier", "context", "kws"):
        if report.per_model.get(stream, {}).get("frames", 0) <= 0:
            raise AssertionError(f"stream {stream} served no frames")
    served = [r for r in q.pending if r.result is not None]
    for r in served:
        v = engine.models[r.model].cfg.vocab_size
        if tuple(r.result.shape) != (1, r.tokens.shape[1], v):
            raise AssertionError(f"{r.model}: logits shape {r.result.shape}")
    last = {r.model: r for r in served}
    for name, r in sorted(last.items()):
        if not torch.isfinite(r.result).all():
            raise AssertionError(f"{name}: non-finite logits")
    log(f"[serve] {len(served)} results checked for shape, the last of each "
        f"model ({sorted(last)}) for finite logits")
    del q, served, last
    profile(torch, [(ctx, prompt), (kws, prompt)])
    return launches


def profile(torch, cases) -> None:
    """Where a served model's device time goes: one synchronised forward
    under torch.profiler, device kernels by self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for h, seq in cases:
        tokens = torch.zeros((1, seq), dtype=torch.int32, device="cuda")
        h.fn(h.params, tokens)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            h.fn(h.params, tokens)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # kernels only: a CPU op's row, and the GPU-side annotation range
        # the profiler draws for it, repeat its kernels' time
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)),
                      reverse=True)
        busy = sum(r[0] for r in rows)
        log(f"[profile] {h.name} S={seq}: device busy {busy:.1f} us of "
            f"{wall_us:.1f} us wall (profiler on)")
        for us, count, key in rows[:8]:
            log(f"[profile]   {us:10.1f} us {100 * us / busy:5.1f}% "
                f"x{count:<4d} {key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e}); run from the root of "
              f"a checkout", file=sys.stderr)
        return 1

    # 1. environment
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise AssertionError(f"needs an sm_90 card, found capability {cap}")
    card = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)
    log(f"[env] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    build.load()
    log(f"[build] nvcc built {build.library_path().name} in "
        f"{build.build_seconds:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")

    # 3. kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash = check_flash(torch, gen)
    ssd = check_ssd(torch, gen)

    # 4. model: card against CPU
    check_models(torch)

    # 5. serving
    launches = serve(torch)

    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:149",
             launches=launches["flash_attention"], **flash),
        dict(name="ssd", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd.py:114",
             launches=launches["ssd"], **ssd),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
