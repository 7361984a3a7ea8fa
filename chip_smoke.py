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
   head_dim 256, window 4096, softcap 50, at S 8192, 4608 (phase 7's
   prefill) and 1024 (served); phi3.5-moe's and qwen3-moe's attention
   prefills at head_dim 128, groups of 4 and 16; phi-3-vision's at head_dim
   96 and zamba2-2.7b's shared block at 160, 1024 tokens, 32 heads;
   mamba2-130m SSD: 24 heads of 64, state 128, chunk 256; zamba2-2.7b's: 80
   heads of 64, state 64) and at smoke width, in float32 and
   bfloat16, timed with CUDA events (median of several runs after warm-up,
   a cold L2 and the host's launch path off the clock; SDPA beside flash);
   the bfloat16 flash cases also show that their gate rejects the kernel
   run with the softcap dropped or the window cut, the bfloat16 SSD cases
   that theirs rejects the scan run as two halves with the state not
   carried across the split and the scan run with dt shifted by one
   position (each margin printed); every flash call names the kernel it
   launched (the wgmma kernel for bf16), which the serving, decode and MoE
   phases check on their launch counters, and every SSD call launches each
   of its three kernels once by the profiler's kernel names (as phase 7's
   profiled prefills do); Mamba2's front (``csrc/mamba_front.cu``) at
   mamba2-130m's and zamba2-2.7b's served [1, 1024] in bfloat16 against its
   plain version in float32 (x, B and C within one bfloat16 rounding),
   timed with a cold L2 beside the operations it replaced (``plain_ms``)
   and its byte bound;
4. model check: the four architectures at smoke width, float32, forward on
   the card (kernels) against forward on the CPU (plain versions);
5. serving: the serve_rtmm workload through ``repro_torch.launch.serve`` and
   ``repro_torch.serving``, in bfloat16, with gemma2-2b at its published
   width (4 layers, and 2 for its supernet variant) and mamba2-130m whole,
   both on 1024-token prompts, kws's frames arriving as a Poisson process;
   every served handle replays CUDA graphs (``repro_torch.graphs``, the
   counterpart of the reference's ``jax.jit``). Before the run, the
   full-width bfloat16 forwards of both are held, each kernel call inside
   them (eagerly, where the taps see each call) and the logits, against the
   plain versions in float32; after the run, the kernels' launch counters,
   raised by each replay with the launches its capture recorded, must
   match the frames the engine ran. A second run, in a fresh engine,
   replays the head arrivals the first run's queue emitted (recorded by
   ``TraceRecorder``, written and read back as JSONL) through
   ``TraceReplayQueue``: each head stream must emit the same frames at the
   same times;
6. graphs (before phase 5's run): each served handle's graph, captured at
   its calibrated shape (detector and verifier (1, 32), context, its
   variant and kws (1, 1024)), must give logits equal to its eager
   forward's bit for bit; the median wall of a synchronised call eager and
   graphed, and one profiled call of each under ``torch.profiler`` (device
   time by kernel, and busy over the median wall);
7. decode: the decode-attention kernel against its plain version at the
   full-width GQA shapes (gemma2-2b, gemma-2b, qwen1.5-4b), in float32 and
   bfloat16 (each call on the kernel ``kernel_for`` names: "mma" for
   bf16), timed with a cold L2 beside SDPA and the bound, its bfloat16
   gate shown rejecting a dropped softcap, a dropped window and pos off by
   one; the four architectures at smoke width, prefill and decode steps on
   the card against the CPU; gemma2-2b at its published config, all 26
   layers, prefill of 4608 tokens into a 5120-row cache and 32 greedy
   decode steps (every flash call of the prefill and every decode-attention
   call of the first and last step held against float32, the decoded
   logits against forward on the extended tokens, the launch counters
   against the calls the config makes, all on "mma"), and mamba2-130m
   whole, 1024 tokens and 32 steps (its SSD calls held likewise); prefill
   ms and ms per decoded token; each run again through
   ``graphs.GraphedDecode`` (one CUDA graph of the step, replayed) from a
   copy of the prefilled cache, fed the same tokens: the logits of every
   step and the final cache must equal the eager run's bit for bit, and the
   counters must add the capture's launches a replay; ms per token eager
   and graphed, and device busy per step of each; a profiled step of each
   (eager and graphed) must run ``decode_mma_kernel`` once per attention
   layer by the profiler's kernel names, and neither fp32 kernel, and a
   profiled prefill the wgmma flash instance of its head dim once per
   attention layer; two threads, each on its own CUDA stream, decode at
   once through the bf16 kernel at gemma2-2b's global shape (several splits
   merged in the launch): every output must equal the same call made in
   turn bit for bit (each stream merges on its own tickets; the outputs
   that differ with one ticket buffer shared by the two streams are counted
   and printed, not gated);
7b. graphs on two streams: two graphed gemma2-2b decode steps (published
   width cut to 4 layers, 5120-row caches), each captured on its own stream,
   replayed by two threads at once behind a device sleep: every output must
   equal the same step replayed in turn bit for bit (each graph's decode
   calls merge on tickets its capture made);
8. MoE: the grouped-matmul kernel against its plain version (the
   reference's cases, empty groups, one group of every row, groups ending
   mid-tile, and phi3.5-moe's and qwen3-moe's full-width prefill and decode
   shapes, wi and wo), each call on the kernel ``gmm.kernel_for`` names
   (wgmma past 64 rows, the split of D up to 64), its bfloat16 gate shown
   rejecting a row moved to the next expert and a dropped partial row tile
   (each margin printed), timed with a cold L2 beside ``torch._grouped_mm``
   and the bound; the decode kernel at qwen3-moe's
   group of 16 and phi3.5-moe's shape (``DECODE_MOE_CASES``) with phase 7's
   gates; both MoE architectures at smoke width
   under both moe_impl values, card against CPU; phi3.5-moe at its published
   width cut to 4 layers (1024-token prefill, 32 greedy steps) and qwen3-moe
   cut to 2 (1024 + 8), every grouped-matmul call of the prefill and of the
   first and last step held against float32, the routing flips between bf16
   and float32 counted, the logits held on the tokens routed alike, the
   launch counters against (prefill + steps) x layers x 3, the prefill's on
   the wgmma kernel and the steps' on the split path, and a profiled step's
   decode kernels by name as in phase 7; each run's steps again through
   ``GraphedDecode``, held and timed as in phase 7; each prefill's median
   wall eager and captured in a graph, and a profile of each with the
   device's time by kind of kernel (gmm, flash, cuBLAS, copies, sort,
   elementwise) beside the wall;
9. the remaining architectures: the decode kernel at phi-3-vision's head
   dim 96 and zamba2-2.7b's shared block's 160 (``DECODE_ARCH_CASES``) with
   phase 7's gates; then zamba2-2.7b (54 mamba blocks and 9 applications of
   the shared block), phi-3-vision (32 layers, a 576-position frontend
   stub), musicgen-large (48 layers, a 256-position stub, absolute
   positions) and minitron-8b (32 layers), each whole, at its published
   width in bf16, through phase 7's run (1024-token prefill into a
   1056-row cache, 16 greedy steps) with all of its checks;
10. training, through ``repro_torch.training``: the forward and backward on
   the torch path (no forward kernel has a backward; every train run must
   launch none of the four), the AdamW update through the hand-written
   kernel (``csrc/adamw.cu``, one launch a params leaf a step, counted
   through the graphs' replays), and ``Trainer`` on CUDA replaying a CUDA
   graph of its step (``graphs.GraphedTrainStep``, after two eager warm-up
   steps): one float32
   step of qwen1.5-4b and mamba2-130m at smoke width, card against CPU
   (loss, metrics, gradients, params, m and v); gemma2-2b at its published
   config for 6 steps (bf16 compute, float32 master params and AdamW state
   updated in place, batch 8 x 128, the reference launcher's defaults),
   first under deterministic algorithms, the graphed ``Trainer`` against
   the eager loop (``build_train_step``'s function called in a loop):
   every metric and the final params, m and v bit for bit; then
   rematerialisation (``cfg.remat``, ``models.remat``): gemma2-2b at batch
   1 x 2048 under each of "none", "full", "dots" and "dots_nobatch", 3
   eager steps and 3 graphed steps (2 warm-up, 1 captured) each, every
   metric and the final params, m and v bit for bit to the eager "none"
   run under deterministic algorithms (an op those report as lacking a
   deterministic kernel is named and held at the state tolerance), step ms
   eager and graphed, each eager step's ``max_memory_allocated`` less the
   bytes before it against the dry-run's tally of the same step on meta
   tensors (within 10%), the graph pool's reserved bytes; and where the
   tally puts "none" over 80 GB at 1 x 4096 and "dots_nobatch" under it,
   the graphed ``Trainer`` there under "dots_nobatch" to its captured
   step; then in the
   normal mode through the graphed ``Trainer`` with the counters reset:
   step ms, tokens/s, memory (the graph pool beside the dry-run's peak of
   the step) and model-FLOPs share, every metric finite,
   1024 tokens a step, a replay profiled; then the eager control on the
   same state (step ms, peak memory, a profiled step), the busy share,
   device kernels and host launch calls a step of each; the AdamW kernel
   against its plain version bit for bit at every gemma2-2b leaf shape and
   at 1, 255, 257 and 2^20 + 3 elements, float32 and bfloat16 params, with
   and without clipping, and one step's leaves timed against the bound,
   the plain version and ``torch._fused_adamw_`` (with the two global
   norms' time); mamba2-130m at its published config (batch 8 x 512,
   accum 2, int8 gradient compression, a checkpoint every 2 steps) through
   the graphed ``Trainer``, preempted at step 3 and resumed from its
   checkpoint (a new capture over the restored state), its trajectory equal
   to an uninterrupted run's bit for bit under deterministic algorithms;
   the final checkpoint restored into an ``LM`` and served by a 1024-token
   prefill through the SSD kernel, each call held against float32 as in
   phase 5, the logits against the float32 torch forward;
11. the device mesh and the dry-run, under an NCCL process group of one
   rank (a ``HashStore``), destroyed at the end: gemma2-2b at phase 10's
   config for 5 steps through ``Trainer`` on the one-device
   ``DeviceMesh("cuda", (1, 1), ("data", "model"))`` with ``rules_for``'s
   table, its step graphed (``GraphedTrainStep`` on DTensors: two eager
   warm-up steps, a capture, two replays), its metrics and final params
   equal bit for bit to a mesh-less ``Trainer``'s and to an eager mesh
   run's of the same seed and steps under phase 10's deterministic
   settings (replay ms beside the mesh-less replay's, the graph's pool, the
   replays' launches); the dry-run's argument bytes at that mesh equal to
   the Trainer's state and batch on the card, and its counted FLOPs to
   ``FlopCounterMode``'s count of a sixth step run eagerly (model_flops
   over them printed); a one-rank NCCL ``all_reduce`` captured in a graph
   (``capture_error_mode`` "global", as the train step) and replayed on new
   data, a profiled window of replays naming its NCCL kernel; a
   smoke-width qwen3-moe step whose state is placed ``Shard`` on the
   size-1 "model" axis by hand, graphed, bit-equal to its eager step, with
   the NCCL kernels of one replay counted; mamba2-130m's step-2 checkpoint
   from
   phase 10 (written with no mesh) restored onto the mesh through
   ``restore(mesh=..., placements=...)`` and resumed (graphed: a capture
   over the restored shards), its trajectory equal to
   phase 10's uninterrupted run bit for bit and its final state to phase
   10's last checkpoint, and its params, gathered with ``full_tensor()``,
   serving phase 10's 1024-token prefill through the SSD kernel with logits
   equal to phase 10's bit for bit; gemma2-2b at its published width cut
   to 4 layers decodes one token on the mesh (the torch path, a 1024-row
   cache) with logits and cache equal bit for bit to the mesh-less step's;
   then, with the NCCL group destroyed, the dry-run in a process of its own
   (``python -m repro_torch.launch.dryrun --jobs 8``, train cells under
   its default ``--remat dots``): each of the 33 cells' DTensor step
   counted as rank 0 of the (16, 16) and of the (2, 16, 16) mesh over a
   fake process group, one line a cell and mesh (compute, memory and
   collective terms, the dominant one, argument, temporary and peak GB
   per device, the remat, collective bytes by family), with its seconds
   and the cells whose arguments plus peak exceed 80 GB; the phase fails
   if any of the 66 counts fails. No train or mesh run launches a
   forward kernel (the mesh step's AdamW kernel runs on each rank's local
   shards, in the graph's replays too); only the restored prefill adds
   SSD launches;
12. the fleet, run right after phase 5 on its handles (detector and
   verifier at smoke width, context at published width cut to 4 layers,
   kws whole, 1024-token prompts): ``repro_torch.launch.serve_fleet``'s
   two nodes ("big" 1.0/1.0 and "small" 0.45/0.4 slices), each served by
   its own worker thread on its own CUDA stream, its six streams
   under ``tuned_score`` for 3 epochs of 2 s (the other three policies'
   placements printed, not served). It fails unless each worker served on
   its node's own non-default stream (the worker checks, and the two
   differ), flash and SSD launches equal the engines' calls x attention
   (SSM) layers, every placed model served a frame each epoch, the
   windows' frames add up to the fleet's, the tuner saw 3 windows with its
   multipliers in [TUNE_LO, TUNE_HI], the obs export parses with
   ``serve_frames_total`` equal to the fleet's frames, and each node's
   last served frame of each model, re-run alone on the same handle and
   tokens, passes the bf16 gate (bit-equality printed). The handles replay
   CUDA graphs, each node's captured on its own stream at registration:
   one call of each model on each node's stream under ``torch.profiler``
   must replay that graph (no new capture) and run each attention layer's
   flash instance and each SSM layer's three SSD kernels once, by the
   kernel names. It prints each node's lat_table and report, each model's
   median served wall under two threads beside its calibrated time alone
   and beside an epoch of the node's streams served with no other worker
   running, and each epoch's wall beside the nodes' summed busy seconds.

13. the scheduler's simulator, on the host (no CUDA): the port's
   ``repro_torch.core`` and ``repro_torch.scenarios`` as
   ``examples/quickstart.py``, ``supernet_switching.py`` and
   ``scenario_fuzz.py`` drive the JAX package's. The paper's five scenarios
   and Chat_Assistant and Voice_Agent on 4K_1WS2OS under FCFS, Veltair,
   Planaria and DREAM-Full for 4 s simulated: UXCost, DLV, energy, frames
   and drops of each pair, DREAM's UXCost against each baseline and the
   geomean over the five, the supernet's subnet shares at 50% and 99%
   cascade, and the phase's host seconds with the CPU's model. These are
   outputs of the analytic cost model of the paper's sub-accelerators, not
   measurements of the card. It fails if a run and its rerun on the same
   seed differ in any field, if a run recorded to JSONL and replayed
   through ``load_trace`` differs from the live run in UXCost, frames or
   windows, if ``EngineConfig("scalar")`` differs from ``"soa"`` under
   DREAM-Full on any of the seven scenarios, or if the record and replay
   of ``scenario_fuzz.py`` fails on fuzzed seeds 0-3.
14. the fleet simulator, on the host (no CUDA): ``repro_torch.cluster`` at
   ``benchmarks/fleet_sweep.py``'s sizes. The headline fleet (16 nodes of
   its mix, one joining at 0.4 of the run and one draining at 0.5, 200
   streams, 2.5 s, seed 0) under round_robin, least_loaded and score, the
   score run recorded and replayed; the cascade fleet (8 nodes, 12 heavy
   cascades, 2.5 s, seeds 0-2) under score_whole and stage-split score
   with a ``TransferModel``, each split run replayed; the scale arm (256
   nodes, 10 000 streams, 0.6 s); the seven golden traces of
   ``tests/golden/``, each replayed twice; split seed 38014 at
   ``tests/test_vectorized_equiv.py``'s shape under ``EngineConfig("soa")``
   and ``"scalar"``. Each run prints UXCost, DLV, energy, frames and
   migrations (outputs of the analytic model), its wall seconds and
   simulated stream-seconds per wall second (host numbers, with the CPU's
   model). It fails unless the score replay equals the live run in UXCost,
   frames, pipeline latency and the final placements, UXCost(round_robin)
   / UXCost(score) > 1, the split UXCost summed over the seeds is no worse
   than the whole-pipeline one, each golden replay has the manifest's
   frames and its UXCost within a relative 1e-12, a second replay equals
   the first, the scalar and soa runs are equal in every field, and the
   scale arm served frames. Whether each golden digest matches the
   manifest's is printed, not gated.

The ``kernels`` line's launches add up each kernel's counted runs: flash
over the two serving runs, the fleet's epochs and the counted prefills of
phases 7-9, SSD over the serving runs, the fleet's epochs, the counted
prefills and the restored prefills of phases 10 and 11, decode attention
over the eager and graphed steps of phases 7-9 (a graphed run's warm-up
calls included), gmm over the MoE runs, eager and graphed, and adamw over
every train run of phases 10 and 11 (eager steps, warm-up steps and
replays).

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS is deterministic only with a fixed workspace, set before its first
# use: phase 10's crash-restart run is held bit for bit
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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


def ptxas_report(text: str, keys) -> None:
    """Registers and spills of the kernel instances whose mangled names
    hold one of ``keys``, from nvcc's ``-Xptxas -v`` report."""
    entry, seen = None, {}
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and any(k in entry for k in keys) and (
                "registers" in line or "spill" in line):
            seen.setdefault(entry, []).append(line.split(":")[-1].strip())
    for entry, lines in seen.items():
        log(f"[build] {entry}: {'; '.join(lines)}")


def time_ms(fn, warmup: int = 2, reps: int = 5, flush=None) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each run.

    With ``flush``, it runs (untimed) before each run, to start it with a
    cold L2, and then the device sleeps ~1 ms before the start event, so
    that the host has queued all of ``fn``'s launches by the time the device
    reaches them: the time is the device's, not the host's launch path (for
    a kernel of microseconds the two differ many times over)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
            torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def cold_l2(torch):
    """A function that writes 64 MB on the card (the L2 holds 50 MB), for
    ``time_ms``'s ``flush``: in a model step each layer reads its inputs and
    weights once, so each timed run starts with a cold L2."""
    scrub = torch.empty(16 * 2**20, dtype=torch.float32, device="cuda")
    return scrub.zero_


def compare(name: str, got, want, tol: float) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol * |want|."""
    return close(name, got, want, tol, tol)


def close(name: str, got, want, atol: float, rtol: float) -> float:
    """Max abs error; raises unless |got - want| <= atol + rtol * |want|
    and ``got`` is finite."""
    import torch
    got, want = got.detach().float(), want.detach().float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off by more "
                             f"than atol={atol} rtol={rtol}; max abs err "
                             f"{float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


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


def flash_by_kernel(fa, what: str) -> dict:
    """The flash launches since the last reset, by kernel. Every flash call
    of the main path is bf16 at a head dim of WGMMA_HEAD_DIMS, so every one
    must have gone through the wgmma kernel."""
    by = dict(fa.kernel_launches)
    log(f"[kernels] {what}: flash_attention launches by kernel {by}")
    if by != {"wgmma": fa.launches, "fp32": 0}:
        raise AssertionError(f"{what}: flash launches {by}, expected all "
                             f"{fa.launches} on the wgmma kernel")
    return by


def reset_flash_counters(fa) -> None:
    fa.launches = 0
    fa.kernel_launches = dict.fromkeys(fa.kernel_launches, 0)


# flash cases: label, B, S, N, K, H, window, softcap. The full-width ones are
# also what ``scripts/time_flash.py`` times, FLASH_REPS runs each.
FLASH_FULL_WIDTH = [
    ("gemma2-2b local", 1, 8192, 8, 4, 256, 4096, 50.0),
    ("gemma2-2b global", 1, 8192, 8, 4, 256, None, 50.0),
    ("gemma2-2b prefill", 1, 4608, 8, 4, 256, None, 50.0),
    ("gemma2-2b serving", 1, 1024, 8, 4, 256, 4096, 50.0),
    ("phi3.5-moe prefill", 1, 1024, 32, 8, 128, None, None),
    ("qwen3-moe prefill", 1, 1024, 64, 4, 128, None, None),
    ("phi-3-vision prefill", 1, 1024, 32, 32, 96, None, None),
    ("zamba2-2.7b shared prefill", 1, 1024, 32, 32, 160, None, None),
]
FLASH_SMOKE = [
    ("smoke MQA", 1, 32, 4, 1, 16, None, None),
    ("smoke MHA", 1, 32, 4, 4, 16, None, None),
    ("smoke gemma2", 1, 32, 4, 4, 16, 8, 50.0),
    # the new head dims under a window and a softcap, so that their gates
    # are shown rejecting both faults
    ("smoke H=96", 1, 300, 4, 2, 96, 100, 50.0),
    ("smoke H=160", 1, 300, 4, 2, 160, 100, 50.0),
]
FLASH_REPS = 10


def flash_inputs(torch, gen, b, s, n, k, h, dtype):
    """q, k, v on the card: q and k of deviation BF16_QK_STD in bfloat16;
    float32 keeps unit inputs, where its 3e-5 sits above rounding."""
    amp = BF16_QK_STD if dtype == torch.bfloat16 else 1.0
    q = (amp * torch.randn((b, s, n, h), generator=gen,
                           device="cuda")).to(dtype)
    kk = (amp * torch.randn((b, s, k, h), generator=gen,
                            device="cuda")).to(dtype)
    v = torch.randn((b, s, k, h), generator=gen, device="cuda").to(dtype)
    return q, kk, v


def check_flash(torch, gen):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    import torch.nn.functional as F

    flush = cold_l2(torch)
    headline = None
    for label, b, s, n, k, h, win, cap in FLASH_FULL_WIDTH + FLASH_SMOKE:
        big = s >= 1024
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            q, kk, v = flash_inputs(torch, gen, b, s, n, k, h, dtype)
            run = lambda **kw: ops.flash_attention(
                q, kk, v, **{"window": win, "softcap": cap, **kw})
            plain = lambda: ref.attention(q, kk, v, window=win, softcap=cap)
            before = dict(fa.kernel_launches)
            got = run()
            torch.cuda.synchronize()
            kernel = fa.kernel_for(dtype, h)
            if fa.kernel_launches[kernel] != before[kernel] + 1:
                raise AssertionError(f"flash {label} {dname}: the {kernel} "
                                     f"kernel was not launched")
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
            ms = time_ms(run, reps=FLASH_REPS if big else 20, flush=flush)
            plain_ms = time_ms(plain, reps=5 if big else 20, flush=flush)
            flops = fa.flops(b, s, s, n, h, True, win)
            nbytes = (2 * q.numel() + 2 * kk.numel()) * q.element_size()
            bound_ms, bound_by = bound(flops, nbytes)
            lib_ms = None
            if big and (win is None or win >= s):
                # yardstick the port never calls: SDPA, causal, no softcap,
                # KV heads expanded (where the window does not bind, the
                # same masks)
                qt = q.transpose(1, 2).contiguous()
                kt = kk.repeat_interleave(n // k, dim=2).transpose(1, 2).contiguous()
                vt = v.repeat_interleave(n // k, dim=2).transpose(1, 2).contiguous()
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), reps=10, flush=flush)
                del qt, kt, vt
            core = (f" fp32_cuda_core_bound_ms={flops / PEAK_FP32_CORES * 1e3}"
                    if dname == "float32" else "")
            margin = f" margin={BF16_REL_L2 / rel}" if rel else ""
            stages = (f" stages={fa.wgmma_stages(h)}" if kernel == "wgmma"
                      else "")
            log(f"[kernels] flash_attention {label} {dname} B={b} S={s} N={n} "
                f"K={k} H={h} window={win} softcap={cap} kernel={kernel}"
                f"{stages}: max_abs_err={err} rel_l2_err={rel}{margin} ms={ms} "
                f"plain_ms={plain_ms} bound_ms={bound_ms} ({bound_by})"
                f"{core} library_ms={lib_ms}")
            if label == "gemma2-2b global" and dname == "bfloat16":
                headline = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=lib_ms)
            del q, kk, v
            torch.cuda.empty_cache()
    return headline


# SSD cases: label, B, S, H, P, N, chunk. The full-width ones (mamba2-130m:
# 24 heads of 64, state 128, chunk 256, at S 4096 and the served 1024) are
# also what ``scripts/time_kernels.py`` times, KERNEL_REPS runs each.
SSD_FULL_WIDTH = [
    ("mamba2-130m", 1, 4096, 24, 64, 128, 256),
    ("mamba2-130m serving", 1, 1024, 24, 64, 128, 256),
    ("zamba2-2.7b", 1, 1024, 80, 64, 64, 256),
]
SSD_SMOKE = [
    ("smoke", 1, 16, 4, 32, 16, 8),
    ("ragged", 2, 100, 3, 16, 32, 32),
]
KERNEL_REPS = 20


def ssd_inputs(torch, gen, b, s, h, p, n, dtype):
    """x, dt, A, B, C, D on the card: dt = softplus(N(0,1) - 4) (mean ~0.03,
    a state that carries over tens of positions), A = -1 .. -16 across the
    heads, as mamba2's A_log init spans; x in ``dtype``, the rest float32."""
    import torch.nn.functional as F
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda") - 4.0)
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    B = torch.randn((b, s, n), generator=gen, device="cuda")
    C = torch.randn((b, s, n), generator=gen, device="cuda")
    D = torch.ones((h,), device="cuda")
    return x, dt, A, B, C, D


#: the three kernels of csrc/ssd.cu, which every SSD call launches in order
SSD_KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel")


#: seconds the profiled calls wait inside the profiling window before
#: they start: kernels launched right after the profiler starts can be
#: missing from its records (the card tests once saw a call's first two
#: kernels of four absent, and single-kernel calls with none)
PROFILE_SETTLE_S = 0.02


def kernel_rows(torch, fn):
    """(the device kernels one synchronised call of ``fn`` runs, as
    (self us, count, name) rows by the profiler's names, ``fn``'s result)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_SETTLE_S)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    return rows, out


#: profiles of one graph replay: a replay runs the same kernels each time,
#: so a profile that misses some of them lost their records (the profiler
#: has dropped a replay's kernels); it is taken again, up to this many in all
PROFILE_TRIES = 3


def profiled_replay(torch, fn, check, label: str):
    """``check(rows)`` on ``kernel_rows`` of ``fn``, a graph replay; a check
    that fails is logged and made again on a new profile of the same replay,
    up to ``PROFILE_TRIES`` in all. Returns ``check``'s result."""
    for attempt in range(1, PROFILE_TRIES + 1):
        rows, _ = kernel_rows(torch, fn)
        try:
            return check(rows)
        except AssertionError as e:
            if attempt == PROFILE_TRIES:
                raise
            log(f"[profile] {label}: profile {attempt} of a graph replay "
                f"held {sum(r[1] for r in rows)} kernels and failed its "
                f"check ({e}); profiling the same replay again")


def check_ssd_launches(rows, calls: int, label: str) -> None:
    """A profiled run (``rows`` from ``kernel_rows`` or ``profile_fn``)
    must launch each of the three SSD kernels ``calls`` times, by the
    profiler's kernel names."""
    by_name = dict.fromkeys(SSD_KERNELS, 0)
    for _, count, key in rows:
        for name in SSD_KERNELS:
            if name in key:
                by_name[name] += count
    want = dict.fromkeys(SSD_KERNELS, calls)
    if by_name != want:
        raise AssertionError(f"{label}: ssd kernels by name {by_name}, "
                             f"expected {want}")
    return by_name


def check_front_launches(rows, calls: int, label: str) -> int:
    """A profiled model call (``rows`` from ``kernel_rows`` or
    ``profile_fn``) must launch Mamba2's front kernel once a Mamba2 block,
    ``calls`` times (its SSD calls), by the profiler's kernel name."""
    got = sum(count for _, count, key in rows if "mamba_front_kernel" in key)
    if got != calls:
        raise AssertionError(f"{label}: mamba_front_kernel {got} times by "
                             f"name, expected {calls}")
    return got


def reset_ssd_counters(ssd_mod) -> None:
    ssd_mod.launches = 0


def check_ssd(torch, gen):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd as ssd_mod
    import torch.nn.functional as F

    flush = cold_l2(torch)
    headline = None
    for label, b, s, h, p, n, ch in SSD_FULL_WIDTH + SSD_SMOKE:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            x, dt, A, B, C, D = ssd_inputs(torch, gen, b, s, h, p, n, dtype)
            run = lambda d_t=dt: ops.ssd(x, d_t, A, B, C, D, chunk=ch)
            sp = s + (-s) % min(ch, s)
            pad = lambda t: F.pad(t, [0, 0] * (t.ndim - 2) + [0, sp - s])

            def plain():
                y, fin = ref.ssd_chunked(pad(x), pad(dt), A, pad(B), pad(C),
                                         D, chunk=min(ch, s))
                return y[:, :s], fin

            before = ssd_mod.launches
            rows, (y, fin) = kernel_rows(torch, run)
            if ssd_mod.launches != before + 1:
                raise AssertionError(f"ssd {label} {dname}: launches "
                                     f"{ssd_mod.launches - before}, not 1")
            check_ssd_launches(rows, 1, f"ssd {label} {dname}")
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
                y32 = y32[:, :s]
                _, rel = check_bf16(f"ssd {label} bf16 y", y, y32)
                # the gate must reject the scan run as two halves with the
                # state not carried across the split, and dt shifted by one
                # position
                half = s // 2
                halves = torch.cat([
                    ops.ssd(x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl], D,
                            chunk=ch)[0]
                    for sl in (slice(0, half), slice(half, s))], dim=1)
                shifted = run(d_t=torch.roll(dt, 1, dims=1))[0]
                for what, bad in (("the state not carried across the "
                                   f"split at {half}", halves),
                                  ("dt shifted by one position", shifted)):
                    rb = rel_l2(bad, y32)
                    log(f"[kernels] ssd {label} bf16 with {what}: relative L2 "
                        f"err {rb} (gate {BF16_REL_L2}, margin "
                        f"{rb / BF16_REL_L2})")
                    if rb <= BF16_REL_L2:
                        raise AssertionError(f"ssd {label} bf16: the gate does "
                                             f"not reject the kernel with "
                                             f"{what}")
                del y32, halves, shifted
            if s <= 128:   # the sequential definition, too
                y_seq, fin_seq = ref.ssd(x, dt, A, B, C, D)
                compare(f"ssd {label} {dname} y (sequential)", y, y_seq, tol)
                compare(f"ssd {label} {dname} state (sequential)", fin,
                        fin_seq, SSD_TOL_FP32)
            big = s >= 1024
            ms = time_ms(run, reps=KERNEL_REPS, flush=flush)
            plain_ms = time_ms(plain, reps=5 if big else 20, flush=flush)
            flops = ssd_mod.flops(b, sp, h, p, n, min(ch, s))
            nbytes = (2 * x.numel() * x.element_size()
                      + 4 * (dt.numel() + B.numel() + C.numel() + 2 * h
                             + fin.numel()))
            bound_ms, bound_by = bound(flops, nbytes)
            margin = f" margin={BF16_REL_L2 / rel}" if rel else ""
            log(f"[kernels] ssd {label} x={dname} B={b} S={s} H={h} P={p} "
                f"N={n} chunk={ch}: max_abs_err={err} rel_l2_err={rel}{margin} "
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


# Mamba2's front at the served [1, 1024]: label, d_inner, state, heads
FRONT_FULL_WIDTH = [
    ("mamba2-130m", 1536, 128, 24),
    ("zamba2-2.7b", 5120, 64, 80),
]


def check_mamba_front(torch, gen):
    """The front's kernel against its plain version in float32 on the same
    bf16 inputs (x, B and C within one bfloat16 rounding, dt within
    float32's tolerance), one launch a call, timed with a cold L2 beside
    the operations it replaced (the plain version on the card, and the
    copy of x the SSD binding then made) and its byte bound. Returns
    zamba2-2.7b's numbers."""
    from repro_torch.kernels import mamba_front as front_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd as ssd_mod

    flush = cold_l2(torch)
    headline = None
    for label, d_inner, n, h in FRONT_FULL_WIDTH:
        c = d_inner + 2 * n
        width = 2 * d_inner + 2 * n + h
        zx = torch.randn((1, 1024, width), generator=gen,
                         device="cuda").bfloat16()
        w = (0.3 * torch.randn((4, c), generator=gen, device="cuda")
             ).bfloat16()
        cb = (0.1 * torch.randn((c,), generator=gen, device="cuda")
              ).bfloat16()
        dtb = torch.randn((h,), generator=gen, device="cuda") - 3.0
        kw = dict(xbc_at=d_inner, dt_at=d_inner + c, state=n)
        run = lambda: ops.mamba_front(zx, w, cb, dtb, **kw)

        def plain():
            x, bmat, cmat, dt = ref.mamba_front(zx, w, cb, dtb, **kw)
            return ssd_mod._aligned(x), bmat, cmat, dt

        before = front_mod.launches
        got = run()
        torch.cuda.synchronize()
        if front_mod.launches != before + 1:
            raise AssertionError(f"mamba_front {label}: launches "
                                 f"{front_mod.launches - before}, not 1")
        want = ref.mamba_front(zx.float(), w.float(), cb.float(), dtb, **kw)
        err = 0.0
        for name, a, b in zip("xBC", got, want):   # one rounding, 2 ulp of f32
            err = max(err, close(f"mamba_front {label} {name}", a, b,
                                 1e-6, 2.0 ** -8 + 2.0 ** -20))
        close(f"mamba_front {label} dt", got[3], want[3], TOL["float32"],
              TOL["float32"])
        rel = max(rel_l2(a, b) for a, b in zip(got[:3], want[:3]))
        ms = time_ms(run, reps=KERNEL_REPS, flush=flush)
        plain_ms = time_ms(plain, reps=KERNEL_REPS, flush=flush)
        nbytes = front_mod.hbm_bytes(1, 1024, d_inner, n, h, 2, 2)
        bound_ms, bound_by = bound(0, nbytes)
        log(f"[kernels] mamba_front {label} bf16 B=1 S=1024 d_inner={d_inner}"
            f" N={n} H={h}: max_abs_err={err} rel_l2_err={rel} ms={ms} "
            f"plain_ms={plain_ms} bound_ms={bound_ms} ({bound_by}, {nbytes} "
            f"bytes) bound_share={bound_ms / ms} library_ms=None")
        if label == "zamba2-2.7b":
            headline = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None)
        del zx, got, want
        torch.cuda.empty_cache()
    return headline


# ---------------------------------------------------------------------------
# kernel calls inside a model, held against float32 where they happen
# ---------------------------------------------------------------------------


class tap_kernels:
    """Inside ``with tap_kernels() as calls:``, every flash and SSD call
    of the port's models is recorded as (kernel, the shape of q or x, of k
    or B, the dtype, the window or the SSD's (dt, B, C) dtypes, the softcap
    or chunk, the relative L2 error of the kernel's output against the plain
    version in float32 on the same inputs)."""

    def __init__(self):
        from repro_torch.kernels import ops, ref
        self.ops, self.ref, self.calls = ops, ref, []

    def flash(self, q, k, v, **kw):
        out = self.real[0](q, k, v, **kw)
        want = self.ref.attention(q.float(), k.float(), v.float(), **kw)
        self.calls.append(("flash", tuple(q.shape), tuple(k.shape), q.dtype,
                           kw.get("window"), kw.get("softcap"),
                           rel_l2(out, want)))
        return out

    def ssd(self, x, dt, A, B, C, D, *, chunk):
        y, fin = self.real[1](x, dt, A, B, C, D, chunk=chunk)
        s = x.shape[1]
        xp, dtp, Bp, Cp, ch = self.ops.pad_to_chunk(chunk, x.float(), dt, B, C)
        y32, fin32 = self.ref.ssd_chunked(xp, dtp, A, Bp, Cp, D, chunk=ch)
        self.calls.append(("ssd", tuple(x.shape), tuple(B.shape), x.dtype,
                           (dt.dtype, B.dtype, C.dtype), chunk,
                           max(rel_l2(y, y32[:, :s]), rel_l2(fin, fin32))))
        return y, fin

    def __enter__(self):
        self.real = (self.ops.flash_attention, self.ops.ssd)
        self.ops.flash_attention, self.ops.ssd = self.flash, self.ssd
        return self.calls

    def __exit__(self, *exc):
        self.ops.flash_attention, self.ops.ssd = self.real


def expected_calls(torch, M, cfg, s: int) -> list:
    """The flash and SSD calls (as ``tap_kernels`` records them, less the
    error) that a bf16 forward or prefill of one sequence of ``s`` tokens
    makes, in order: zamba2's shared block at the head of each group."""
    bf, f32 = torch.bfloat16, torch.float32
    out = []

    def flash(acfg):
        return ("flash", (1, s, acfg.num_heads, acfg.head_dim),
                (1, s, acfg.num_kv_heads, acfg.head_dim), bf, acfg.window,
                acfg.logit_softcap)
    for _ in range(M.num_groups(cfg)):
        if cfg.shared_attn_every:
            out.append(flash(M.shared_attn_cfg_for(cfg)))
        for kind in M.group_pattern(cfg):
            if kind == "mamba":
                n = cfg.ssm_heads
                out.append(("ssd", (1, s, n, cfg.ssm_expand * cfg.d_model // n),
                            (1, s, cfg.ssm_state), bf, (f32,) * 3,
                            cfg.ssm_chunk))
            else:
                out.append(flash(M.attn_cfg_for(cfg, kind)))
    return out


def check_taps(label: str, calls: list, expect: list, log_tag: str) -> float:
    """The tapped calls must be the expected ones, each within BF16_REL_L2
    of float32; returns the worst error."""
    seen = [c[:-1] for c in calls]
    if seen != expect:
        raise AssertionError(f"{label}: kernel calls {seen}, expected "
                             f"{expect}")
    worst = max(c[-1] for c in calls)
    kinds = sorted({c[0] for c in calls})
    log(f"[{log_tag}] {label}: {len(calls)} {'/'.join(kinds)} calls as the "
        f"config sets them; the worst relative L2 err against the float32 "
        f"plain version on the same inputs {worst} (gate {BF16_REL_L2}, "
        f"margin {BF16_REL_L2 / worst if worst else float('inf')})")
    if worst > BF16_REL_L2:
        raise AssertionError(f"{label}: a kernel call off by {worst}")
    return worst


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
    from repro_torch.models import model as M

    gen = torch.Generator(device="cuda").manual_seed(4)
    for h, s in cases:
        cfg = h.cfg
        tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                               device="cuda", dtype=torch.int32)
        with torch.inference_mode():
            with tap_kernels() as calls:
                got = M.forward(h.params, cfg, tokens)[0]
            if not torch.isfinite(got).all():
                raise AssertionError(f"{h.name} S={s}: non-finite logits")
            check_taps(f"{h.name} ({cfg.name}) bf16 S={s}", calls,
                       expected_calls(torch, M, cfg, s), "model")

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


def serve(torch) -> tuple[dict, dict]:
    """Phase 5 (and 6). Returns the launches and the served handles by name,
    each with its own logits function (not the counting wrapper)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import to_compute_dtype
    from repro_torch.graphs import GraphedForward
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_front as front_mod
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.launch.serve import build_handle
    from repro_torch.models import model as M
    from repro_torch.scenarios.trace import TraceRecorder, dumps, loads
    from repro_torch.serving import (ModelHandle, RequestQueue,
                                     ServingEngine, TraceReplayQueue,
                                     VirtualAccelerator)

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
        return ModelHandle(name=name, cfg=cfg, params=params,
                           fn=GraphedForward(fn))

    t0 = time.perf_counter()
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
    # each handle's graph, captured here at its calibrated shape on this
    # thread's stream, against its eager forward (phase 6)
    graphed_forwards(torch, [(det, 32), (verif, 32), (ctx, prompt),
                             (ctx_v1, prompt), (kws, prompt)])

    plain = {h.name: dataclasses.replace(h) for h in handles}
    # count the engine's calls of each model, to hold the kernels' launch
    # counters against the layers those calls ran
    calls = {h.name: 0 for h in handles}
    for h in handles:
        def counted(p, tokens, _fn=h.fn, _name=h.name):
            calls[_name] += 1
            return _fn(p, tokens)
        h.fn = counted

    def make_engine() -> ServingEngine:
        """A fresh engine (slices idle, statistics empty) with every handle
        registered and calibrated."""
        accs = [VirtualAccelerator("big0", speed=1.0, power=1.0),
                VirtualAccelerator("small0", speed=0.45, power=0.4),
                VirtualAccelerator("small1", speed=0.45, power=0.4)]
        engine = ServingEngine(accs, adaptivity=True, frame_drop=True,
                               supernet_switch=True)
        for h in (det, verif):
            engine.register(h, np.zeros((1, 32), np.int32))
        for h in (ctx, ctx_v1, kws):
            engine.register(h, np.zeros((1, prompt), np.int32))
        for acc in accs:
            log(f"[serve] lat_table {acc.name}: " + " ".join(
                f"{h.name}={engine.lat_table[(h.name, acc.name)] * 1e3:.3f}ms"
                for h in handles))
        return engine
    engine = make_engine()
    log(f"[serve] set-up (build handles + calibrate) "
        f"{time.perf_counter() - t0:.1f} s")

    def add_streams(q, kws_arrival=None):
        q.add_stream("detector", fps=8, batch=1, seq=32, vocab=128)
        q.add_stream("verifier", fps=8, batch=1, seq=32, vocab=128,
                     depends_on="detector", trigger_prob=0.5)
        q.add_stream("context", fps=4, batch=1, seq=prompt,
                     vocab=ctx.cfg.vocab_size)
        q.add_stream("kws", fps=12, batch=1, seq=prompt,
                     vocab=kws.cfg.vocab_size, arrival=kws_arrival)
        return q

    attn_layers = {h.name: (0 if h.cfg.family == "ssm" else h.cfg.num_layers)
                   for h in handles}

    def counted_run(engine, q, duration_s: float, what: str):
        """One engine run; the kernels' launch counters must match the
        layers of the model calls it made (the SSD and Mamba2's front once
        a kws block)."""
        for h in handles:
            calls[h.name] = 0
        reset_flash_counters(fa)
        reset_ssd_counters(ssd_mod)
        front_mod.launches = 0
        report = engine.run(q, duration_s=duration_s)
        launches = {"flash_attention": fa.launches, "ssd": ssd_mod.launches,
                    "mamba_front": front_mod.launches}
        flash_by_kernel(fa, what)
        log(f"[serve] {what}: model calls {calls}; kernel launches {launches}")
        want_flash = sum(calls[n] * attn_layers[n] for n in calls)
        want_ssd = calls["kws"] * kws.cfg.num_layers
        if launches != {"flash_attention": want_flash, "ssd": want_ssd,
                        "mamba_front": want_ssd}:
            raise AssertionError(f"{what}: launch counts {launches} do not "
                                 f"match the served calls: flash "
                                 f"{want_flash}, ssd and mamba_front "
                                 f"{want_ssd}")
        if not (launches["flash_attention"] > 0 and launches["ssd"] > 0):
            raise AssertionError(f"{what}: a kernel was not launched: "
                                 f"{launches}")
        return report, launches

    # kws's microphone frames arrive as a Poisson process at its 12 FPS
    q = add_streams(RequestQueue(clock=lambda: 0.0),
                    kws_arrival={"kind": "poisson"})
    torch.cuda.reset_peak_memory_stats()
    report, launches = counted_run(engine, q, 5.0, "serving run")

    log(f"[serve] {report.summary()}")
    log(f"[serve] (alpha, beta) = ({report.alpha}, {report.beta}); "
        f"aborted={engine.aborted}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, st in sorted(report.per_model.items()):
        log(f"[serve]   {name:>12s} frames={st['frames']:4d} "
            f"violated={st['violated']:4d} energy={st['energy']}")
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

    # the same handles, in a fresh engine, fed by a TraceReplayQueue
    # replaying the head arrivals that the first run's queue emitted,
    # recorded through TraceRecorder and carried as JSONL: each head stream
    # must emit the same frames at the same times (the run lasts a little
    # longer than the first, so that the last recorded arrival comes due)
    rec = TraceRecorder({"scenario": "chip_smoke serving run"})
    for r in q.pending:
        if r.depends_on is None:
            rec.arrival(r.arrival, r.model)
    recorded = loads(dumps(rec.trace())).arrivals_by_model()
    rq = add_streams(TraceReplayQueue(clock=lambda: 0.0,
                                      trace=loads(dumps(rec.trace()))))
    replay, replay_launches = counted_run(make_engine(), rq, 5.5,
                                          "trace replay run")
    log(f"[serve] trace replay: {replay.summary()}")
    for name, st in sorted(replay.per_model.items()):
        log(f"[serve]   {name:>12s} frames={st['frames']:4d} "
            f"violated={st['violated']:4d} energy={st['energy']}")
    for stream in ("detector", "context", "kws"):
        got = [r.arrival for r in rq.pending
               if r.model == stream and r.depends_on is None]
        want = recorded.get(stream, [])
        log(f"[serve] trace replay {stream}: {len(got)} frames emitted, "
            f"{len(want)} recorded; arrival times equal: {got == want}")
        if not want or got != want:
            raise AssertionError(f"trace replay {stream}: emitted {len(got)} "
                                 f"frames, recorded {len(want)}, times "
                                 f"{'equal' if got == want else 'differ'}")
    for name in launches:
        launches[name] += replay_launches[name]
    del q, rq, served, last
    return launches, plain


#: synchronised calls timed on the host's clock for a median wall
WALL_REPS = 10


def wall_ms(torch, fn, reps: int = WALL_REPS) -> float:
    """Median host ms of ``reps`` calls of ``fn``, each from an idle card to
    ``torch.cuda.synchronize()`` (after one untimed call); every output is
    dropped before the next call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def busy_ms(rows) -> float:
    """Device ms of a profiled call: its kernels' summed self time."""
    return sum(r[0] for r in rows) / 1e3


def graphed_forwards(torch, cases) -> None:
    """Phase 6: each served handle (``graphs.GraphedForward``) at its
    calibrated shape ``(1, s)``: its graphed logits, captured by the first
    call here on this thread's stream (the key the engine's calls replay),
    must equal its eager forward's bit for bit. Then the median wall of a
    synchronised call, eager and graphed, and one profiled call of each
    (device time by kernel); the device-busy share is the profiled busy
    time over the median wall."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    for h, s in cases:
        tokens = torch.randint(0, h.cfg.vocab_size, (1, s), generator=gen,
                               device="cuda", dtype=torch.int32)
        eager = lambda: h.fn.eager(h.params, tokens)
        graph = lambda: h.fn(h.params, tokens)
        want = eager()
        got = graph()
        same = torch.equal(got, want)
        log(f"[graphs] {h.name} ({h.cfg.name}, {h.cfg.num_layers} layers) "
            f"S={s}: graphed logits {tuple(got.shape)} bit-equal to the "
            f"eager forward: {same}; launches recorded by the capture "
            f"{[g.launches for g in h.fn.graphs.values()]}")
        if not same:
            raise AssertionError(f"{h.name}: graphed logits differ from the "
                                 f"eager forward (max abs "
                                 f"{float((got - want).abs().max())})")
        del want, got
        ms = {"eager": wall_ms(torch, eager), "graphed": wall_ms(torch, graph)}
        busy = {k: busy_ms(profile_fn(torch, f"{h.name} S={s} {k}", fn))
                for k, fn in (("eager", eager), ("graphed", graph))}
        log(f"[graphs] {h.name} S={s}: median wall of a synchronised call "
            f"eager {ms['eager']} ms, graphed {ms['graphed']} ms "
            f"(x{ms['eager'] / ms['graphed']:.2f}); device busy "
            f"{busy['eager']} / {busy['graphed']} ms, busy share eager "
            f"{busy['eager'] / ms['eager']:.3f}, graphed "
            f"{busy['graphed'] / ms['graphed']:.3f}")
        torch.cuda.empty_cache()


def profile_fn(torch, label: str, fn, host: dict | None = None) -> list:
    """One synchronised call of ``fn`` (after one warm-up) under
    torch.profiler: device busy time against wall time, kernels by self
    time. Returns the kernels' rows, (self us, count, name), longest
    first; ``host``, if given, gets the count of each CUDA runtime call
    that launches work (``cuda*Launch*``) in that call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_SETTLE_S)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # kernels only: a CPU op's row, and the GPU-side annotation range the
    # profiler draws for it, repeat its kernels' time
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] {label}: device busy {busy:.1f} us of {wall_us:.1f} us "
        f"wall (profiler on)")
    for us, count, key in rows[:8]:
        log(f"[profile]   {us:10.1f} us {100 * us / busy:5.1f}% "
            f"x{count:<4d} {key[:90]}")
    # the host's side: CUDA runtime calls (launches, copies, allocations,
    # synchronisations) by the host time they took
    host_rows = sorted(((e.self_cpu_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CPU
                        and e.key.startswith("cuda")), reverse=True)
    log(f"[profile]   host CUDA runtime calls: " + "; ".join(
        f"{key} {us:.1f} us x{count}" for us, count, key in host_rows[:4]))
    if host is not None:
        host.update({key: count for _, count, key in host_rows
                     if "Launch" in key})
    return rows


def check_decode_launches(rows, by_kernel: dict, layers: int, steps: int,
                          label: str) -> None:
    """A profiled ``decode_step`` (``rows`` from ``profile_fn``) must run
    the bf16 decode kernel once per attention layer, by the kernel's name,
    and neither fp32 kernel; the decode binding's ``kernel_launches`` over
    the steps before (``by_kernel``) must show every call on "mma"."""
    by_name = {}
    for _, count, key in rows:
        for name in ("decode_mma_kernel", "decode_split_kernel",
                     "decode_combine_kernel"):
            if name in key:
                by_name[name] = by_name.get(name, 0) + count
    want = {"decode_mma_kernel": layers} if layers else {}
    log(f"[decode] {label}: decode kernels by name in one profiled step "
        f"{by_name}, expected {want}; kernel_launches over the {steps} "
        f"steps {by_kernel}")
    if by_name != want:
        raise AssertionError(f"{label}: decode kernels {by_name}, expected "
                             f"{want} (one mma launch per attention layer)")
    if by_kernel != {"mma": steps * layers, "fp32": 0}:
        raise AssertionError(f"{label}: decode kernel_launches "
                             f"{by_kernel}, expected "
                             f"{steps * layers} on mma")


# ---------------------------------------------------------------------------
# phase 12: the fleet (run right after phase 5, on its handles)
# ---------------------------------------------------------------------------

FLEET_EPOCHS = 3
FLEET_EPOCH_S = 2.0


def fleet_phase(torch, handles: dict, card: str) -> dict:
    """``repro_torch.launch.serve_fleet``'s path at served widths: phase 5's
    four models on its two nodes (one thread and one CUDA stream
    each), its six streams under ``tuned_score``. Returns the launches."""
    import threading

    import numpy as np
    from repro_torch.cluster.router import TUNE_HI, TUNE_LO, make_policy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.launch import serve_fleet as sf
    from repro_torch.models import model as M
    from repro_torch.obs import Obs, load_jsonl, parse_prometheus, \
        validate_span

    t0 = time.perf_counter()
    log(f"[fleet] {card}")
    prompt = 1024
    lock = threading.Lock()
    names = ("detector", "verifier", "context", "kws")
    calls = dict.fromkeys(names, 0)

    def counted(h):
        """The handle with its calls counted under a lock (two workers call
        it) and no supernet variant (the fleet registers none)."""
        def fn(p, tokens, _fn=h.fn, _name=h.name):
            with lock:
                calls[_name] += 1
            return _fn(p, tokens)
        return dataclasses.replace(h, fn=fn, supernet=())

    fleet = [counted(handles[n]) for n in names]
    by_name = {h.name: h for h in fleet}
    shapes = {n: (prompt, by_name[n].cfg.vocab_size)
              for n in ("context", "kws")}
    nodes = sf.make_nodes(torch.device("cuda"))
    if (nodes[0].cuda_stream is None or nodes[0].cuda_stream ==
            nodes[1].cuda_stream):
        raise AssertionError("the nodes do not have a CUDA stream each")
    sf.register_all(nodes, fleet, lambda h: np.zeros(
        (1, shapes.get(h.name, (32,))[0]), np.int32))
    for node in nodes:
        for acc in node.engine.accs:
            lat = {m: t for (m, a), t in node.engine.lat_table.items()
                   if a == acc.name}
            log(f"[fleet] node {node.name} lat_table {acc.name}: " + " ".join(
                f"{m}={t * 1e3:.3f}ms" for m, t in lat.items()))
    streams = sf.make_streams(shapes)
    for name in ("round_robin", "least_loaded", "score"):
        nids = sf.place_streams(make_policy(name), nodes, streams)
        log(f"[fleet] {name} would place " + ", ".join(
            f"{s.model}@{s.fps:g}->{nodes[n].name}"
            for s, n in zip(streams, nids)))
    log(f"[fleet] set-up (register and calibrate 2 nodes, place) "
        f"{time.perf_counter() - t0:.1f} s")

    # the main path: counts set to 0 just before, read just after
    calls.update(dict.fromkeys(names, 0))
    samples0 = [{m: len(v) for m, v in n.engine.lat_samples.items()}
                for n in nodes]
    reset_flash_counters(fa)
    reset_ssd_counters(ssd_mod)
    policy = make_policy("tuned_score")
    obs = Obs.make({"profile": False})
    run = sf.serve_epochs(nodes, streams, policy, FLEET_EPOCHS,
                          FLEET_EPOCH_S, obs=obs,
                          log=lambda m: log(f"[fleet] {m}"))
    launches = {"flash_attention": fa.launches, "ssd": ssd_mod.launches}
    flash_by_kernel(fa, "fleet run")

    # each worker on its own stream, not the default one
    active = [sorted(set(nids)) for nids in run.placements]
    ran = {n.node_id: n.served_on for n in nodes if n.served_on is not None}
    log(f"[fleet] nodes active per epoch {active}; served on raw streams "
        f"{ran}, own streams "
        f"{ {n.node_id: n.cuda_stream.cuda_stream for n in nodes} }")
    if len(ran) != len(nodes) or len(set(ran.values())) != len(nodes):
        raise AssertionError(f"fleet: the workers ran on streams {ran}; "
                             f"every node must have served on its own")
    for n in nodes:
        if ran[n.node_id] != n.cuda_stream.cuda_stream or ran[n.node_id] in (
                0, torch.cuda.default_stream().cuda_stream):
            raise AssertionError(f"fleet: node {n.name} served on "
                                 f"{ran[n.node_id]}, not its own stream")

    # launches against the calls the engines made
    attn = {h.name: (0 if h.cfg.family == "ssm" else h.cfg.num_layers)
            for h in fleet}
    per_node = [{m: len(v) - samples0[i].get(m, 0)
                 for m, v in n.engine.lat_samples.items()}
                for i, n in enumerate(nodes)]
    log(f"[fleet] model calls {calls}, by node {per_node}; kernel "
        f"launches {launches}")
    for m in calls:
        if calls[m] != sum(c.get(m, 0) for c in per_node):
            raise AssertionError(f"fleet: {m} called {calls[m]} times, the "
                                 f"engines timed {per_node}")
    want = {"flash_attention": sum(calls[m] * attn[m] for m in calls),
            "ssd": calls["kws"] * by_name["kws"].cfg.num_layers}
    if launches != want or not all(launches.values()):
        raise AssertionError(f"fleet: launches {launches}, the served "
                             f"calls make {want}")

    # every placed model served, the windows add up, the tuner in bounds
    for e, (nids, served) in enumerate(zip(run.placements, run.served)):
        log(f"[fleet] epoch {e}: served {served}; wall "
            f"{run.epoch_wall_s[e]:.3f} s, busy by node {run.busy_s[e]}, "
            f"summed busy {sum(run.busy_s[e].values()):.3f} s "
            f"({sum(run.busy_s[e].values()) / run.epoch_wall_s[e]:.3f} of "
            f"the wall)")
        for s_, nid in zip(streams, nids):
            if served.get((nid, s_.model), 0) <= 0:
                raise AssertionError(f"fleet epoch {e}: {s_.model} placed "
                                     f"on node {nid} served no frame")
    win_frames = [w.frames for w in run.windows]
    log(f"[fleet] windows: frames {win_frames}, DLV "
        f"{[w.dlv_rate for w in run.windows]}, node DLV "
        f"{[w.node_dlv for w in run.windows]}, UXCost "
        f"{[w.uxcost for w in run.windows]}; fleet frames {run.frames}")
    if sum(win_frames) != run.frames:
        raise AssertionError(f"fleet: windows hold {win_frames} frames, the "
                             f"fleet {run.frames}")
    mult = policy.multipliers
    log(f"[fleet] tuner: windows_seen {policy.windows_seen}, held "
        f"{policy.held_windows}, commits {policy.probe.commits}, weights "
        f"{policy.weights}, multipliers {mult.tolist()}")
    if policy.windows_seen != FLEET_EPOCHS or not (
            np.all(mult >= np.asarray(TUNE_LO)) and np.all(mult <= TUNE_HI)):
        raise AssertionError(f"fleet: tuner saw {policy.windows_seen} "
                             f"windows, multipliers {mult}")

    # the obs export
    paths = obs.export(str(ROOT / "build" / "fleet_obs"))
    samples = parse_prometheus(Path(paths["metrics_prom"]).read_text())
    spans = load_jsonl(paths["spans"])
    for rec in spans:
        validate_span(rec)
    exported = sum(x["value"] for x in samples
                   if x["name"] == "serve_frames_total")
    log(f"[fleet] obs: {len(spans)} spans, {len(samples)} samples; "
        f"serve_frames_total {exported}")
    if exported != run.frames:
        raise AssertionError(f"fleet: serve_frames_total {exported}, the "
                             f"fleet served {run.frames}")

    # per node: the report, and served wall times under two threads beside
    # the calibrated time alone; then each node's streams served again for
    # an epoch with no other worker running, the control that tells the
    # other thread's share from the node's own load
    threaded = [{m: list(v) for m, v in n.engine.lat_samples.items()}
                for n in nodes]
    solo = []
    for n in nodes:
        mine = [s_ for s_, nid in zip(streams, run.placements[-1])
                if nid == n.node_id]
        before = {m: len(v) for m, v in n.engine.lat_samples.items()}
        if mine:
            sf.serve_epochs([n], mine, make_policy("round_robin"), 1,
                            FLEET_EPOCH_S,
                            log=lambda m: log(f"[fleet] alone: {m}"))
        solo.append({m: v[before.get(m, 0):]
                     for m, v in n.engine.lat_samples.items()})
    for n, samples, alone_s in zip(nodes, threaded, solo):
        rep = run.reports[-1].get(n.node_id)
        log(f"[fleet] node {n.name}: "
            f"{rep.summary() if rep is not None else 'idle last epoch'}")
        acc = n.engine.accs[0]
        for m, v in sorted(samples.items()):
            calib = n.engine.lat_table[(m, acc.name)] * acc.speed
            med = statistics.median(v)
            alone = (f", served alone {statistics.median(alone_s[m]) * 1e3:.3f}"
                     f" ms ({len(alone_s[m])} calls)"
                     if alone_s.get(m) else "")
            log(f"[fleet]   {n.name} {m:>9s}: {len(v)} calls, median wall "
                f"under two threads {med * 1e3:.3f} ms, calibrated alone "
                f"{calib * 1e3:.3f} ms (x{med / calib:.2f}){alone}")

    # the last served frame of each model on each node, again, alone
    torch.cuda.synchronize()
    for (nid, m), req in sorted(run.last_served.items()):
        h = handles[m]
        with torch.inference_mode():
            again = h.fn(h.params, torch.from_numpy(req.tokens).cuda())
        err, rel = check_bf16(f"fleet node {nid} {m} re-run", req.result,
                              again)
        log(f"[fleet] node {nodes[nid].name} {m}: last served logits "
            f"{tuple(req.result.shape)} against a re-run alone: max abs err "
            f"{err}, rel L2 {rel}, bit-equal "
            f"{bool(torch.equal(req.result, again))}")
    del run, again

    # by the profiler's kernel names: one call of each model on each node's
    # stream replays the graph its registration captured there, which runs
    # each attention layer's flash instance and each SSM layer's three SSD
    # kernels once
    for node in nodes:
        with torch.cuda.stream(node.cuda_stream):
            for m in names:
                h = handles[m]
                s = shapes.get(m, (32,))[0]
                tokens = torch.zeros((1, s), dtype=torch.int32, device="cuda")
                captured = len(h.fn.graphs)
                expect = expected_calls(torch, M, h.cfg, s)
                heads = {}
                for c in expect:
                    if c[0] == "flash":
                        heads[c[1][3]] = heads.get(c[1][3], 0) + 1
                label = f"{node.name} {m} S={s} (graph replay)"

                def check(rows):
                    check_flash_launches(rows, heads, label, "fleet")
                    ssd_calls = sum(c[0] == "ssd" for c in expect)
                    by_name = check_ssd_launches(rows, ssd_calls, label)
                    by_name["mamba_front_kernel"] = check_front_launches(
                        rows, ssd_calls, label)
                    return by_name
                by_name = profiled_replay(
                    torch, lambda: h.fn(h.params, tokens), check, label)
                if len(h.fn.graphs) != captured:
                    raise AssertionError(f"fleet {node.name} {m}: a call "
                                         f"after registration captured again")
                log(f"[fleet] {label}: ssd and front kernels by name "
                    f"{by_name}")
    log(f"[fleet] phase {time.perf_counter() - t0:.1f} s; {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 7: decode
# ---------------------------------------------------------------------------


DECODE_KERNEL_CASES = [
    # label, S, N, K, H, window, softcap, pos (one per sequence)
    ("gemma2-2b local", 5120, 8, 4, 256, 4096, 50.0, [4640]),
    ("gemma2-2b global", 5120, 8, 4, 256, None, 50.0, [4640]),
    ("gemma-2b", 8192, 8, 1, 256, None, None, [7000]),
    ("qwen1.5-4b", 4096, 20, 20, 128, None, None, [3500]),
    ("gemma2-2b local B=3", 5120, 8, 4, 256, 4096, 50.0, [70, 4100, 5119]),
]


#: the MoE models' decode shapes at pos 1040 of a 1056-row cache, timed in
#: phase 8 with phase 7's gates
DECODE_MOE_CASES = [
    ("qwen3-moe (group 16)", 1056, 64, 4, 128, None, None, [1040]),
    ("phi3.5-moe", 1056, 32, 8, 128, None, None, [1040]),
]


def decode_inputs(torch, gen, b: int, s: int, n: int, k: int, h: int,
                  dtype):
    """q [b,n,h] and a cache k, v [b,s,k,h] from ``gen``; bf16 q and k at
    deviation ``BF16_QK_STD``, so a softcap of 50 bends the scores."""
    amp = BF16_QK_STD if dtype == torch.bfloat16 else 1.0
    q = (amp * torch.randn((b, n, h), generator=gen, device="cuda")).to(dtype)
    kc = (amp * torch.randn((b, s, k, h), generator=gen,
                            device="cuda")).to(dtype)
    vc = torch.randn((b, s, k, h), generator=gen, device="cuda").to(dtype)
    return q, kc, vc


def check_decode_kernel(torch, gen, cases=DECODE_KERNEL_CASES):
    """The decode kernel against its plain version at the full-width GQA
    shapes, with times, bounds and SDPA beside it. The bf16 gate must reject
    the kernel run with the softcap dropped, with the window dropped, and
    with pos off by one either way."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops, ref
    import torch.nn.functional as F
    flush = cold_l2(torch)
    headline = None
    for label, s, n, k, h, win, cap, pos_list in cases:
        b = len(pos_list)
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            q, kc, vc = decode_inputs(torch, gen, b, s, n, k, h, dtype)
            args = dict(window=win, softcap=cap)
            run = lambda kk=kc, p=pos, **kw: ops.decode_attention(
                q, kk, vc, p, **{**args, **kw})
            plain = lambda: ref.decode_attention(q, kc, vc, pos, **args)
            name = f"decode {label} {dname}"
            kernel = dec.kernel_for(dtype, dtype)
            before = dec.kernel_launches[kernel]
            got = run()
            torch.cuda.synchronize()
            if dec.kernel_launches[kernel] != before + 1:
                raise AssertionError(f"{name}: not on the {kernel} kernel "
                                     f"({dec.kernel_launches})")
            rel = None
            if dname == "float32":
                err = compare(name, got, plain(), TOL[dname])
            else:
                def want_of(kk):
                    return ref.decode_attention(q.float(), kk.float(),
                                                vc.float(), pos, **args)
                want = want_of(kc)
                err, rel = check_bf16(name, got, want)
                faults = [("no softcap", kc, want, dict(softcap=None))] \
                    if cap else []
                if win and max(pos_list) >= win:
                    faults.append(("no window", kc, want, dict(window=None)))
                # pos off by one: the newest row, and the stale row after it,
                # are made the best match of each group's first query head,
                # so that reading one row too few or too many shows
                planted = kc.clone()
                for i, p in enumerate(pos_list):
                    for r in (p, p + 1):
                        if r < s:
                            planted[i, r] = q[i].reshape(k, n // k, h)[:, 0]
                want_p = want_of(planted)
                check_bf16(f"{name} (planted rows)", run(kk=planted), want_p)
                for d in (-1, 1):
                    faults.append((f"pos {d:+d}", planted, want_p,
                                   dict(p=pos + d)))
                for what, kk, w, kw in faults:
                    r = rel_l2(run(kk=kk, **kw), w)
                    log(f"[decode] decode_attention {label} bf16 with {what}: "
                        f"relative L2 err {r} (gate {BF16_REL_L2})")
                    if r <= BF16_REL_L2:
                        raise AssertionError(f"{name}: the gate does not "
                                             f"reject the kernel with {what}")
                del want, want_p, planted
            del got
            ms = time_ms(run, reps=20, flush=flush)
            plain_ms = time_ms(plain, reps=5, flush=flush)
            flops = dec.flops(pos_list, s, n, h, win)
            nbytes = dec.hbm_bytes(pos_list, s, n, k, h, win, q.element_size(),
                                   kc.element_size())
            bound_ms, bound_by = bound(flops, nbytes)
            lib_ms = None
            if b == 1:
                # yardstick the port never calls: SDPA over the live slice of
                # the cache, q of length 1, GQA, no softcap
                p = pos_list[0]
                lo = max(0, p - win + 1) if win else 0
                qt = q[:, :, None, :].contiguous()
                kt = kc[:, lo:p + 1].transpose(1, 2).contiguous()
                vt = vc[:, lo:p + 1].transpose(1, 2).contiguous()
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True), reps=20, flush=flush)
                del qt, kt, vt
            log(f"[decode] decode_attention {label} {dname} ({kernel}, "
                f"{dec.num_splits(b, k, s, win, n // k, h, kernel)} splits) B={b} S={s} "
                f"N={n} K={k} H={h} window={win} softcap={cap} pos={pos_list}: "
                f"max_abs_err={err} rel_l2_err={rel}"
                f"{f' margin={BF16_REL_L2 / rel}' if rel else ''} ms={ms} "
                f"plain_ms={plain_ms} bound_ms={bound_ms} ({bound_by}, "
                f"{nbytes} bytes, {flops} flops) library_ms={lib_ms}")
            if label == "gemma2-2b global" and dname == "bfloat16":
                headline = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=lib_ms)
            del q, kc, vc
            torch.cuda.empty_cache()
    return headline


def check_decode_models(torch) -> None:
    """The four architectures at smoke width in float32: prefill and four
    decode steps on the card (kernels) against the CPU (plain versions), the
    logits of every step and every cache leaf. The tokens fed to both are
    the CPU's greedy choices, and the two sequences write at different
    positions."""
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M

    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (2, 40)).astype(np.int32))
    for arch in ("gemma-2b", "qwen1.5-4b", "gemma2-2b", "mamba2-130m"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        gen = torch.Generator(device="cpu").manual_seed(0)
        p_cpu = M.init_params(gen, cfg, "cpu")
        runs, feed = {}, []
        for dev in ("cpu", "cuda"):
            p = p_cpu if dev == "cpu" else M.tree_map(lambda t: t.to(dev), p_cpu)
            with torch.inference_mode():
                cache = M.init_cache(cfg, 2, 48, torch.float32, dev)
                logits, cache = M.prefill(p, cfg, tokens.to(dev), cache)
                outs = [logits[:, -1]]
                for i in range(4):
                    if dev == "cpu":
                        feed.append(outs[-1].argmax(-1).to(torch.int32)[:, None])
                    pos = torch.tensor([40 + i, 37 + i], dtype=torch.int32,
                                       device=dev)
                    logits, cache = M.decode_step(p, cfg, feed[i].to(dev),
                                                  cache, pos)
                    outs.append(logits[:, 0])
            runs[dev] = (outs, cache)
        err = 0.0
        for i, (got, want) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
            err = max(err, compare(f"decode {arch} step {i} (card vs CPU)",
                                   got.cpu(), want, 1e-4))
        leaves_cpu, leaves_gpu = [], []
        M.tree_map(leaves_cpu.append, runs["cpu"][1])
        M.tree_map(leaves_gpu.append, runs["cuda"][1])
        for i, (got, want) in enumerate(zip(leaves_gpu, leaves_cpu)):
            err = max(err, compare(f"decode {arch} cache leaf {i} (card vs "
                                   f"CPU)", got.cpu(), want, 1e-4))
        log(f"[decode] {arch} smoke fp32: prefill S=40 + 4 steps, card "
            f"(kernels) vs CPU (plain), logits and {len(leaves_cpu)} cache "
            f"leaves: max_abs_err={err}")


def check_flash_launches(rows, want: dict, label: str,
                         tag: str = "decode") -> None:
    """A profiled call (``rows`` from ``profile_fn``) must run the wgmma
    flash kernel's instance of each head dim as often as ``want`` says
    ({head_dim: launches}) and no float32 flash kernel, by the profiler's
    kernel names."""
    by_name = {}
    for _, count, key in rows:
        m = re.search(r"flash_(wgmma|f32)_kernel<(\d+)>", key)
        if m:
            name = f"flash_{m.group(1)}_kernel<{m.group(2)}>"
            by_name[name] = by_name.get(name, 0) + count
    want = {f"flash_wgmma_kernel<{h}>": n for h, n in want.items()}
    log(f"[{tag}] {label}: flash kernels by name in one profiled call "
        f"{by_name}, expected {want}")
    if by_name != want:
        raise AssertionError(f"{label}: flash kernels {by_name}, expected "
                             f"{want}")


def decode_full_width(torch, arch: str, prompt: int, steps: int,
                      max_seq: int, seed: int, frontend: int = 0) -> dict:
    """``prefill`` over a prompt, then greedy ``decode_step``s, of one
    architecture at its published config in bf16, its weights drawn from a
    seed and cast group by group (so no float32 tree of the whole model is
    held). The first ``frontend``
    positions of the prompt come from a frontend stub drawn from the seed.

    Every flash and SSD call of the prefill and every decode_attention call
    of the first and last step is held, on the inputs the model gave it,
    against the plain version in float32 (gate BF16_REL_L2), and its
    arguments are checked; the launch counters must equal the calls the
    config makes. The decoded logits are then held against forward on the
    extended tokens: both bf16 paths round the same function at other
    points, so the decode path must be no further from the float32 forward
    (on the same bf16-valued weights) than twice the bf16 forward is. A
    profiled step must run the bf16 decode kernel once per attention layer
    and a profiled prefill the wgmma flash instance of its head dim once per
    attention layer, by the profiler's kernel names. The steps run again
    through ``GraphedDecode`` (``graphed_decode``), and a graphed step is
    profiled too. Returns the prefill time, the median ms per token eager
    and graphed, and the launch counts of both runs.
    """
    from repro_torch import graphs
    from repro_torch.configs import get_config
    from repro_torch.convert import init_compute_params
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.models import model as M

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_compute_params(gen, cfg, "cuda", M.compute_dtype(cfg))
    torch.cuda.empty_cache()
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen,
                           device="cuda", dtype=torch.int32)
    fe = (torch.randn((1, frontend, cfg.frontend_dim), generator=gen,
                      device="cuda") if frontend else None)
    prefill_calls = expected_calls(torch, M, cfg, prompt)
    # the decode-attention calls of a step, in order
    dcfgs = []
    for _ in range(M.num_groups(cfg)):
        if cfg.shared_attn_every:
            dcfgs.append(M.shared_attn_cfg_for(cfg))
        dcfgs += [M.attn_cfg_for(cfg, kind) for kind in M.group_pattern(cfg)
                  if kind != "mamba"]
    attn_layers = len(dcfgs)
    calls = []
    real = ops.decode_attention

    def tapped(q, k_cache, v_cache, pos, **kw):
        out = real(q, k_cache, v_cache, pos, **kw)
        want = ref.decode_attention(q.float(), k_cache.float(),
                                    v_cache.float(), pos, **kw)
        calls.append(((tuple(q.shape), tuple(k_cache.shape), q.dtype,
                       k_cache.dtype, kw["window"], kw["softcap"],
                       pos.tolist()), rel_l2(out, want)))
        return out

    with torch.inference_mode():
        cache = M.init_cache(cfg, 1, max_seq, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.prefill(params, cfg, tokens, cache, frontend=fe)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        # the counted prefill, tapped (it writes the same cache again)
        reset_flash_counters(fa)
        reset_ssd_counters(ssd_mod)
        with tap_kernels() as pcalls:
            logits, cache = M.prefill(params, cfg, tokens, cache, frontend=fe)
        check_taps(f"{arch} prefill of {prompt}", pcalls, prefill_calls,
                   "decode")
        launches = {"flash_attention": fa.launches, "ssd": ssd_mod.launches}
        want_l = {k: sum(c[0] == name for c in prefill_calls)
                  for k, name in (("flash_attention", "flash"),
                                  ("ssd", "ssd"))}
        if launches != want_l:
            raise AssertionError(f"{arch} prefill: launches {launches}, "
                                 f"expected {want_l}")
        flash_by_kernel(fa, f"{arch} prefill of {prompt}")
        cache0 = M.tree_map(torch.clone, cache)       # for the graphed run
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        del logits, pcalls
        fed, outs, step_ms = [], [], []
        dec.launches = 0
        dec.kernel_launches = dict.fromkeys(dec.kernel_launches, 0)
        for i in range(steps):
            tap = attn_layers and i in (0, steps - 1)
            pos = torch.full((1,), prompt + i, dtype=torch.int32,
                             device="cuda")
            if tap:
                calls.clear()
                ops.decode_attention = tapped
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                logits, cache = M.decode_step(params, cfg, nxt, cache, pos)
            finally:
                ops.decode_attention = real
            torch.cuda.synchronize()
            if not tap:
                step_ms.append((time.perf_counter() - t0) * 1e3)
            fed.append(nxt)
            outs.append(logits[:, 0])
            nxt = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
            if tap:
                expect = [((1, a.num_heads, a.head_dim),
                           (1, max_seq, a.num_kv_heads, a.head_dim),
                           torch.bfloat16, torch.bfloat16, a.window,
                           a.logit_softcap, [prompt + i]) for a in dcfgs]
                seen = [c[0] for c in calls]
                if seen != expect:
                    raise AssertionError(f"{arch} step {i}: decode calls "
                                         f"{seen}, expected {expect}")
                worst = max(c[1] for c in calls)
                log(f"[decode] {arch} step {i} (pos {prompt + i}): "
                    f"{len(calls)} decode_attention calls as the config sets "
                    f"them; the worst relative L2 err against the float32 "
                    f"plain version on the same inputs {worst} (gate "
                    f"{BF16_REL_L2}, margin {BF16_REL_L2 / worst})")
                if worst > BF16_REL_L2:
                    raise AssertionError(f"{arch}: a decode call off by {worst}")
        launches["decode_attention"] = dec.launches
        by_kernel = dict(dec.kernel_launches)
        if dec.launches != steps * attn_layers:
            raise AssertionError(f"{arch}: {dec.launches} decode_attention "
                                 f"launches, expected {steps} steps x "
                                 f"{attn_layers} attention layers")
        gstep, g_ms, g_launches = graphed_decode(
            torch, f"{arch} decode", params, cfg, cache0, fed, outs, cache,
            prompt, {"decode_attention": ("mma", attn_layers)})
        launches["decode_attention"] += g_launches["decode_attention"]
        dec_logits = torch.cat(outs)                       # [steps, V]
        if not torch.isfinite(dec_logits).all():
            raise AssertionError(f"{arch}: non-finite decode logits")
        ext = torch.cat([tokens] + fed, dim=1)
        # the decoded positions only (a clone lets the full logits go)
        fwd = M.forward(params, cfg, ext, frontend=fe)[0][0, prompt:].clone()
        torch.cuda.empty_cache()
        p32 = M.tree_map(lambda t: t.float(), params)
        want = M.forward(p32, dataclasses.replace(cfg, dtype="float32"), ext,
                         "torch", "torch", frontend=fe)[0][0, prompt:].clone()
        del p32
        torch.cuda.empty_cache()
    kern = rel_l2(dec_logits, want)
    plain = rel_l2(fwd, want)
    agree = int((dec_logits.argmax(-1) == fwd.argmax(-1)).sum())
    gate = 2 * plain
    log(f"[decode] {arch} bf16 prompt {prompt} + {steps} steps: relative L2 "
        f"err of the decoded logits against the float32 forward on the "
        f"extended tokens {kern}, the bf16 forward's {plain} (gate {gate}); "
        f"decode vs bf16 forward {rel_l2(dec_logits, fwd)}, greedy tokens "
        f"agreeing {agree}/{steps}")
    if not kern <= gate:
        raise AssertionError(f"{arch}: decoded logits off by {kern}, above "
                             f"{gate}")
    med = statistics.median(step_ms)
    g_med = statistics.median(g_ms)
    log(f"[decode] {arch} bf16 ({cfg.num_layers} layers): prefill of {prompt} "
        f"tokens {prefill_ms} ms; median {med} ms per decoded token over "
        f"{len(step_ms)} untapped eager steps (min {min(step_ms)}, max "
        f"{max(step_ms)}), graphed {g_med} over {len(g_ms)} replays (min "
        f"{min(g_ms)}, max {max(g_ms)}); launches {launches} "
        f"(decode_attention (2 x {steps} + {graphs.WARMUP_CALLS}) x "
        f"{attn_layers}: eager and graphed steps, warm-up calls)")
    step = lambda: M.decode_step(params, cfg, nxt, cache, pos)
    rows = profile_fn(torch, f"{arch} decode_step at pos {prompt + steps - 1}",
                      step)
    check_decode_launches(rows, by_kernel, attn_layers, steps, arch)
    g_rows = profile_fn(torch, f"{arch} graphed decode_step at pos "
                        f"{prompt + steps - 1}", lambda: gstep(nxt, pos))
    check_decode_launches(g_rows, by_kernel, attn_layers, steps,
                          f"{arch} graphed")
    log(f"[decode] {arch}: device busy a step {busy_ms(rows)} ms eager, "
        f"{busy_ms(g_rows)} ms graphed; busy share of the median step eager "
        f"{busy_ms(rows) / med:.3f}, graphed {busy_ms(g_rows) / g_med:.3f}")
    heads = {}
    for c in prefill_calls:
        if c[0] == "flash":
            heads[c[1][3]] = heads.get(c[1][3], 0) + 1
    rows = profile_fn(torch, f"{arch} prefill of {prompt}",
                      lambda: M.prefill(params, cfg, tokens, cache,
                                        frontend=fe))
    check_flash_launches(rows, heads, f"{arch} prefill")
    ssd_calls = sum(c[0] == "ssd" for c in prefill_calls)
    by_name = check_ssd_launches(rows, ssd_calls, f"{arch} prefill")
    by_name["mamba_front_kernel"] = check_front_launches(
        rows, ssd_calls, f"{arch} prefill")
    if ssd_calls:
        log(f"[decode] {arch} prefill: ssd and front kernels by name in one "
            f"profiled call {by_name}, {ssd_calls} of each expected")
    del params, cache, cache0, gstep, dec_logits, fwd, want
    torch.cuda.empty_cache()
    return dict(launches=launches, ms_per_token=med,
                ms_per_token_graphed=g_med, prefill_ms=prefill_ms)


def graphed_decode(torch, label: str, params, cfg, cache0, fed: list,
                   want: list, cache, prompt: int, per_step: dict):
    """``graphs.GraphedDecode`` over ``cache0`` (a copy of the cache as the
    prefill left it), fed the eager run's tokens ``fed`` at the same
    positions: every step's logits must equal the eager step's (``want``)
    bit for bit, and the final cache the eager run's ``cache``. The
    launches the run adds must be ``per_step`` ({binding: (kernel, launches
    a step)}) times the steps and the warm-up calls before the capture,
    through the replays' recorded deltas. Returns the step, its ms per step
    on the host's clock (the first step, which captures, left out) and the
    launches it added by binding."""
    from repro_torch import graphs
    from repro_torch.kernels import build
    from repro_torch.models import model as M

    step = graphs.GraphedDecode(params, cfg, cache0)
    before = build.counts()
    ms = []
    for i, (tok, w) in enumerate(zip(fed, want)):
        pos = torch.full((1,), prompt + i, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = step(tok, pos)
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(logits.reshape(w.shape), w):
            raise AssertionError(f"{label}: graphed step {i} differs from "
                                 f"the eager step")
    leaves = list(zip(M.tree_leaves(cache0), M.tree_leaves(cache)))
    if not all(torch.equal(a, b) for a, b in leaves):
        raise AssertionError(f"{label}: the graphed run's final cache "
                             f"differs from the eager run's")
    after = build.counts()
    n = len(fed) + graphs.WARMUP_CALLS
    added, want_added = {}, {}
    for name, (total, by_kernel) in after.items():
        added[name] = (total - before[name][0],
                       {k: v - before[name][1][k]
                        for k, v in by_kernel.items()})
        kernel, per = per_step.get(name, (None, 0))
        want_added[name] = (n * per, {k: n * per if k == kernel else 0
                                      for k in by_kernel})
    if len(step.graphs) != 1 or added != want_added:
        raise AssertionError(f"{label}: graphed run captured "
                             f"{len(step.graphs)} graphs, added launches "
                             f"{added}, expected {want_added} ({len(fed)} "
                             f"steps and {graphs.WARMUP_CALLS} warm-up calls)")
    log(f"[graphs] {label}: {len(fed)} graphed steps bit-equal to the eager "
        f"steps, logits of every step and {len(leaves)} cache leaves; "
        f"launches {added} = ({len(fed)} replays + {graphs.WARMUP_CALLS} "
        f"warm-up calls) x {per_step}")
    return step, ms, {name: a[0] for name, a in added.items()}


#: the decode runs at full width: (arch, prompt, decode steps, cache rows,
#: seed); gemma2-2b's prompt runs past its 4096-token window
DECODE_FULL_WIDTH = [
    ("gemma2-2b", 4608, 32, 5120, 5),
    ("mamba2-130m", 1024, 32, 1056, 6),
]


#: calls of each thread in the two-stream decode check, and the cycles
#: (~6 ms) each stream sleeps on the device while they are queued
TWO_STREAM_REPS = 50
TWO_STREAM_SLEEP = 10_000_000


def check_decode_two_streams(torch, gen) -> None:
    """Two threads, each on its own CUDA stream, decode at once through the
    bf16 mma kernel at gemma2-2b's global shape, where the splits merge in
    the launch on the per-(sequence, KV head) tickets: every output must
    equal the same call made in turn bit for bit. Each stream first sleeps
    on the device (``TWO_STREAM_SLEEP``) while its thread queues all its
    calls, so that the two streams' kernels then run back to back on the
    device side by side, not paced by the host. The same threads are then
    run once more with one ticket buffer shared by both streams, and the
    outputs that differ are counted and printed (whether they differ depends
    on the two kernels overlapping, so that count is not gated)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    label, s, n, k, h, win, cap, pos_list = DECODE_KERNEL_CASES[1]
    splits = dec.num_splits(1, k, s, win, n // k, h)
    if splits < 2:
        raise AssertionError(f"two streams: {label} runs {splits} split")
    calls = []
    for _ in range(2):
        q, kc, vc = decode_inputs(torch, gen, 1, s, n, k, h, torch.bfloat16)
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        calls.append(lambda q=q, kc=kc, vc=vc, pos=pos: ops.decode_attention(
            q, kc, vc, pos, window=win, softcap=cap))
    want = [c() for c in calls]
    torch.cuda.synchronize()
    if torch.equal(want[0], want[1]):
        raise AssertionError("two streams: the two inputs give one output")
    streams = [torch.cuda.Stream() for _ in calls]

    def both():
        start = threading.Barrier(2, timeout=60)

        def work(i):
            with torch.cuda.stream(streams[i]):
                start.wait()
                torch.cuda._sleep(TWO_STREAM_SLEEP)
                outs = [calls[i]() for _ in range(TWO_STREAM_REPS)]
                streams[i].synchronize()
            return outs

        with ThreadPoolExecutor(max_workers=2) as pool:
            got = list(pool.map(work, range(2), timeout=300))
        return sum(not torch.equal(o, want[i])
                   for i, outs in enumerate(got) for o in outs)

    before = dec.kernel_launches["mma"]
    t0 = time.perf_counter()
    bad = both()
    wall = time.perf_counter() - t0
    if dec.kernel_launches["mma"] != before + 2 * TWO_STREAM_REPS:
        raise AssertionError(f"two streams: {dec.kernel_launches} after "
                             f"{2 * TWO_STREAM_REPS} calls")
    if bad:
        raise AssertionError(f"two streams: {bad} of {2 * TWO_STREAM_REPS} "
                             f"outputs differ from the calls made in turn")
    own = {key for key in dec._tickets
           if key[1] in {st.cuda_stream for st in streams}}
    if len(own) != 2:
        raise AssertionError(f"two streams: ticket buffers {sorted(own)}")
    shared = torch.zeros(k, dtype=torch.int32, device="cuda")
    per_stream = dec._tickets_for
    dec._tickets_for = lambda device, n: shared
    try:
        bad_shared = both()
    finally:
        dec._tickets_for = per_stream
    torch.cuda.synchronize()
    log(f"[decode] two streams: {label} bf16 ({splits} splits), "
        f"{TWO_STREAM_REPS} calls queued behind a device sleep on each of two "
        f"threads and streams at once, {wall:.3f} s: all {2 * TWO_STREAM_REPS} outputs equal the calls "
        f"made in turn bit for bit, one ticket buffer per stream; with one "
        f"buffer shared by both streams {bad_shared} of "
        f"{2 * TWO_STREAM_REPS} outputs differed (not gated)")


#: the two-stream graphed decode: gemma2-2b at its published width cut to 4
#: layers (two local, two global), caches of 5120 rows, each stream's step
#: at one of ``pos``, and the replays each stream queues
GRAPH_TWO_STREAM = dict(arch="gemma2-2b", layers=4, rows=5120,
                        pos=(4640, 4100), reps=30)


def check_graphed_decode_two_streams(torch) -> None:
    """Two ``GraphedDecode``s of gemma2-2b (one model, two caches of random
    rows), each captured on its own stream, then replayed by two threads
    at once, each on its stream behind a device sleep so that the two
    graphs' kernels run side by side: every output must equal the same step
    replayed in turn, bit for bit. A step writes the same token at the same
    position each time, so every replay of one graph gives the same logits;
    the global layers merge several splits on tickets, which each graph's
    capture made for itself. The counters must add one decode launch a
    layer a replay."""
    from concurrent.futures import ThreadPoolExecutor
    import threading
    from repro_torch import graphs
    from repro_torch.configs import get_config
    from repro_torch.convert import init_compute_params
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.models import model as M

    c = GRAPH_TWO_STREAM
    cfg = dataclasses.replace(get_config(c["arch"]), num_layers=c["layers"])
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = init_compute_params(gen, cfg, "cuda", torch.bfloat16)
    splits = dec.num_splits(1, cfg.num_kv_heads, c["rows"], None,
                            cfg.num_heads // cfg.num_kv_heads, cfg.head_dim)
    if splits < 2:
        raise AssertionError(f"graphed two streams: {splits} split")
    streams = [torch.cuda.Stream() for _ in c["pos"]]
    steps, args, want = [], [], []
    with torch.inference_mode():
        for i, p in enumerate(c["pos"]):
            cache = M.tree_map(
                lambda t: torch.randn(t.shape, generator=gen,
                                      device="cuda").to(t.dtype),
                M.init_cache(cfg, 1, c["rows"], torch.bfloat16, "cuda"))
            steps.append(graphs.GraphedDecode(params, cfg, cache))
            args.append((torch.randint(0, cfg.vocab_size, (1, 1),
                                       generator=gen, device="cuda",
                                       dtype=torch.int32),
                         torch.tensor([p], dtype=torch.int32,
                                      device="cuda")))
        for i, st in enumerate(streams):         # capture, then in turn
            with torch.cuda.stream(st):
                steps[i](*args[i])
                want.append(steps[i](*args[i])[0])
                st.synchronize()
    if torch.equal(want[0], want[1]):
        raise AssertionError("graphed two streams: the two steps give one "
                             "output")
    reps = c["reps"]
    start = threading.Barrier(2, timeout=60)

    def work(i):
        with torch.cuda.stream(streams[i]):
            start.wait()
            torch.cuda._sleep(TWO_STREAM_SLEEP)
            outs = [steps[i](*args[i])[0] for _ in range(reps)]
            streams[i].synchronize()
        return outs

    before = build.counts()["decode_attention"][0]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        got = list(pool.map(work, range(2), timeout=300))
    wall = time.perf_counter() - t0
    added = build.counts()["decode_attention"][0] - before
    bad = sum(not torch.equal(o, want[i])
              for i, outs in enumerate(got) for o in outs)
    log(f"[graphs] two streams: {c['arch']} ({c['layers']} layers, "
        f"{c['rows']}-row caches, pos {c['pos']}; global layers {splits} "
        f"splits) graphed decode steps, {reps} replays queued behind a "
        f"device sleep on each of two threads and streams at once, "
        f"{wall:.3f} s: {2 * reps - bad} of {2 * reps} outputs equal the "
        f"replays in turn bit for bit; decode launches added {added}")
    if bad:
        raise AssertionError(f"graphed two streams: {bad} of {2 * reps} "
                             f"outputs differ from the replays in turn")
    if any(len(st.graphs) != 1 for st in steps):
        raise AssertionError("graphed two streams: a replay captured again")
    if added != 2 * reps * cfg.num_layers:
        raise AssertionError(f"graphed two streams: {added} decode launches "
                             f"added, expected {2 * reps * cfg.num_layers}")
    del steps, params, got, want
    torch.cuda.empty_cache()


def decode(torch, gen):
    headline = check_decode_kernel(torch, gen)
    check_decode_two_streams(torch, gen)
    check_graphed_decode_two_streams(torch)
    check_decode_models(torch)
    runs = {arch: decode_full_width(torch, arch, prompt=prompt, steps=steps,
                                    max_seq=max_seq, seed=seed)
            for arch, prompt, steps, max_seq, seed in DECODE_FULL_WIDTH}
    log("[decode] median ms per decoded token, eager / graphed: " + ", ".join(
        f"{arch} {r['ms_per_token']} / {r['ms_per_token_graphed']}"
        for arch, r in runs.items()))
    return headline, sum_launches(runs.values())


def sum_launches(runs) -> dict:
    out = {}
    for r in runs:
        for name, n in r["launches"].items():
            out[name] = out.get(name, 0) + n
    return out


# ---------------------------------------------------------------------------
# phase 9: the remaining architectures at full width
# ---------------------------------------------------------------------------


#: the decode kernel at the new architectures' head dims, pos 1040 of a
#: 1056-row cache, with phase 7's gates
DECODE_ARCH_CASES = [
    ("phi-3-vision", 1056, 32, 32, 96, None, None, [1040]),
    ("zamba2-2.7b shared", 1056, 32, 32, 160, None, None, [1040]),
]

#: (arch, prompt, frontend positions, decode steps, cache rows, seed), each
#: whole: zamba2-2.7b's 54 mamba blocks and 9 shared-block applications,
#: phi-3-vision's 32 layers with 576 patch embeddings, musicgen-large's 48
#: with 256 audio frames, minitron-8b's 32
ARCH_FULL_WIDTH = [
    ("zamba2-2.7b", 1024, 0, 16, 1056, 9),
    ("phi-3-vision-4.2b", 1024, 576, 16, 1056, 10),
    ("musicgen-large", 1024, 256, 16, 1056, 11),
    ("minitron-8b", 1024, 0, 16, 1056, 12),
]


def archs_phase(torch, gen) -> dict:
    check_decode_kernel(torch, gen, DECODE_ARCH_CASES)
    runs = {arch: decode_full_width(torch, arch, prompt=prompt, steps=steps,
                                    max_seq=max_seq, seed=seed,
                                    frontend=frontend)
            for arch, prompt, frontend, steps, max_seq, seed
            in ARCH_FULL_WIDTH}
    log("[archs] prefill ms and median ms per decoded token: " + ", ".join(
        f"{arch} {r['prefill_ms']} / {r['ms_per_token']}"
        for arch, r in runs.items()))
    return sum_launches(runs.values())


# ---------------------------------------------------------------------------
# phase 8: MoE
# ---------------------------------------------------------------------------

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")
# the reference's grouped-matmul cases (tests/test_kernels.py): (T, D, F, E)
GMM_REF_CASES = [(16, 8, 16, 2), (37, 16, 24, 4), (100, 32, 64, 8),
                 (64, 16, 48, 16)]


def routed_sizes(torch, gen, tokens: int, e: int, k: int) -> list[int]:
    """Rows per expert when each of ``tokens`` tokens picks k distinct
    experts at random, as a router does."""
    picks = torch.rand((tokens, e), generator=gen, device="cuda").topk(k).indices
    return torch.bincount(picks.flatten(), minlength=e).tolist()


def gmm_library(torch, x, w, sizes):
    """The library yardstick for one grouped matmul, and its name:
    ``torch._grouped_mm`` on the same sorted rows and offsets where this
    PyTorch has it and takes the case, else a per-expert ``torch.matmul``
    loop with the sizes on the host before the clock starts."""
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    if x.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        try:
            torch._grouped_mm(x, w, offs=offs)
            torch.cuda.synchronize()
            return (lambda: torch._grouped_mm(x, w, offs=offs)), "torch._grouped_mm"
        except (RuntimeError, TypeError, ValueError) as e:
            log(f"[moe] torch._grouped_mm does not take {tuple(x.shape)} x "
                f"{tuple(w.shape)}: {str(e)[:120]}")
    bounds, start = [], 0
    for n in sizes.tolist():
        bounds.append((start, start + n))
        start += n

    def loop():
        for ei, (a, b) in enumerate(bounds):
            if b > a:
                torch.matmul(x[a:b], w[ei])
    return loop, "per-expert torch.matmul loop"


# gmm cases: label, T, D, F, E, sizes (None: each row's expert at random;
# (tokens, k): tokens routed to k experts each; else a list), dtypes. The
# full-width ones (phi3.5-moe and qwen3-moe, wi and wo, at a 1024-token
# prefill and at one decoded token) are timed, and are also what
# ``scripts/time_kernels.py`` times.
BOTH, BF16 = ("float32", "bfloat16"), ("bfloat16",)
GMM_FULL_WIDTH = [
    ("phi3.5-moe wi prefill", 2048, 4096, 6400, 16, (1024, 2), BF16),
    ("phi3.5-moe wo prefill", 2048, 6400, 4096, 16, (1024, 2), BF16),
    ("phi3.5-moe wi decode", 2, 4096, 6400, 16, (1, 2), BOTH),
    ("phi3.5-moe wo decode", 2, 6400, 4096, 16, (1, 2), BOTH),
    ("qwen3-moe wi prefill", 8192, 4096, 1536, 128, (1024, 8), BF16),
    ("qwen3-moe wo prefill", 8192, 1536, 4096, 128, (1024, 8), BF16),
    ("qwen3-moe wi decode", 8, 4096, 1536, 128, (1, 8), BOTH),
    ("qwen3-moe wo decode", 8, 1536, 4096, 128, (1, 8), BOTH),
]
GMM_SMOKE = [(f"reference {c}", *c, None, BOTH) for c in GMM_REF_CASES] + [
    ("empty groups", 8, 8, 8, 4, [5, 0, 0, 3], BOTH),
    ("one group of all rows", 300, 136, 200, 5, [0, 0, 300, 0, 0], BOTH),
    ("groups ending mid-tile", 321, 72, 80, 4, [65, 1, 127, 128], BOTH),
]


def gmm_inputs(torch, gen, t, d, f, e, sizes_spec, dtype):
    """(rows per expert as a list, the same on the card as int32, x, w):
    x of unit deviation, w scaled by D^-1/2."""
    if sizes_spec is None:
        sizes_l = torch.bincount(torch.randint(
            0, e, (t,), generator=gen, device="cuda"), minlength=e).tolist()
    elif isinstance(sizes_spec, tuple):
        sizes_l = routed_sizes(torch, gen, sizes_spec[0], e, sizes_spec[1])
    else:
        sizes_l = list(sizes_spec)
    assert sum(sizes_l) == t, (t, sizes_l)
    sizes = torch.tensor(sizes_l, dtype=torch.int32, device="cuda")
    x = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((e, d, f), generator=gen, device="cuda")
         * d ** -0.5).to(dtype)
    return sizes_l, sizes, x, w


def check_gmm_kernel(torch, gen):
    """The grouped-matmul kernel against its plain version: the reference's
    cases, empty groups, one group of every row, groups that end mid-tile,
    and the full-width shapes of phi3.5-moe (wi and wo at 2048 and 2 rows)
    and qwen3-moe (wi and wo at 8192 and 8 rows, most of 128 experts empty
    at decode). float32 within 3e-5 (the reference's tolerance); bf16
    against the plain version in float32 on the same inputs within
    BF16_REL_L2 (one rounding, of the output). Each call must take the
    kernel ``kernel_for`` names. The bf16 gate must reject the kernel run
    with one row moved to the next expert and with the last partial row
    tile dropped. Times: cold L2, host launch path off the clock, beside the
    bound and the library call."""
    from repro_torch.kernels import gmm as gmm_mod
    from repro_torch.kernels import ops, ref

    flush = cold_l2(torch)
    headline = None
    for label, t, d, f, e, sizes_spec, dnames in GMM_SMOKE + GMM_FULL_WIDTH:
        timed = label in {c[0] for c in GMM_FULL_WIDTH}
        for dname in dnames:
            dtype = getattr(torch, dname)
            sizes_l, sizes, x, w = gmm_inputs(torch, gen, t, d, f, e,
                                              sizes_spec, dtype)
            run = lambda xx=x, ss=sizes: ops.gmm(xx, w, ss)
            kernel = gmm_mod.kernel_for(dtype, t)
            before = dict(gmm_mod.kernel_launches)
            got = run()
            torch.cuda.synchronize()
            if gmm_mod.kernel_launches[kernel] != before[kernel] + 1:
                raise AssertionError(f"gmm {label} {dname}: the {kernel} "
                                     f"kernel was not launched")
            name = f"gmm {label} {dname}"
            rel = None
            if dname == "float32":
                err = compare(name, got, ref.gmm(x, w, sizes), TOL[dname])
            else:
                want = ref.gmm(x.float(), w.float(), sizes)
                err, rel = check_bf16(name, got, want)
                faults = []
                live = [i for i, n in enumerate(sizes_l) if n]
                src = next((i for i in live if i + 1 < e), None)
                if src is not None:
                    moved = list(sizes_l)
                    moved[src] -= 1
                    moved[src + 1] += 1
                    faults.append((f"one row of expert {src} moved to {src + 1}",
                                   run(ss=torch.tensor(moved, dtype=torch.int32,
                                                       device="cuda"))))
                # the last live expert's rows end the array: drop its last
                # partial 64-row tile (a whole tile when none is partial)
                last = live[-1]
                r = sizes_l[last] % 64 or min(64, sizes_l[last])
                cut = list(sizes_l)
                cut[last] -= r
                part = run(xx=x[:t - r], ss=torch.tensor(cut, dtype=torch.int32,
                                                        device="cuda"))
                faults.append((f"the last {r} rows (a partial tile) dropped",
                               torch.cat([part, part.new_zeros((r, f))])))
                for what, bad in faults:
                    rb = rel_l2(bad, want)
                    log(f"[moe] gmm {label} bf16 with {what}: relative L2 err "
                        f"{rb} (gate {BF16_REL_L2}, margin {rb / BF16_REL_L2})")
                    if rb <= BF16_REL_L2:
                        raise AssertionError(f"{name}: the gate does not "
                                             f"reject the kernel with {what}")
                del want, faults
            del got
            ms = plain_ms = lib_ms = lib_name = None
            flops = gmm_mod.flops(t, d, f)
            nbytes = gmm_mod.hbm_bytes(sizes_l, d, f, x.element_size())
            bound_ms, bound_by = bound(flops, nbytes)
            if timed:
                ms = time_ms(run, reps=KERNEL_REPS, flush=flush)
                plain_ms = time_ms(lambda: ref.gmm(x, w, sizes), reps=5,
                                   flush=flush)
                lib_fn, lib_name = gmm_library(torch, x, w, sizes)
                lib_ms = time_ms(lib_fn, reps=KERNEL_REPS, flush=flush)
            live_e = sum(1 for n in sizes_l if n)
            log(f"[moe] gmm {label} {dname} T={t} D={d} F={f} E={e} "
                f"({live_e} with rows) kernel={kernel}: max_abs_err={err} "
                f"rel_l2_err={rel} ms={ms} plain_ms={plain_ms} "
                f"bound_ms={bound_ms} ({bound_by}, {nbytes} bytes, {flops} "
                f"flops) library_ms={lib_ms} ({lib_name})")
            if label == "phi3.5-moe wi prefill":
                headline = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=lib_ms)
            del x, w
            torch.cuda.empty_cache()
    return headline


def gmm_by_kernel(gmm_mod, what: str, want: dict) -> None:
    """The gmm launches since the last reset, by kernel, against ``want``."""
    by = dict(gmm_mod.kernel_launches)
    log(f"[moe] {what}: gmm launches by kernel {by}")
    if by != want:
        raise AssertionError(f"{what}: gmm launches {by}, expected {want}")


def check_moe_models(torch) -> None:
    """The two MoE architectures at smoke width in float32, under both
    moe_impl values: forward (logits and aux) and prefill plus four decode
    steps (logits of every step, every cache leaf) on the card against the
    CPU. The tokens fed to both are the CPU's greedy choices."""
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M

    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, (2, 40)).astype(np.int32))
    for arch in MOE_ARCHS:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        p_cpu = M.init_params(torch.Generator(device="cpu").manual_seed(0),
                              cfg, "cpu")
        p_gpu = M.tree_map(lambda t: t.to("cuda"), p_cpu)
        for impl in ("kernel", "einsum"):
            runs, feed = {}, []
            for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
                with torch.inference_mode():
                    flog, aux = M.forward(p, cfg, tokens.to(dev), moe_impl=impl)
                    cache = M.init_cache(cfg, 2, 48, torch.float32, dev)
                    logits, cache = M.prefill(p, cfg, tokens.to(dev), cache,
                                              moe_impl=impl)
                    outs = [flog, logits[:, -1]]
                    for i in range(4):
                        if dev == "cpu":
                            feed.append(outs[-1].argmax(-1).to(torch.int32)[:, None])
                        pos = torch.tensor([40 + i, 37 + i], dtype=torch.int32,
                                           device=dev)
                        logits, cache = M.decode_step(p, cfg, feed[i].to(dev),
                                                      cache, pos, moe_impl=impl)
                        outs.append(logits[:, 0])
                leaves = []
                M.tree_map(leaves.append, cache)
                runs[dev] = (outs, float(aux), leaves)
            err = 0.0
            for i, (got, want) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
                err = max(err, compare(f"moe {arch} {impl} output {i} (card vs "
                                       f"CPU)", got.cpu(), want, 1e-4))
            for i, (got, want) in enumerate(zip(runs["cuda"][2], runs["cpu"][2])):
                err = max(err, compare(f"moe {arch} {impl} cache leaf {i} "
                                       f"(card vs CPU)", got.cpu(), want, 1e-4))
            aux_c, aux_g = runs["cpu"][1], runs["cuda"][1]
            if not abs(aux_g - aux_c) <= 1e-5 * (1 + abs(aux_c)):
                raise AssertionError(f"moe {arch} {impl}: aux {aux_g} on the "
                                     f"card, {aux_c} on the CPU")
            log(f"[moe] {arch} smoke fp32 moe_impl={impl}: forward, prefill "
                f"S=40 + 4 steps, card vs CPU: max_abs_err={err}; aux card "
                f"{aux_g} CPU {aux_c}")


def _route_sets_agree(a, b):
    """Per token, whether two routings [T, k] chose the same experts, and
    how many (token, choice) pairs of ``a`` chose an expert ``b`` did not."""
    same = (a[:, :, None] == b[:, None, :]).any(-1)        # [T, k]
    return same.all(-1), int((~same).sum())


def moe_full_width(torch, arch: str, layers: int, prompt: int, steps: int,
                   max_seq: int, seed: int) -> dict:
    """One MoE architecture at its published width, cut to ``layers``
    layers, in bf16 through moe_impl="kernel": ``prefill`` of a prompt, then
    greedy ``decode_step``s.

    Every grouped-matmul call of the prefill and of the first and last step
    is held, on its own inputs, against the plain version in float32 (gate
    BF16_REL_L2). The routing of every layer is recorded, on this path and
    in two forwards on the extended tokens with the plain versions (float32,
    and bf16, both on the same bf16-valued weights): a router's decision can
    flip at a near tie between bf16 and float32, which is no kernel fault, so
    the flipped (token, choice) pairs are counted and the logits (prefill
    and decoded) are held, on the tokens routed alike at every layer, to no
    more than twice the plain bf16 forward's distance from float32. The
    launch counters are read over the tapped prefill and the steps. The
    steps run again through ``GraphedDecode`` (``graphed_decode``), and the
    prefill is profiled eager and graphed (``prefill_profile``).
    """
    from repro_torch.configs import get_config
    from repro_torch.convert import to_compute_dtype
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gmm_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = to_compute_dtype(M.init_params(gen, cfg, "cuda"), torch.bfloat16)
    torch.cuda.empty_cache()                 # the float32 draw is gone
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen,
                           device="cuda", dtype=torch.int32)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    d, f = cfg.d_model, cfg.d_ff
    real_gmm, real_route = ops.gmm, moe.route
    calls, routes = [], []

    def tapped_gmm(x, w, sizes, **kw):
        out = real_gmm(x, w, sizes, **kw)
        want = ref.gmm(x.float(), w.float(), sizes)
        calls.append(((tuple(x.shape), tuple(w.shape), x.dtype),
                      rel_l2(out, want)))
        return out

    def tapped_route(p, mcfg, x):
        out = real_route(p, mcfg, x)
        routes.append(out[1])
        return out

    def expect(rows):
        return [((rows * k, d), (e, d, f), torch.bfloat16)] * 2 + \
            [((rows * k, f), (e, f, d), torch.bfloat16)]

    def check_calls(what, rows):
        want = expect(rows) * layers
        seen = [c[0] for c in calls]
        if seen != want:
            raise AssertionError(f"{arch} {what}: gmm calls {seen}, expected "
                                 f"{want}")
        worst = max(c[1] for c in calls)
        log(f"[moe] {arch} {what}: {len(calls)} gmm calls with the config's "
            f"shapes; the worst relative L2 err against the float32 plain "
            f"version on the same inputs {worst} (gate {BF16_REL_L2})")
        if worst > BF16_REL_L2:
            raise AssertionError(f"{arch} {what}: a gmm call off by {worst}")

    with torch.inference_mode():
        cache = M.init_cache(cfg, 1, max_seq, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.prefill(params, cfg, tokens, cache)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        # the counted run: the tapped prefill (it writes the same cache
        # again) and the steps
        reset_flash_counters(fa)
        dec.launches = gmm_mod.launches = 0
        dec.kernel_launches = dict.fromkeys(dec.kernel_launches, 0)
        gmm_mod.kernel_launches = dict.fromkeys(gmm_mod.kernel_launches, 0)
        ops.gmm, moe.route = tapped_gmm, tapped_route
        try:
            plog, cache = M.prefill(params, cfg, tokens, cache)
        finally:
            ops.gmm, moe.route = real_gmm, real_route
        check_calls(f"prefill of {prompt}", prompt)
        cache0 = M.tree_map(torch.clone, cache)       # for the graphed run
        kern_routes = [[r] for r in routes]
        outs = [plog[0].clone()]
        nxt = plog[:, -1].argmax(-1).to(torch.int32)[:, None]
        del plog
        fed, step_ms = [], []
        for i in range(steps):
            tap = i in (0, steps - 1)
            pos = torch.full((1,), prompt + i, dtype=torch.int32, device="cuda")
            calls.clear()
            routes.clear()
            ops.gmm = tapped_gmm if tap else real_gmm
            moe.route = tapped_route
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                logits, cache = M.decode_step(params, cfg, nxt, cache, pos)
            finally:
                ops.gmm, moe.route = real_gmm, real_route
            torch.cuda.synchronize()
            if not tap:
                step_ms.append((time.perf_counter() - t0) * 1e3)
            else:
                check_calls(f"step {i} (pos {prompt + i})", 1)
            for li, r in enumerate(routes):
                kern_routes[li].append(r)
            fed.append(nxt)
            outs.append(logits[0])
            nxt = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
        launches = {"flash_attention": fa.launches,
                    "decode_attention": dec.launches, "gmm": gmm_mod.launches}
        dec_by_kernel = dict(dec.kernel_launches)
        flash_by_kernel(fa, f"{arch} prefill and steps")
        # the prefill's rows (prompt x k) take the wgmma kernel, a step's k
        # rows the split path
        gmm_by_kernel(gmm_mod, f"{arch} prefill and steps",
                      {"wgmma": layers * 3, "wgmma_splitk": steps * layers * 3,
                       "fp32": 0})
        want_l = {"flash_attention": layers, "decode_attention": steps * layers,
                  "gmm": (1 + steps) * layers * 3}
        if launches != want_l:
            raise AssertionError(f"{arch}: launches {launches}, expected "
                                 f"{want_l} ((prefill + {steps} steps) x "
                                 f"{layers} layers x 3 for gmm)")
        gstep, g_ms, g_launches = graphed_decode(
            torch, f"{arch} decode", params, cfg, cache0, fed, outs[1:],
            cache, prompt, {"decode_attention": ("mma", layers),
                            "gmm": ("wgmma_splitk", 3 * layers)})
        got = torch.cat(outs)                               # [prompt+steps, V]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{arch}: non-finite logits")
        kern_routes = [torch.cat(r) for r in kern_routes]
        ext = torch.cat([tokens] + fed, dim=1)

        def plain_forward(p, c):
            routes.clear()
            ops.gmm, moe.route = ref.gmm, tapped_route
            try:
                out = M.forward(p, c, ext, "torch", "torch")[0][0].clone()
            finally:
                ops.gmm, moe.route = real_gmm, real_route
            return out, list(routes)
        plain, plain_routes = plain_forward(params, cfg)
        p32 = M.tree_map(lambda t: t.float(), params)
        want, want_routes = plain_forward(
            p32, dataclasses.replace(cfg, dtype="float32"))
        del p32
    agree = torch.ones(ext.shape[1], dtype=torch.bool, device="cuda")
    flips = {"kernel": 0, "plain": 0}
    for li in range(layers):
        for name, rt in (("kernel", kern_routes), ("plain", plain_routes)):
            same, n = _route_sets_agree(rt[li], want_routes[li])
            agree &= same
            flips[name] += n
    n_ok = int(agree.sum())
    kern = rel_l2(got[agree], want[agree])
    plain_d = rel_l2(plain[agree], want[agree])
    gate = 2 * plain_d
    log(f"[moe] {arch} {layers} layers bf16, prompt {prompt} + {steps} steps: "
        f"(token, choice) pairs routed to another expert than in the float32 "
        f"forward, over {layers} layers x {ext.shape[1]} tokens x {k}: "
        f"kernel path {flips['kernel']}, plain bf16 forward {flips['plain']}; "
        f"{n_ok} of {ext.shape[1]} tokens routed alike at every layer. On "
        f"those, relative L2 err of the logits (prefill and decoded) against "
        f"the float32 forward: kernel path {kern}, plain bf16 forward "
        f"{plain_d} (gate {gate}); over all tokens {rel_l2(got, want)} and "
        f"{rel_l2(plain, want)}")
    if n_ok < 64:
        raise AssertionError(f"{arch}: only {n_ok} tokens routed alike")
    if not kern <= gate:
        raise AssertionError(f"{arch}: logits off by {kern}, above {gate}")
    med = statistics.median(step_ms)
    g_med = statistics.median(g_ms)
    log(f"[moe] {arch} bf16: prefill of {prompt} tokens {prefill_ms} ms; "
        f"median {med} ms per decoded token over {len(step_ms)} untapped "
        f"eager steps (min {min(step_ms)}, max {max(step_ms)}), graphed "
        f"{g_med} over {len(g_ms)} replays (min {min(g_ms)}, max "
        f"{max(g_ms)}); launches {launches}, the graphed run's {g_launches}")
    for name in ("decode_attention", "gmm"):
        launches[name] += g_launches[name]
    step = lambda: M.decode_step(params, cfg, nxt, cache, pos)
    rows = profile_fn(torch, f"{arch} decode_step at pos {prompt + steps - 1}",
                      step)
    check_decode_launches(rows, dec_by_kernel, layers, steps, arch)
    g_rows = profile_fn(torch, f"{arch} graphed decode_step at pos "
                        f"{prompt + steps - 1}", lambda: gstep(nxt, pos))
    check_decode_launches(g_rows, dec_by_kernel, layers, steps,
                          f"{arch} graphed")
    log(f"[moe] {arch}: device busy a step {busy_ms(rows)} ms eager, "
        f"{busy_ms(g_rows)} ms graphed; busy share of the median step eager "
        f"{busy_ms(rows) / med:.3f}, graphed {busy_ms(g_rows) / g_med:.3f}")
    prefill_profile(torch, arch, params, cfg, tokens, cache)
    del params, cache, cache0, gstep, got, want, plain
    torch.cuda.empty_cache()
    return launches


#: kernel-name fragments of each kind of device work, for a profile's
#: breakdown (the first that matches names the kind; the rest is
#: elementwise and reduction work)
KERNEL_KINDS = (
    ("gmm", ("gmm_",)), ("flash", ("flash_",)), ("decode attention",
                                                ("decode_",)),
    ("ssd", ("ssd_",)),
    ("cuBLAS GEMM", ("nvjet", "gemm", "gemv", "xmma", "cutlass")),
    ("copies and indexing", ("copy", "Memcpy", "Memset", "index", "gather",
                             "scatter", "cat_", "CatArray")),
    ("sort", ("sort", "Sort", "radix", "Radix")),
)


def kernel_kinds(rows) -> dict:
    """Device ms of a profile's kernels by ``KERNEL_KINDS``."""
    out = dict.fromkeys([k for k, _ in KERNEL_KINDS] + ["elementwise"], 0.0)
    for us, _, key in rows:
        kind = next((k for k, frags in KERNEL_KINDS
                     if any(f in key for f in frags)), "elementwise")
        out[kind] += us / 1e3
    return out


def prefill_profile(torch, arch: str, params, cfg, tokens, cache) -> None:
    """Where a prefill's time goes: its median wall eager and graphed (the
    prefill captured into a CUDA graph over ``cache``), one profiled call
    of each, device ms by kind of kernel, and the share of the wall the
    device is busy. The host's share is the rest."""
    from repro_torch import graphs
    from repro_torch.models import model as M
    eager = lambda: M.prefill(params, cfg, tokens, cache)[0]
    graph = graphs.GraphedForward(lambda p, t: M.prefill(p, cfg, t, cache)[0])
    with torch.inference_mode():
        for name, fn in (("eager", eager),
                         ("graphed", lambda: graph(params, tokens))):
            ms = wall_ms(torch, fn)
            rows = profile_fn(torch, f"{arch} prefill of "
                              f"{tokens.shape[1]} {name}", fn)
            kinds = {k: round(v, 4) for k, v in kernel_kinds(rows).items()}
            log(f"[moe] {arch} prefill of {tokens.shape[1]} {name}: median "
                f"wall {ms} ms, device busy {busy_ms(rows)} ms (share "
                f"{busy_ms(rows) / ms:.3f}); device ms by kind {kinds}")
    del graph
    torch.cuda.empty_cache()


#: the MoE runs at full width: (arch, layers, prompt, decode steps, cache
#: rows, seed); depth cut to fit the card: phi3.5-moe's 32 layers are ~83 GB
#: in bf16
MOE_FULL_WIDTH = [
    (MOE_ARCHS[0], 4, 1024, 32, 1056, 7),
    (MOE_ARCHS[1], 2, 1024, 8, 1056, 8),
]


def moe_phase(torch, gen):
    headline = check_gmm_kernel(torch, gen)
    check_decode_kernel(torch, gen, DECODE_MOE_CASES)
    check_moe_models(torch)
    runs = [moe_full_width(torch, arch, layers=layers, prompt=prompt,
                           steps=steps, max_seq=max_seq, seed=seed)
            for arch, layers, prompt, steps, max_seq, seed in MOE_FULL_WIDTH]
    return headline, {n: sum(r[n] for r in runs) for n in runs[0]}


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------

#: the full-width train run: (arch, seq, batch, steps), at the reference
#: launch/train.py's defaults (batch 8 of 128 tokens, lr 3e-3)
TRAIN_FULL_WIDTH = ("gemma2-2b", 128, 8, 6)
#: the crash-restart run: (arch, seq, batch, accum, steps, fail at, ckpt
#: every), with --compress-grads' CompressionConfig()
TRAIN_RESTART = ("mamba2-130m", 512, 8, 2, 6, 3, 2)
#: card against CPU, one float32 step at smoke width: the tolerances of
#: tests/test_torch_training.py (metrics; gradients; params, m and v)
TRAIN_METRIC_RTOL = 1e-5
TRAIN_GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
TRAIN_STATE_TOL = dict(atol=1e-5, rtol=1e-4)


def kernel_modules() -> dict:
    from repro_torch.kernels import adamw as adamw_mod
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gmm_mod
    from repro_torch.kernels import mamba_front as front_mod
    from repro_torch.kernels import ssd as ssd_mod
    return {"flash_attention": fa, "ssd": ssd_mod, "decode_attention": dec,
            "gmm": gmm_mod, "adamw": adamw_mod, "mamba_front": front_mod}


def kernel_counts() -> dict:
    from repro_torch.kernels import build
    return {name: n for name, (n, _) in build.counts().items()}


def reset_kernel_counters() -> None:
    """Every kernel's launch counters to 0."""
    for mod in kernel_modules().values():
        mod.launches = 0
        if hasattr(mod, "kernel_launches"):
            mod.kernel_launches = dict.fromkeys(mod.kernel_launches, 0)


class train_launches:
    """Raises on exit unless, inside, none of the forward kernels
    launched (the train step goes through the torch path: no forward kernel
    has a backward) and the AdamW kernel launched ``adamw`` times (one
    launch a params leaf a step, graphed steps through their replays).
    ``train_launches.adamw_total`` adds up every such run's AdamW launches
    (the ``kernels`` line's count)."""

    adamw_total = 0

    def __init__(self, label: str, adamw: int):
        self.label, self.adamw = label, adamw

    def __enter__(self):
        self.before = kernel_counts()

    def __exit__(self, exc_type, *exc):
        after = kernel_counts()
        if exc_type is not None:
            return False
        added = {k: after[k] - self.before[k] for k in after}
        want = dict.fromkeys(added, 0) | {"adamw": self.adamw}
        if added != want:
            raise AssertionError(f"{self.label}: kernels launched {added}, "
                                 f"expected {want}")
        train_launches.adamw_total += added["adamw"]
        return False


def n_leaves(tree) -> int:
    from repro_torch.models import model as M
    return len(M.tree_leaves(tree))


def flat_tree(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flat_tree(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def check_train_smoke(torch) -> None:
    """One float32 train step at smoke width (vocab 512), card against CPU
    from the same CPU-drawn params and a mid-run optimizer state (m, v and
    the step drawn from a seed: a first step from zeros makes Adam's update
    g / (|g| + eps), the sign of float noise where a gradient is zero in
    exact arithmetic, as qwen's key bias's is)."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import model as M
    from repro_torch.training import (OptimConfig, TrainConfig,
                                      build_grad_fn, build_train_step,
                                      init_train_state)

    for arch in ("qwen1.5-4b", "mamba2-130m"):
        cfg = dataclasses.replace(smoke_config(arch), vocab_size=512,
                                  dtype="float32")
        tcfg = TrainConfig(optim=OptimConfig(learning_rate=1e-2,
                                             warmup_steps=2, total_steps=20))
        cpu = init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                               "cpu")
        g = torch.Generator().manual_seed(7)
        cpu["opt"]["m"] = M.tree_map(
            lambda p: 1e-2 * torch.randn(p.shape, generator=g), cpu["params"])
        cpu["opt"]["v"] = M.tree_map(
            lambda p: 1e-5 + 9e-5 * torch.rand(p.shape, generator=g),
            cpu["params"])
        cpu["opt"]["step"] = torch.tensor(10, dtype=torch.int32)
        card = M.tree_map(lambda t: t.to("cuda"), cpu)
        b = SyntheticLMData(vocab_size=512, seq_len=64, global_batch=4,
                            seed=3).batch(0)
        bc = {k: torch.from_numpy(v) for k, v in b.items()}
        bg = {k: v.to("cuda") for k, v in bc.items()}
        with train_launches(f"{arch} smoke train step",
                            adamw=n_leaves(card["params"])):
            grads_c, _ = build_grad_fn(cfg, tcfg)(cpu["params"], bc)
            grads_g, _ = build_grad_fn(cfg, tcfg)(card["params"], bg)
            step = build_train_step(cfg, tcfg)
            _, mc = step(cpu, bc)
            _, mg = step(card, bg)
            torch.cuda.synchronize()
        g_err = max(close(f"{arch} grad {n}", a.cpu(), b, **TRAIN_GRAD_TOL)
                    for (n, a), (_, b) in zip(flat_tree(grads_g),
                                              flat_tree(grads_c)))
        m_err = max(close(f"{arch} metric {k}", mg[k].cpu(), mc[k], 0.0,
                          TRAIN_METRIC_RTOL) for k in mc)
        s_err = max(close(f"{arch} state {n}", a.cpu(), b, **TRAIN_STATE_TOL)
                    for (n, a), (_, b) in zip(flat_tree(card),
                                              flat_tree(cpu)))
        log(f"[train] {arch} smoke fp32 vocab 512, one step: card vs CPU "
            f"loss {float(mg['loss'])} / {float(mc['loss'])}; max abs err "
            f"metrics {m_err} (rtol {TRAIN_METRIC_RTOL}), grads {g_err} "
            f"({TRAIN_GRAD_TOL}), params, m, v {s_err} ({TRAIN_STATE_TOL}); "
            f"no forward kernel launched, the AdamW kernel once a leaf")


def train_setup(torch):
    """gemma2-2b's train run at TRAIN_FULL_WIDTH: (cfg, tcfg, its
    synthetic data)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.training import OptimConfig, TrainConfig

    arch, seq, batch, steps = TRAIN_FULL_WIDTH
    cfg = get_config(arch)
    tcfg = TrainConfig(optim=OptimConfig(learning_rate=3e-3,
                                         warmup_steps=steps // 10,
                                         total_steps=steps))
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=batch, seed=0)
    return cfg, tcfg, data


def on_card(batch: dict) -> dict:
    import torch
    return {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}


def eager_steps(torch, cfg, tcfg, state, batches) -> tuple[list, list]:
    """``build_train_step``'s function called in a loop on ``state``: the
    eager control of the graphed ``Trainer``. Returns the metrics as
    ``Trainer`` keeps them and each step's ms (host clock, synchronised)."""
    from repro_torch.training import build_train_step
    step_fn = build_train_step(cfg, tcfg)
    hist, ms = [], []
    for i, b in enumerate(batches):
        b = on_card(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step_fn(state, b)
        m = {k: float(v) for k, v in m.items()}
        ms.append((time.perf_counter() - t0) * 1e3)
        hist.append(m | {"step": int(state["opt"]["step"])})
    return hist, ms


def train_graphed_bitwise(torch, card: str) -> None:
    """gemma2-2b at TRAIN_FULL_WIDTH under deterministic algorithms: the
    eager loop (``build_train_step`` in a loop from the seed ``Trainer``
    draws its state from), its final params, m and v kept on the host, then
    the graphed ``Trainer`` over the same batches: every step's metrics and
    the final params, m and v equal bit for bit. Steps 1-2 are its eager
    warm-up steps, step 3 is captured and replayed, 4-6 are replays."""
    from repro_torch import graphs
    from repro_torch.training import Trainer, init_train_state

    arch, seq, batch, steps = TRAIN_FULL_WIDTH
    cfg, tcfg, data = train_setup(torch)
    batches = [data.batch(i) for i in range(steps)]
    torch.cuda.empty_cache()
    with deterministic() as det0:
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                 cfg, tcfg, "cuda")
        leaves = n_leaves(state["params"])
        with train_launches(f"{arch} eager loop", adamw=steps * leaves):
            want_hist, _ = eager_steps(torch, cfg, tcfg, state, batches)
    want = {n: x.cpu() for n, x in flat_tree(state)}
    del state
    torch.cuda.empty_cache()
    with deterministic() as det1, \
            train_launches(f"{arch} graphed Trainer", adamw=steps * leaves):
        tr = Trainer(cfg=cfg, tcfg=tcfg, data=iter(batches), log_every=1000,
                     device="cuda")
        if not isinstance(tr._step_fn, graphs.GraphedTrainStep):
            raise AssertionError(f"{arch}: Trainer on CUDA is not graphed")
        tr.init_or_resume(resume="never")
        hist = tr.run(steps)
    if len(tr._step_fn.graphs) != 1:
        raise AssertionError(f"{arch}: {len(tr._step_fn.graphs)} graphs "
                             f"captured, expected 1")
    if hist != want_hist:
        raise AssertionError(f"{arch}: graphed metrics {hist}, eager "
                             f"{want_hist}")
    for n, x in flat_tree(tr.state):
        if not torch.equal(x.cpu(), want.pop(n)):
            raise AssertionError(f"{arch}: graphed state {n} differs from "
                                 f"the eager loop's")
    log(f"[train] {arch} (published config) batch {batch} x {seq}, {steps} "
        f"steps under deterministic algorithms: the graphed Trainer (steps "
        f"1-{graphs.WARMUP_CALLS} eager warm-up, step "
        f"{graphs.WARMUP_CALLS + 1} captured and replayed, then replays) "
        f"equals the eager loop bit for bit, losses "
        f"{[m['loss'] for m in hist]}, every metric and the final params, m, "
        f"v and step; AdamW launches {steps} x {leaves} leaves in each; ops "
        f"without a deterministic kernel: eager {det0.nondet}, graphed "
        f"{det1.nondet}; {card}")
    del tr, want
    torch.cuda.empty_cache()


def train_full_width(torch, card: str) -> tuple[float, dict]:
    """gemma2-2b at its published config (26 layers, vocab 256000), bf16
    compute over float32 master params and AdamW state, through the graphed
    ``Trainer`` for TRAIN_FULL_WIDTH's steps, its launch counters reset
    before: step time (host clock around each step, which ends on reading
    its metrics), tokens/s, the memory the graph holds and the model-FLOPs
    share of the bf16 peak; one replay profiled. Then the eager control on
    the same state: the same steps through ``build_train_step``'s function
    in a loop, its step time and peak memory, one eager step profiled.
    Returns the graphed median step ms and the leaf shapes."""
    from repro_torch import graphs
    from repro_torch.models import model as M
    from repro_torch.training import Trainer, build_train_step

    arch, seq, batch, steps = TRAIN_FULL_WIDTH
    cfg, tcfg, data = train_setup(torch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg=cfg, tcfg=tcfg, data=iter(data), log_every=1,
                      log_fn=lambda s: log(f"[train] {arch} {s}"),
                      device="cuda")
    trainer.init_or_resume(resume="never")
    leaves = n_leaves(trainer.state["params"])
    reset_kernel_counters()
    with train_launches(f"{arch} graphed training", adamw=steps * leaves):
        hist = trainer.run(steps)
    launches = kernel_counts()
    wall = time.perf_counter() - t0
    stats = torch.cuda.memory_stats()
    total = torch.cuda.get_device_properties(0).total_memory
    g_peak = torch.cuda.max_memory_allocated()
    g_reserved = torch.cuda.memory_reserved()
    g_pool = graph_pool_bytes(torch, trainer._step_fn)
    tally, _ = remat_tally(cfg, seq, batch, cfg.remat)
    n_params = sum(p.numel() for p in M.tree_leaves(trainer.state["params"]))
    shapes = [tuple(p.shape) for p in M.tree_leaves(trainer.state["params"])]
    times = [t * 1e3 for t in trainer.straggler.times]
    for m in hist:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{arch} step {m['step']}: non-finite {bad}")
        if m["tokens"] != seq * batch:
            raise AssertionError(f"{arch} step {m['step']}: {m['tokens']} "
                                 f"tokens, expected {seq * batch}")
    if not g_reserved < total:
        raise AssertionError(f"{arch}: reserved memory {g_reserved} above "
                             f"the card's {total}")
    # the replays after the capture's step
    med = statistics.median(times[graphs.WARMUP_CALLS + 1:])
    tok_s = seq * batch / (med / 1e3)
    share = 6 * n_params * seq * batch / (med / 1e3) / PEAK_BF16
    log(f"[train] {arch} ({cfg.num_layers} layers, {n_params} parameters in "
        f"{leaves} leaves, float32 master params and AdamW state, bf16 "
        f"compute), batch {batch} x {seq} tokens, graphed Trainer, {steps} "
        f"steps in {wall:.1f} s with set-up: step ms {times} (steps 1-"
        f"{graphs.WARMUP_CALLS} eager warm-up, {graphs.WARMUP_CALLS + 1} "
        f"capture and replay); median replayed step {med} ms over steps "
        f"{graphs.WARMUP_CALLS + 2}-{steps}, {tok_s} tokens/s, model-FLOPs "
        f"share {share} of {PEAK_BF16 / 1e12:.0f} TFLOP/s bf16 (6 N tokens "
        f"/ step time); peak allocated {g_peak} bytes (the warm-up steps "
        f"included), reserved with the graph's pool {g_reserved} of {total}, "
        f"the pool {g_pool} against the dry-run's peak of the step "
        f"{tally.peak_bytes}; "
        f"cudaMalloc calls {stats['num_device_alloc']}, retries "
        f"{stats['num_alloc_retries']}; launches {launches}; losses "
        f"{[m['loss'] for m in hist]}; {card}")

    # where a step's time goes: a replay, then an eager step, profiled
    # (autograd back on inside profile_fn's inference mode)
    one = on_card(data.batch(steps))

    def replay():
        with torch.inference_mode(False):
            trainer._step_fn(trainer.state, one)
    host_g: dict = {}
    with train_launches(f"{arch} profiled replays", adamw=2 * leaves):
        rows_g = profile_fn(torch, f"{arch} graphed train step (batch "
                            f"{batch} x {seq})", replay, host=host_g)
    if len(trainer._step_fn.graphs) != 1:
        raise AssertionError(f"{arch}: the profiled step captured again")
    trainer._step_fn.graphs.clear()      # the graph's pool back
    del hist
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_fn = build_train_step(cfg, tcfg)

    def eager():
        with torch.inference_mode(False):
            step_fn(trainer.state, one)
    host_e: dict = {}
    with train_launches(f"{arch} profiled eager steps", adamw=2 * leaves):
        rows_e = profile_fn(torch, f"{arch} eager train step (batch "
                            f"{batch} x {seq})", eager, host=host_e)
    with train_launches(f"{arch} eager steps", adamw=steps * leaves):
        _, e_ms = eager_steps(torch, cfg, tcfg, trainer.state,
                              [data.batch(steps + 1 + i)
                               for i in range(steps)])
    e_peak = torch.cuda.max_memory_allocated()
    e_reserved = torch.cuda.max_memory_reserved()
    e_med = statistics.median(e_ms[1:])
    busy = {"graphed": busy_ms(rows_g), "eager": busy_ms(rows_e)}
    kern = {"graphed": sum(r[1] for r in rows_g),
            "eager": sum(r[1] for r in rows_e)}
    upd = {k: sum(r[0] for r in rows if "adamw_kernel" in r[2]) / 1e3
           for k, rows in (("graphed", rows_g), ("eager", rows_e))}
    log(f"[train] {arch} graphed vs eager step: median ms {med} / {e_med} "
        f"(x{e_med / med:.2f}; eager steps {e_ms}); device busy "
        f"{busy['graphed']} / {busy['eager']} ms a profiled step, busy share "
        f"{busy['graphed'] / med:.3f} / {busy['eager'] / e_med:.3f}; device "
        f"kernels a step {kern['graphed']} / {kern['eager']}; host launch "
        f"calls a step {host_g} / {host_e}; the AdamW kernel's device ms a "
        f"step {upd['graphed']} / {upd['eager']}; memory: graphed reserved "
        f"{g_reserved} bytes (state and the graph's pool), eager peak "
        f"allocated {e_peak}, peak reserved {e_reserved}; {card}")
    del trainer
    torch.cuda.empty_cache()
    return med, {"shapes": shapes, "params": n_params, "leaves": leaves}


#: the rematerialisation runs (phase 10): gemma2-2b at its published config,
#: (arch, seq, batch, steps) under each policy, the eager loop and the
#: graphed ``Trainer``; then one graphed step at REMAT_LONG_SEQ under
#: "dots_nobatch" where the dry-run's tally puts "none" over the card's
#: memory there and "dots_nobatch" under it
TRAIN_REMAT = ("gemma2-2b", 2048, 1, 3)
REMAT_LONG_SEQ = 4096
#: replays timed after each graphed run's bit-equality check
REMAT_TIMED_REPLAYS = 3
#: the dry-run's tally of a step's peak bytes against the card's
#: ``max_memory_allocated`` delta over the step
REMAT_MEMORY_RTOL = 0.10


def graph_pool_bytes(torch, step) -> int:
    """The bytes the memory pool of the one CUDA graph of ``step`` (a
    ``GraphedTrainStep``) reserves. Holds no reference to the graph: one
    held would keep its pool from the allocator after the step drops it."""
    (g,) = step.graphs.values()
    pool = tuple(g.graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == pool)


def remat_tally(cfg, seq: int, batch: int, policy: str):
    """The dry-run's count of the mesh-less train step on meta tensors under
    ``policy`` (``dryrun.tally_cell``): (its Tally, the step's argument
    bytes: the state and the batch)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun as D
    cell = ShapeCell(f"train_{seq}", seq, batch, "train")
    tally = D.tally_cell(cfg.name, cell, cfg, remat=policy)
    inputs, _ = D._cell_inputs(cfg, cell)
    return tally, sum(x.numel() * x.element_size()
                      for _, x in flat_tree(inputs))


def hold_state(label: str, got: dict, want: dict, nondet: list) -> str:
    """Every leaf of the state ``got`` against the host copy ``want``: equal
    bit for bit, or, only when the deterministic settings reported an op
    without a deterministic kernel (``nondet``), within phase 10's state
    tolerance. Returns how they were held."""
    import torch
    loose = []
    for n, x in flat_tree(got):
        w = want[n].to(x.device)
        if torch.equal(x, w):
            continue
        if not nondet:
            raise AssertionError(f"{label}: state {n} differs from the "
                                 f"eager 'none' run's")
        close(f"{label} state {n}", x.cpu(), want[n], **TRAIN_STATE_TOL)
        loose.append(n)
    return ("bit for bit" if not loose else
            f"{len(loose)} leaves within {TRAIN_STATE_TOL} (ops without a "
            f"deterministic kernel: {nondet})")


def hold_metrics(label: str, got: list, want: list, nondet: list) -> None:
    """Each step's metrics against the eager "none" run's, as
    ``hold_state`` holds the state."""
    import torch
    if got == want:
        return
    if not nondet:
        raise AssertionError(f"{label}: metrics {got}, the eager 'none' "
                             f"run's {want}")
    for g, w in zip(got, want):
        for k in w:
            close(f"{label} metric {k}", torch.tensor(g[k]),
                  torch.tensor(w[k]), 0.0, TRAIN_METRIC_RTOL)


def remat_eager(torch, cfg, tcfg, batches) -> tuple:
    """``build_train_step``'s function under ``cfg.remat`` in a loop from
    the seed under deterministic algorithms: (metrics, step ms, each step's
    ``max_memory_allocated`` less the bytes allocated before it, the state,
    the ops without a deterministic kernel)."""
    from repro_torch.training import build_train_step, init_train_state
    step_fn = build_train_step(cfg, tcfg)
    with deterministic() as det:
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                 cfg, tcfg, "cuda")
        hist, ms, peaks = [], [], []
        with train_launches(f"{cfg.name} eager remat={cfg.remat}",
                            adamw=len(batches) * n_leaves(state["params"])):
            for b in batches:
                b = on_card(b)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                _, m = step_fn(state, b)
                m = {k: float(v) for k, v in m.items()}
                ms.append((time.perf_counter() - t0) * 1e3)
                peaks.append(torch.cuda.max_memory_allocated() - before)
                hist.append(m | {"step": int(state["opt"]["step"])})
    return hist, ms, peaks, state, det.nondet


def remat_graphed(torch, cfg, tcfg, batches, more, want: dict,
                  want_hist: list) -> tuple:
    """The graphed ``Trainer`` under ``cfg.remat`` from the seed over
    ``batches`` (its eager warm-up steps, then the captured step) under
    deterministic algorithms, its metrics and state held to the eager
    "none" run's (``want_hist``, ``want``), then ``more`` replays timed:
    (the metrics, how the state was held, the replays' ms, the graph pool's
    reserved bytes, the ops without a deterministic kernel)."""
    from repro_torch import graphs
    from repro_torch.training import Trainer
    label = f"{cfg.name} graphed remat={cfg.remat}"
    tr = Trainer(cfg=cfg, tcfg=tcfg, data=iter(batches + more),
                 log_every=1000, device="cuda")
    if not isinstance(tr._step_fn, graphs.GraphedTrainStep):
        raise AssertionError(f"{cfg.name}: Trainer on CUDA is not graphed")
    tr.init_or_resume(resume="never")
    leaves = n_leaves(tr.state["params"])
    with deterministic() as det, \
            train_launches(label, adamw=len(batches) * leaves):
        hist = tr.run(len(batches))
    hold_metrics(label, hist, want_hist, det.nondet)
    held = hold_state(label, tr.state, want, det.nondet)
    pool = graph_pool_bytes(torch, tr._step_fn)
    with train_launches(f"{label} replays", adamw=len(more) * leaves):
        tr.run(len(batches) + len(more))
    if len(tr._step_fn.graphs) != 1:
        raise AssertionError(f"{label}: {len(tr._step_fn.graphs)} graphs "
                             f"captured, expected 1")
    ms = [t * 1e3 for t in list(tr.straggler.times)[len(batches):]]
    del tr
    torch.cuda.empty_cache()
    return hist, held, ms, pool, det.nondet


def remat_long(torch, cfg0, tcfg, card: str) -> None:
    """gemma2-2b at batch 1 x REMAT_LONG_SEQ: the dry-run's tally of the
    step under "none" and "dots_nobatch" against the card's 80 GB
    (arguments plus the step's peak); where "none" is over and
    "dots_nobatch" under, the graphed ``Trainer`` under "dots_nobatch" for
    its warm-up steps and one captured and replayed step: every metric
    finite, its peak bytes against the tally's."""
    from repro_torch.launch.dryrun import HBM_BYTES
    arch, _, batch, _ = TRAIN_REMAT
    seq = REMAT_LONG_SEQ
    need = {}
    for policy in ("none", "dots_nobatch"):
        tally, args = remat_tally(dataclasses.replace(cfg0, remat=policy),
                                  seq, batch, policy)
        need[policy] = (tally, args + tally.peak_bytes)
    fits = {p: n <= HBM_BYTES for p, (_, n) in need.items()}
    log(f"[remat] {arch} batch {batch} x {seq}: the dry-run's arguments plus "
        f"peak bytes {({p: n for p, (_, n) in need.items()})} against the "
        f"card's {HBM_BYTES:.0f}: fits {fits}")
    if fits["none"] or not fits["dots_nobatch"]:
        log(f"[remat] {arch} batch {batch} x {seq}: no run (it runs where "
            f"'none' is over and 'dots_nobatch' under)")
        return
    from repro_torch import graphs
    from repro_torch.data import SyntheticLMData
    from repro_torch.training import Trainer
    cfg = dataclasses.replace(cfg0, remat="dots_nobatch")
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=batch, seed=0)
    torch.cuda.empty_cache()
    tr = Trainer(cfg=cfg, tcfg=tcfg, data=iter(data), log_every=1000,
                 device="cuda")
    tr.init_or_resume(resume="never")
    steps = graphs.WARMUP_CALLS + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with train_launches(f"{arch} x {seq} graphed remat=dots_nobatch",
                        adamw=steps * n_leaves(tr.state["params"])):
        hist = tr.run(steps)
    peak = torch.cuda.max_memory_allocated() - before
    reserved = torch.cuda.memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    for m in hist:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{arch} x {seq} step {m['step']}: "
                                 f"non-finite {bad}")
    if len(tr._step_fn.graphs) != 1:
        raise AssertionError(f"{arch} x {seq}: no graph captured")
    tally = need["dots_nobatch"][0]
    pool = graph_pool_bytes(torch, tr._step_fn)
    log(f"[remat] {arch} batch {batch} x {seq} under dots_nobatch through "
        f"the graphed Trainer: {steps} steps (the last captured and "
        f"replayed), losses {[m['loss'] for m in hist]}, step ms "
        f"{[t * 1e3 for t in tr.straggler.times]}; max_memory_allocated "
        f"less the state's {peak} bytes against the dry-run's peak "
        f"{tally.peak_bytes} (ratio {peak / tally.peak_bytes:.4f}); the "
        f"graph pool reserves {pool}; reserved {reserved} of {total}; "
        f"{card}")
    del tr
    torch.cuda.empty_cache()


def train_remat(torch, card: str) -> None:
    """gemma2-2b at its published config, batch TRAIN_REMAT, under each of
    the four rematerialisation policies (``cfg.remat``, each layer group of
    ``forward`` checkpointed by ``models.remat``): the eager loop and the
    graphed ``Trainer`` from the same seed under deterministic algorithms,
    every metric and the final params, m and v equal to the eager "none"
    run's bit for bit; step ms eager and graphed (replays); each eager
    step's ``max_memory_allocated`` less the bytes allocated before it,
    against the dry-run's tally of the same step on meta tensors (within
    REMAT_MEMORY_RTOL); the graph pool's reserved bytes. Then
    ``remat_long``."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.remat import POLICIES

    arch, seq, batch, steps = TRAIN_REMAT
    cfg0, tcfg, _ = train_setup(torch)
    data = SyntheticLMData(vocab_size=cfg0.vocab_size, seq_len=seq,
                           global_batch=batch, seed=0)
    batches = [data.batch(i) for i in range(steps)]
    more = [data.batch(steps + i) for i in range(REMAT_TIMED_REPLAYS)]
    want = want_hist = None
    rows = []
    for policy in POLICIES:
        cfg = dataclasses.replace(cfg0, remat=policy)
        t0 = time.perf_counter()
        tally, _ = remat_tally(cfg, seq, batch, policy)
        t_tally = time.perf_counter() - t0
        torch.cuda.empty_cache()
        hist, e_ms, peaks, state, nd_e = remat_eager(torch, cfg, tcfg,
                                                     batches)
        if want is None:
            want = {n: x.cpu() for n, x in flat_tree(state)}
            want_hist, held_e = hist, "the reference"
        else:
            hold_metrics(f"{arch} eager remat={policy}", hist, want_hist,
                         nd_e)
            held_e = hold_state(f"{arch} eager remat={policy}", state, want,
                                nd_e)
        del state
        torch.cuda.empty_cache()
        g_hist, held_g, g_ms, pool, nd_g = remat_graphed(
            torch, cfg, tcfg, batches, more, want, want_hist)
        measured = peaks[-1]
        err = abs(tally.peak_bytes - measured) / measured
        rows.append((policy, statistics.median(e_ms[1:]),
                     statistics.median(g_ms), measured, tally.peak_bytes,
                     pool))
        log(f"[remat] {arch} (published config) batch {batch} x {seq}, "
            f"remat={policy}: the eager loop and the graphed Trainer (steps "
            f"1-2 eager warm-up, 3 captured and replayed), {steps} steps "
            f"each under deterministic algorithms, losses "
            f"{[m['loss'] for m in hist]} / {[m['loss'] for m in g_hist]}; "
            f"against the eager 'none' run: eager {held_e}, graphed "
            f"{held_g}; ops without a deterministic kernel: eager {nd_e}, "
            f"graphed {nd_g}; step ms eager {e_ms}, graphed replays {g_ms}; "
            f"max_memory_allocated less the bytes before each eager step "
            f"{peaks}; the dry-run's tally of the step on meta tensors "
            f"{tally.peak_bytes} bytes (temp "
            f"{tally.peak_bytes - tally.output_bytes}, output "
            f"{tally.output_bytes}; counted in {t_tally:.1f} s), off by "
            f"{err:.4f} of the card's (gate {REMAT_MEMORY_RTOL}); the graph "
            f"pool reserves {pool} bytes; counted FLOPs {tally.flops}; {card}")
        if err > REMAT_MEMORY_RTOL:
            raise AssertionError(f"{arch} remat={policy}: the dry-run's peak "
                                 f"{tally.peak_bytes} bytes, the card's "
                                 f"{measured}")
    del want
    log(f"[remat] {arch} batch {batch} x {seq}, per policy (policy, eager "
        f"median ms of steps 2-{steps}, graphed median replay ms, card peak "
        f"bytes of a step, the dry-run's, graph pool reserved bytes): "
        f"{rows}; {card}")
    remat_long(torch, cfg0, tcfg, card)


#: odd leaf sizes the AdamW kernel is held to its plain version at
ADAMW_ODD_SIZES = (1, 255, 257, 2 ** 20 + 3)


def adamw_scalars(torch, clip: bool, grads=None):
    """lr, the bias corrections at step 7 of TRAIN_FULL_WIDTH's schedule,
    and a clip scale below 1 (from ``grads``' global norm), on the card."""
    from repro_torch.training import OptimConfig, lr_at
    from repro_torch.training.optim import global_norm

    _, _, _, steps = TRAIN_FULL_WIDTH
    cfg = OptimConfig(learning_rate=3e-3, warmup_steps=steps // 10,
                      total_steps=2 * steps)
    step = torch.tensor(7, dtype=torch.int32, device="cuda")
    sc = dict(lr=lr_at(cfg, step), b1c=1.0 - cfg.b1 ** step.float(),
              b2c=1.0 - cfg.b2 ** step.float(), scale=None)
    if clip:
        sc["scale"] = torch.clamp(0.5 / (global_norm(grads) + 1e-9), max=1.0)
    return sc, dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps)


def adamw_leaf(torch, gen, shape, dtype=None):
    """p, g, m, v of a run under way: p (float32, or ``dtype``) ~ N(0, 1),
    g ~ N(0, 1e-2), m ~ N(0, 1e-3), v ~ U(0, 1e-5)."""
    f32 = dict(generator=gen, device="cuda")
    p = torch.randn(shape, **f32)
    g = 1e-2 * torch.randn(shape, **f32)
    m = 1e-3 * torch.randn(shape, **f32)
    v = 1e-5 * torch.rand(shape, **f32)
    return (p.to(dtype) if dtype is not None else p), g, m, v


def check_adamw(torch, info: dict, card: str) -> dict:
    """The AdamW kernel against its plain version on the card: at every
    leaf shape of gemma2-2b (one launch a leaf, decayed where the leaf is a
    matrix) and at ADAMW_ODD_SIZES, with float32 and bfloat16 params, with
    and without clipping: p, m and v equal bit for bit. Then one step's
    leaves (float32, as the train step's) timed: the kernel over every leaf,
    the plain version, ``torch._fused_adamw_`` on the same leaves (the
    yardstick the port never calls: its formula differs), the two global
    norms of the step, and the bound (the bytes over the card's rate).
    Returns the ``kernels`` line's numbers."""
    from repro_torch.kernels import adamw as adamw_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.training.optim import _is_matrix, global_norm

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(17)
    wd = 0.1
    cases = [(s, "gemma2-2b") for s in info["shapes"]] + [
        ((n,), "odd") for n in ADAMW_ODD_SIZES]
    checked = 0
    for shape, what in cases:
        leaf = adamw_leaf(torch, gen, shape)
        decay = wd if len(shape) >= 2 else 0.0
        for dtype in (torch.float32, torch.bfloat16):
            for clip in (False, True):
                sc, kw = adamw_scalars(torch, clip, {"g": leaf[1]})
                want = [leaf[0].to(dtype, copy=True)] + [
                    t.clone() for t in leaf[1:]]
                got = [t.clone() for t in want]
                ref.adamw(*want, **sc, **kw, weight_decay=decay)
                ops.adamw(*got, **sc, **kw, weight_decay=decay)
                for name, a, b in zip("pgmv", got, want):
                    if not torch.equal(a, b):
                        err = float((a.float() - b.float()).abs().max())
                        raise AssertionError(
                            f"adamw {what} {shape} {dtype} clip={clip}: {name}"
                            f" differs from the plain version (max abs "
                            f"{err})")
                checked += 1
                del want, got
        del leaf
    torch.cuda.synchronize()
    log(f"[kernels] adamw: {checked} launches bit-equal to the plain version "
        f"(p, m, v): gemma2-2b's {len(info['shapes'])} leaf shapes and sizes "
        f"{ADAMW_ODD_SIZES}, each with float32 and bfloat16 p, with and "
        f"without clipping, decay 0.1 on matrices ({time.perf_counter() - t0:.1f} s)")

    # one step's leaves, float32 as the train step's
    leaves = [adamw_leaf(torch, gen, s) for s in info["shapes"]]
    ps, gs, ms_, vs = (list(x) for x in zip(*leaves))
    del leaves
    sc, kw = adamw_scalars(torch, True, dict(enumerate(gs)))
    decays = [wd if _is_matrix(p) else 0.0 for p in ps]

    def run():
        for p, g, m, v, d in zip(ps, gs, ms_, vs, decays):
            ops.adamw(p, g, m, v, **sc, **kw, weight_decay=d)

    def plain():
        for p, g, m, v, d in zip(ps, gs, ms_, vs, decays):
            ref.adamw(p, g, m, v, **sc, **kw, weight_decay=d)

    steps = [torch.tensor(7.0, device="cuda") for _ in ps]

    def library():
        torch._fused_adamw_(ps, gs, ms_, vs, [], steps, lr=3e-3,
                            beta1=kw["b1"], beta2=kw["b2"], weight_decay=wd,
                            eps=kw["eps"], amsgrad=False, maximize=False)

    def norms():
        global_norm(dict(enumerate(gs)))
        global_norm(dict(enumerate(ps)))

    n = sum(p.numel() for p in ps)
    before = adamw_mod.launches
    ms = time_ms(run, warmup=1, reps=5)
    launched = adamw_mod.launches - before
    if launched != 6 * len(ps):
        raise AssertionError(f"adamw timing: {launched} launches, expected "
                             f"6 x {len(ps)}")
    plain_ms = time_ms(plain, warmup=1, reps=3)
    lib_ms = time_ms(library, warmup=1, reps=5)
    norm_ms = time_ms(norms, warmup=1, reps=5)
    nbytes = sum(adamw_mod.hbm_bytes(p.numel(), 4) for p in ps)
    flops = sum(adamw_mod.flops(p.numel(), True, d != 0.0)
                for p, d in zip(ps, decays))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32_CORES * 1e3
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    log(f"[kernels] adamw gemma2-2b one step: {len(ps)} leaves, {n} float32 "
        f"params, one launch a leaf: ms={ms} plain_ms={plain_ms} "
        f"bound_ms={bound_ms} ({bound_by}: {nbytes} bytes at "
        f"{PEAK_BYTES / 1e12} TB/s; {flops} float32 operations at "
        f"{PEAK_FP32_CORES / 1e12:.0f} TFLOP/s = {t_ops} ms) "
        f"library_ms={lib_ms} (torch._fused_adamw_ over the same leaves); "
        f"achieved {nbytes / (ms / 1e3) / 1e12:.3f} TB/s, "
        f"{bound_ms / ms:.3f} of the bound; the step's two global norms "
        f"(grads, params) {norm_ms} ms; {card}")
    del ps, gs, ms_, vs, steps
    torch.cuda.empty_cache()
    # every check above is bit-equal, or it raised
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


def train_restart(torch) -> tuple[dict, dict]:
    """mamba2-130m at its published config, bf16 compute, ``accum``
    microbatches and int8 gradient compression, checkpointing every
    ``ckpt every`` steps: a run preempted by ``FaultInjector`` and resumed
    with ``resume="must"`` (the data fast-forwarded) must give the
    uninterrupted run's metrics and final state bit for bit, under
    ``torch.use_deterministic_algorithms``. The final checkpoint is then
    served: a 1024-token prefill through the kernels, each SSD call held
    against the float32 plain version (BF16_REL_L2) and the logits against
    the float32 torch forward (within twice the bf16 torch forward's
    error). Returns the prefill's launches, and what phase 11 resumes from
    and holds its run to: the checkpoint directory (its ``TemporaryDirectory``;
    phase 11 cleans it up), the uninterrupted run's metrics, the prompt and
    the prefill's logits."""
    import tempfile
    import warnings
    from repro_torch import graphs
    from repro_torch.configs import get_config
    from repro_torch.convert import to_compute_dtype
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import (CheckpointManager, CompressionConfig,
                                         FaultInjector, SimulatedPreemption)
    from repro_torch.models import LM
    from repro_torch.models import model as M
    from repro_torch.training import OptimConfig, TrainConfig, Trainer

    arch, seq, batch, accum, steps, fail_at, every = TRAIN_RESTART
    cfg = get_config(arch)
    tcfg = TrainConfig(optim=OptimConfig(learning_rate=3e-3,
                                         warmup_steps=steps // 10,
                                         total_steps=steps),
                       accum=accum, compression=CompressionConfig())
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=batch, seed=1)

    def trainer(ckpt, it, fail=None):
        return Trainer(cfg=cfg, tcfg=tcfg, data=it, ckpt_dir=ckpt,
                       ckpt_every=every, log_every=1000,
                       fault_injector=FaultInjector(fail) if fail else None,
                       device="cuda")

    tmp = tempfile.TemporaryDirectory()
    ckpt = tmp.name
    t0 = time.perf_counter()
    leaves = n_leaves(M.param_spec(cfg))
    # AdamW launches: the uninterrupted run's steps, the preempted run's
    # fail_at steps and the resumed run's
    adamw = (steps + fail_at + steps - fail_at // every * every) * leaves
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, \
                train_launches(f"{arch} training", adamw=adamw):
            warnings.simplefilter("always")
            ref = trainer(None, iter(data))
            ref.init_or_resume(resume="never")
            ref_hist = ref.run(steps)
            first = trainer(ckpt, iter(data), fail=(fail_at,))
            first.init_or_resume(resume="never")
            try:
                first.run(steps)
                raise AssertionError(f"{arch}: no preemption at step "
                                     f"{fail_at}")
            except SimulatedPreemption:
                pass
            resumed = trainer(ckpt, None)
            resumed.init_or_resume(resume="must")
            start = resumed.step
            if start != fail_at // every * every:
                raise AssertionError(f"{arch}: resumed at step {start}")
            resumed.data = iter(data.batch(s) for s in range(start, steps))
            hist = resumed.run(steps)
    finally:
        torch.use_deterministic_algorithms(False)
    graphed = [len(t._step_fn.graphs) for t in (ref, first, resumed)]
    if graphed != [1, 1, 1]:
        raise AssertionError(f"{arch}: graphs captured by the uninterrupted, "
                             f"preempted and resumed runs {graphed}, "
                             f"expected one each")
    nondet = sorted({str(w.message) for w in caught
                     if "deterministic" in str(w.message)})
    want = ref_hist[start:]
    if nondet:
        # an op without a deterministic kernel: held at a tolerance instead
        log(f"[train] {arch}: ops without a deterministic kernel: {nondet}; "
            f"the trajectories are held at rtol 1e-5 instead of exactly")
        for g, w in zip(hist, want):
            for k in w:
                if not math.isclose(g[k], w[k], rel_tol=1e-5, abs_tol=1e-7):
                    raise AssertionError(f"{arch} step {w['step']} {k}: "
                                         f"resumed {g[k]}, uninterrupted {w[k]}")
    else:
        if hist != want:
            raise AssertionError(f"{arch}: resumed metrics {hist}, "
                                 f"uninterrupted {want}")
        for (n, a), (_, b) in zip(flat_tree(resumed.state),
                                  flat_tree(ref.state)):
            if not torch.equal(a, b):
                raise AssertionError(f"{arch}: resumed state {n} differs")
    log(f"[train] {arch} (published config, bf16 compute) batch {batch} x "
        f"{seq}, accum {accum}, int8 compression, checkpoint every {every}, "
        f"through the graphed Trainer (each run's steps after its first "
        f"{graphs.WARMUP_CALLS} replayed; the resumed run captured its own "
        f"graph over the restored state): "
        f"preempted at step {fail_at}, resumed from {start}; losses of steps "
        f"{start + 1}-{steps} resumed {[m['loss'] for m in hist]}, "
        f"uninterrupted {[m['loss'] for m in want]}: "
        f"{'equal bit for bit, final state too' if not nondet else 'within rtol 1e-5'}"
        f" ({time.perf_counter() - t0:.1f} s)")
    del ref, first, resumed
    torch.cuda.empty_cache()

    step, state, _ = CheckpointManager(ckpt).restore(device="cuda")
    if step != steps:
        raise AssertionError(f"{arch}: last checkpoint at step {step}")
    lm = LM(cfg, to_compute_dtype(state["params"], M.compute_dtype(cfg)),
            device="cuda")
    p32 = state["params"]
    del state
    gen = torch.Generator(device="cuda").manual_seed(13)
    prompt = 1024
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen,
                           device="cuda", dtype=torch.int32)
    with torch.inference_mode():
        cache = lm.init_cache(1, prompt)
        reset_kernel_counters()
        with tap_kernels() as calls:
            logits, _ = lm.prefill(tokens, cache)
        launches = kernel_counts()
        check_taps(f"{arch} restored from step {step}, prefill of {prompt}",
                   calls, expected_calls(torch, M, cfg, prompt), "train")
        want_l = dict.fromkeys(launches, 0) | {"ssd": cfg.num_layers,
                                               "mamba_front": cfg.num_layers}
        if launches != want_l:
            raise AssertionError(f"{arch} prefill: launches {launches}, "
                                 f"expected {want_l}")
        want = M.forward(p32, dataclasses.replace(cfg, dtype="float32"),
                         tokens, "torch", "torch")[0]
        kern = rel_l2(logits, want)
        plain = rel_l2(M.forward(lm.params, cfg, tokens, "torch", "torch")[0],
                       want)
    gate = 2 * plain
    log(f"[train] {arch} restored, prefill of {prompt} through the kernels: "
        f"relative L2 err of the logits against the float32 torch forward "
        f"{kern}, the bf16 torch forward's {plain} (gate {gate}); launches "
        f"{launches}")
    if not kern <= gate:
        raise AssertionError(f"{arch}: restored prefill off by {kern}, above "
                             f"{gate}")
    handoff = dict(tmp=tmp, ref_hist=ref_hist, tokens=tokens,
                   logits=logits.cpu(), nondet=nondet)
    del lm, p32, cache, logits, want
    torch.cuda.empty_cache()
    return launches, handoff


def train_phase(torch, card: str) -> tuple[dict, float, dict, dict]:
    """Returns the restored prefill's launches, gemma2-2b's median graphed
    step ms, ``train_restart``'s hand-off to phase 11 and the AdamW
    kernel's numbers for the ``kernels`` line."""
    torch.cuda.empty_cache()
    check_train_smoke(torch)
    train_graphed_bitwise(torch, card)
    train_remat(torch, card)
    step_ms, info = train_full_width(torch, card)
    adamw = check_adamw(torch, info, card)
    launches, handoff = train_restart(torch)
    return launches, step_ms, handoff, adamw

# ---------------------------------------------------------------------------
# phase 11: the device mesh and the dry-run
# ---------------------------------------------------------------------------

#: phase 11's mesh train run: phase 10's gemma2-2b run, the same optimizer
#: schedule, cut to its first steps (two warm-up steps, the capture, two
#: replays)
MESH_TRAIN_STEPS = 5
#: the captured NCCL all_reduce: (floats, replays on new data, replays in
#: the profiled window: late in the script the profiler drops the first
#: kernels of a window, and one replay's one kernel showed no record)
MESH_NCCL = (1 << 20, 3, 20)
#: the smoke-width step whose state is placed Shard by hand: (arch, steps)
MESH_BY_HAND = ("qwen3-moe-235b-a22b", 4)


class deterministic:
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` inside
    (phase 10's setting); ``.nondet`` lists the ops that warned of having no
    deterministic kernel."""

    def __enter__(self):
        import warnings
        import torch
        self._torch = torch
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        self._torch.use_deterministic_algorithms(False)
        self._catch.__exit__(*exc)
        self.nondet = sorted({str(w.message) for w in self._caught
                              if "deterministic" in str(w.message)})
        return False


def state_nbytes(tree) -> int:
    """Bytes of every leaf of a state tree on this rank (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor
    return sum((x.to_local() if isinstance(x, DTensor) else x).nbytes
               for _, x in flat_tree(tree))


def mesh_train(torch, card: str, mesh, phase10_ms: float) -> None:
    """gemma2-2b at phase 10's config through ``Trainer(mesh=..., rules=
    rules_for(...))`` on the one-device mesh, which graphs its step
    (``GraphedTrainStep`` on DTensors: steps 1-2 eager warm-up steps, step 3
    captured and replayed, 4-5 replays): its losses, metrics and final
    params equal, bit for bit, a mesh-less ``Trainer``'s (graphed too) and
    an eager mesh run's (the Trainer's step function unwrapped) of the same
    seed over the same steps under phase 10's deterministic settings (each
    run's params kept on the host, the run freed before the next). Prints
    the replays' ms beside the mesh-less replays', the graph's pool and the
    launches the replays added. Then the two ties to the dry-run at this
    mesh: its argument bytes against the Trainer's state and batch on the
    card, and its counted FLOPs against ``FlopCounterMode``'s count of one
    more step, run eagerly (``GraphedTrainStep.eager``: a replay dispatches
    no op to count)."""
    import statistics
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import graphs
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import model as M
    from repro_torch.training import OptimConfig, TrainConfig, Trainer

    arch, seq, batch, steps10 = TRAIN_FULL_WIDTH
    steps = MESH_TRAIN_STEPS
    warm = graphs.WARMUP_CALLS + 1          # warm-up steps and the capture
    cfg = get_config(arch)
    tcfg = TrainConfig(optim=OptimConfig(learning_rate=3e-3,
                                         warmup_steps=steps10 // 10,
                                         total_steps=steps10))
    cell = ShapeCell(f"train_{seq}", seq, batch, "train")
    rules = rules_for(cfg, mesh, cell)
    n_leaf = n_leaves(M.param_spec(cfg))

    def trainer(m, graphed=True):
        data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch, seed=0)
        t = Trainer(cfg=cfg, tcfg=tcfg, data=iter(data), mesh=m,
                    rules=rules if m is not None else None, log_every=1000,
                    device="cuda")
        if not isinstance(t._step_fn, graphs.GraphedTrainStep):
            raise AssertionError(f"{arch}: Trainer on CUDA (mesh {m}) is "
                                 f"not graphed")
        if not graphed:
            t._step_fn = t._step_fn.eager
        t.init_or_resume(resume="never")
        return t

    def host_params(t):
        return {n: (x.full_tensor() if isinstance(x, DTensor) else x).cpu()
                for n, x in flat_tree(t.state["params"])}

    def held(label, t, hist):
        if hist != want_hist:
            raise AssertionError(f"{arch}: {label} metrics {hist}, "
                                 f"mesh-less {want_hist}")
        for n, x in host_params(t).items():
            if not torch.equal(x, want[n]):
                raise AssertionError(f"{arch}: {label} param {n} differs "
                                     f"from the mesh-less run's")

    torch.cuda.empty_cache()
    with train_launches(f"{arch} mesh-less training", adamw=steps * n_leaf), \
            deterministic() as det0:
        plain = trainer(None)
        want_hist = plain.run(steps)
    plain_ms = [t * 1e3 for t in plain.straggler.times]
    want = host_params(plain)
    del plain
    torch.cuda.empty_cache()
    with train_launches(f"{arch} eager mesh training",
                        adamw=steps * n_leaf), deterministic() as det1:
        tr = trainer(mesh, graphed=False)
        hist = tr.run(steps)
    eager_ms = [t * 1e3 for t in tr.straggler.times]
    if not all(isinstance(x, DTensor) for _, x in flat_tree(tr.state)):
        raise AssertionError(f"{arch}: the mesh Trainer's state is not "
                             f"DTensors")
    held("eager mesh", tr, hist)
    del tr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with train_launches(f"{arch} graphed mesh training",
                        adamw=steps * n_leaf), deterministic() as det2:
        tr = trainer(mesh)
        tr.run(warm)
        before = kernel_counts()
        hist = tr.run(steps)
        after = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    replay_launches = {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}
    if len(tr._step_fn.graphs) != 1 or replay_launches != {
            "adamw": (steps - warm) * n_leaf}:
        raise AssertionError(f"{arch}: {len(tr._step_fn.graphs)} mesh "
                             f"graphs, the replays launched "
                             f"{replay_launches}")
    held("graphed mesh", tr, hist)
    mesh_ms = [t * 1e3 for t in tr.straggler.times]
    pool = graph_pool_bytes(torch, tr._step_fn)
    del want
    replay_ms = statistics.median(mesh_ms[warm:])
    plain_replay_ms = statistics.median(plain_ms[warm:])
    log(f"[mesh] {arch} (published config, bf16 compute) through Trainer on "
        f"the one-device DeviceMesh {tuple(mesh.shape)} "
        f"{mesh.mesh_dim_names}, rules_for the {seq} x {batch} cell, batch "
        f"{batch} x {seq}, {steps} steps under deterministic algorithms: "
        f"the graphed mesh step (steps 1-{graphs.WARMUP_CALLS} eager warm-up, "
        f"step {warm} captured and replayed, then replays) and the eager mesh "
        f"step both equal the mesh-less Trainer's bit for bit, losses "
        f"{[m['loss'] for m in hist]}, every metric and the final params; "
        f"ops without a deterministic kernel: mesh-less {det0.nondet}, eager "
        f"mesh {det1.nondet}, graphed mesh {det2.nondet}; step ms graphed "
        f"mesh {mesh_ms}, eager mesh {eager_ms}, mesh-less graphed (this "
        f"phase) {plain_ms}; replay ms (median of steps {warm + 1}-{steps}) "
        f"mesh {replay_ms} against mesh-less {plain_replay_ms} (ratio "
        f"{replay_ms / plain_replay_ms}), phase 10's median {phase10_ms}; "
        f"graph pool {pool} bytes, graphed mesh run peak memory {peak} "
        f"bytes; the {steps - warm} replays launched {replay_launches}; "
        f"{card}")

    # the Trainer's step, under its config's remat ("none")
    res = D.count_cell(arch, cell, mesh, remat=cfg.remat, verbose=False)
    have = state_nbytes(tr.state)
    batch_bytes = 2 * batch * seq * 4          # tokens and labels, int32
    if res["memory"]["state_bytes"] != have or \
            res["memory"]["argument_bytes"] != have + batch_bytes:
        raise AssertionError(f"{arch}: dry-run argument bytes "
                             f"{res['memory']}, the card's state {have} and "
                             f"batch {batch_bytes}")
    # the graph's pool back to the allocator before an eager step's
    # activations: both would not fit beside the state
    tr._step_fn.graphs.clear()
    torch.cuda.empty_cache()
    with train_launches(f"{arch} counted mesh step", adamw=n_leaf), \
            FlopCounterMode(display=False) as fc:
        tr._step_fn.eager(tr.state, tr._put(next(tr.data)))
    real = fc.get_total_flops()
    if real != res["flops"]:
        raise AssertionError(f"{arch}: dry-run FLOPs {res['flops']}, "
                             f"FlopCounterMode on the card {real}")
    if res["flops_per_dev"] != real or \
            res["collective_bytes_per_dev"]["total"] != 0:
        raise AssertionError(f"{arch}: the dry-run's rank-0 count on the "
                             f"one-device mesh: FLOPs {res['flops_per_dev']} "
                             f"(the card's {real}), collective bytes "
                             f"{res['collective_bytes_per_dev']}")
    log(f"[mesh] {arch}: dry-run at mesh {res['mesh']} vs the card: argument "
        f"bytes {res['memory']['argument_bytes']} = the Trainer's state "
        f"{have} + the batch {batch_bytes}; counted FLOPs of a step "
        f"{res['flops']} (global) and {res['flops_per_dev']} (rank 0 of the "
        f"mesh) = FlopCounterMode's count of an eager step {steps + 1} on "
        f"the card {real}, no collective bytes; model_flops / counted "
        f"(useful_flops_ratio) {res['useful_flops_ratio']}; the dry-run's "
        f"terms compute {res['terms_s']['compute_s'] * 1e3} ms, memory "
        f"{res['terms_s']['memory_s'] * 1e3} ms against replay ms "
        f"{replay_ms}")
    del tr
    torch.cuda.empty_cache()


def nccl_kernels(rows) -> list:
    """The profiled kernels (``kernel_rows``' rows) that are NCCL's."""
    return [r for r in rows if "nccl" in r[2].lower()
            or "onerank" in r[2].lower()]


def mesh_nccl_capture(torch, mesh) -> None:
    """A one-rank NCCL ``all_reduce`` (AVG: over one rank the data itself,
    and a kernel of NCCL's own) made eagerly (the communicator) and then
    captured in a CUDA graph in the train step's ``capture_error_mode``
    "global", with the process group's watchdog running; each of
    ``MESH_NCCL``'s replays on new data gives that data back, and a
    profiled window of replays names their NCCL kernel."""
    import torch.distributed as dist
    n, reps, profiled = MESH_NCCL
    group = mesh.get_group(0)
    x = torch.zeros(n, device="cuda")
    dist.all_reduce(x, op=dist.ReduceOp.AVG, group=group)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(g, stream=side, capture_error_mode="global"):
        dist.all_reduce(x, op=dist.ReduceOp.AVG, group=group)
    torch.cuda.current_stream().wait_stream(side)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(reps):
        new = torch.randn(n, device="cuda", generator=gen)
        x.copy_(new)
        g.replay()
        torch.cuda.synchronize()
        if not torch.equal(x, new):
            raise AssertionError("a replayed NCCL all_reduce did not give "
                                 "its new data back")
    def check(rows):
        if not nccl_kernels(rows):
            raise AssertionError(f"{profiled} profiled replays of the "
                                 f"captured all_reduce ran no NCCL kernel: "
                                 f"{rows}")
        return rows

    def replays():
        for _ in range(profiled):
            g.replay()
    rows = profiled_replay(torch, replays, check, "captured all_reduce")
    log(f"[mesh] a one-rank NCCL all_reduce (AVG) of {n} floats captured in "
        f"a CUDA graph (capture_error_mode global, the watchdog running) and "
        f"replayed {reps} times on new data gives that data back; "
        f"{profiled} profiled replays ran "
        f"{[(c, k[:80]) for _, c, k in rows]}")
    del g, x


def mesh_by_hand(torch, mesh) -> None:
    """A smoke-width float32 step (accum 2, int8 compression) of
    ``MESH_BY_HAND``'s arch whose state is placed ``Shard`` along each
    leaf's last dimension on the size-1 "model" axis by hand (bypassing
    ``placements_for``, which places it ``Replicate()``), its batch
    ``Shard(0)`` on "data": the graphed step (``GraphedTrainStep``) equals
    the eager step bit for bit, metrics and state, over its steps; prints
    how many NCCL kernels one profiled replay launched (DTensor issues no
    collective over a mesh axis of size 1)."""
    import dataclasses
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch import graphs
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import CompressionConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import rules_for
    from repro_torch.training import (OptimConfig, TrainConfig,
                                      build_train_step, init_train_state)

    arch, steps = MESH_BY_HAND
    cfg = dataclasses.replace(smoke_config(arch), vocab_size=128,
                              dtype="float32")
    tcfg = TrainConfig(optim=OptimConfig(learning_rate=1e-2, warmup_steps=2,
                                         total_steps=20),
                       accum=2, compression=CompressionConfig())
    rules = rules_for(cfg, mesh)

    def by_hand(tree):
        if isinstance(tree, dict):
            return {k: by_hand(v) for k, v in tree.items()}
        return [Replicate(),
                Shard(tree.ndim - 1) if tree.ndim >= 2 else Replicate()]

    def state():
        s = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, tcfg, "cuda")
        return shd.distribute_tree(s, mesh, by_hand(s))

    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=4, seed=3)
    batches = [{k: distribute_tensor(torch.from_numpy(v).cuda(), mesh,
                                     [Shard(0), Replicate()])
                for k, v in data.batch(i).items()} for i in range(steps)]
    eager = build_train_step(cfg, tcfg, rules)
    step = graphs.GraphedTrainStep(build_train_step(cfg, tcfg, rules))
    want, got = state(), state()
    rows = None
    with deterministic():
        for i, b in enumerate(batches):
            _, mw = eager(want, b)
            if i == steps - 1:          # a replay, profiled
                rows, (_, mg) = kernel_rows(torch, lambda: step(got, b))
            else:
                _, mg = step(got, b)
            if {k: float(v.full_tensor()) for k, v in mg.items()} != \
                    {k: float(v.full_tensor()) for k, v in mw.items()}:
                raise AssertionError(f"{arch} by hand: step {i + 1}'s "
                                     f"graphed metrics differ from the eager")
    for (n, a), (_, c) in zip(flat_tree(shd.full_tree(got)),
                              flat_tree(shd.full_tree(want))):
        if not torch.equal(a, c):
            raise AssertionError(f"{arch} by hand: graphed state {n} "
                                 f"differs from the eager step's")
    if len(step.graphs) != 1 or steps <= graphs.WARMUP_CALLS + 1:
        raise AssertionError(f"{arch} by hand: {len(step.graphs)} graphs "
                             f"over {steps} steps")
    nccl = nccl_kernels(rows)
    log(f"[mesh] {arch} (smoke width, float32, accum 2, int8 compression), "
        f"its state placed Shard on the size-1 'model' axis by hand: "
        f"{steps} graphed steps ({graphs.WARMUP_CALLS} eager warm-up, a "
        f"capture, replays) equal the eager mesh step bit for bit, metrics "
        f"and state; one profiled replay ran {sum(r[1] for r in rows)} "
        f"kernels, of them {sum(r[1] for r in nccl)} NCCL's "
        f"{[k[:60] for _, _, k in nccl]}")


def mesh_restart(torch, mesh, handoff: dict) -> dict:
    """Phase 10's mamba2-130m run resumed on the mesh: its step-``every``
    checkpoint, written without a mesh, restored onto the mesh through
    ``Trainer(mesh=...)`` (``restore(mesh=..., placements=...)``) and run to
    the end, graphed (two warm-up steps, then a capture over the restored
    local shards), under deterministic algorithms: metrics equal to phase
    10's
    uninterrupted run bit for bit, and the final state to phase 10's final
    checkpoint. The params, gathered with ``full_tensor()``, serve phase 10's
    1024-token prompt through the SSD kernel: logits equal phase 10's
    restored prefill bit for bit. Returns the prefill's launches."""
    import shutil
    import tempfile
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.convert import to_compute_dtype
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import CheckpointManager, CompressionConfig
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import LM
    from repro_torch.models import model as M
    from repro_torch.training import OptimConfig, TrainConfig, Trainer

    arch, seq, batch, accum, steps, fail_at, every = TRAIN_RESTART
    cfg = get_config(arch)
    tcfg = TrainConfig(optim=OptimConfig(learning_rate=3e-3,
                                         warmup_steps=steps // 10,
                                         total_steps=steps),
                       accum=accum, compression=CompressionConfig())
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=batch, seed=1)
    src = handoff["tmp"].name
    start = every
    name = f"step_{start:08d}"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        shutil.copytree(os.path.join(src, name), os.path.join(ckpt, name))
        rules = rules_for(cfg, mesh, ShapeCell(f"train_{seq}", seq, batch,
                                               "train"))
        with train_launches(f"{arch} mesh training",
                            adamw=(steps - start) * n_leaves(
                                M.param_spec(cfg))), \
                deterministic() as det:
            tr = Trainer(cfg=cfg, tcfg=tcfg,
                         data=iter(data.batch(s) for s in range(start, steps)),
                         ckpt_dir=ckpt, ckpt_every=every, mesh=mesh,
                         rules=rules, log_every=1000, device="cuda")
            tr.init_or_resume(resume="must")
            if tr.step != start or not all(
                    isinstance(x, DTensor) for _, x in flat_tree(tr.state)):
                raise AssertionError(f"{arch}: restored at step {tr.step}, "
                                     f"not onto the mesh at {start}")
            hist = tr.run(steps)
    if len(tr._step_fn.graphs) != 1:
        raise AssertionError(f"{arch}: the mesh-resumed run captured "
                             f"{len(tr._step_fn.graphs)} graphs, expected 1")
    want = handoff["ref_hist"][start:]
    if hist != want:
        raise AssertionError(f"{arch}: mesh-resumed metrics {hist}, "
                             f"uninterrupted {want}")
    _, final, _ = CheckpointManager(src).restore(step=steps, device="cuda")
    for (n, a), (_, b) in zip(flat_tree(tr.state), flat_tree(final)):
        if not torch.equal(a.full_tensor(), b):
            raise AssertionError(f"{arch}: mesh-resumed state {n} differs "
                                 f"from phase 10's step-{steps} checkpoint")
    params = M.tree_map(lambda x: x.full_tensor(), tr.state["params"])
    del tr, final
    log(f"[mesh] {arch} (published config, accum {accum}, int8 "
        f"compression): phase 10's step-{start} checkpoint (no mesh) "
        f"restored onto the mesh as DTensors and resumed, graphed (a capture "
        f"over the restored shards), to step {steps}: "
        f"losses {[m['loss'] for m in hist]} equal the uninterrupted run's "
        f"bit for bit, every metric too, and the final state phase 10's "
        f"step-{steps} checkpoint; ops without a deterministic kernel "
        f"{det.nondet} ({time.perf_counter() - t0:.1f} s)")

    lm = LM(cfg, to_compute_dtype(params, M.compute_dtype(cfg)),
            device="cuda")
    tokens = handoff["tokens"]
    with torch.inference_mode():
        cache = lm.init_cache(1, tokens.shape[1])
        reset_kernel_counters()
        logits, _ = lm.prefill(tokens, cache)
        launches = kernel_counts()
    want_l = dict.fromkeys(launches, 0) | {"ssd": cfg.num_layers,
                                           "mamba_front": cfg.num_layers}
    if launches != want_l:
        raise AssertionError(f"{arch} mesh-restored prefill: launches "
                             f"{launches}, expected {want_l}")
    if not torch.equal(logits.cpu(), handoff["logits"]):
        err = (logits.cpu() - handoff["logits"]).abs().max().item()
        raise AssertionError(f"{arch}: the mesh-restored prefill's logits "
                             f"differ from phase 10's (max abs {err})")
    log(f"[mesh] {arch}: the mesh-resumed params, gathered, serve phase 10's "
        f"{tokens.shape[1]}-token prefill through the SSD kernel: logits "
        f"equal phase 10's restored prefill bit for bit; launches {launches}")
    handoff["tmp"].cleanup()
    del lm, params, cache, logits
    torch.cuda.empty_cache()
    return launches


#: a 4-layer cut of gemma2-2b's published width decodes one token on the
#: one-device mesh: (arch, layers, batch, cache rows, write positions)
MESH_DECODE = ("gemma2-2b", 4, 2, 1024, (700, 1023))
#: worker processes of the dry-run (the card's host has 8 cores)
DRYRUN_JOBS = 8


def mesh_decode(torch, mesh) -> None:
    """One ``decode_step`` of gemma2-2b (published width, 4 layers, bf16,
    the torch path: the kernels take no DTensor) on the one-device mesh,
    its inputs placed by ``rules_for``'s table for a decode cell: logits
    and every cache leaf equal bit for bit to the mesh-less step's on the
    same inputs (a cache of random rows, each sequence writing at its own
    position)."""
    import functools
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.convert import to_compute_dtype
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import model as M

    arch, layers, batch, rows, at = MESH_DECODE
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    rules = rules_for(cfg, mesh, ShapeCell("decode", rows, batch, "decode"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = to_compute_dtype(M.init_params(gen, cfg, "cuda"),
                              M.compute_dtype(cfg))
    cache0 = M.tree_map(
        lambda c: torch.randn(c.shape, generator=gen, device="cuda",
                              dtype=torch.float32).to(c.dtype),
        M.init_cache(cfg, batch, rows, device="cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    pos = torch.tensor(at, dtype=torch.int32, device="cuda")

    def step(params, cache, tokens, pos, rules=None):
        return M.decode_step(params, cfg, tokens, cache, pos,
                             attn_impl="torch", moe_impl="einsum",
                             constrain=functools.partial(shd.constrain,
                                                         rules=rules))[0]
    with deterministic(), torch.no_grad():
        reset_kernel_counters()
        want_cache = M.tree_map(torch.clone, cache0)
        want = step(params, want_cache, tokens, pos)
        on = [shd.distribute_tree(M.tree_map(torch.clone, t), mesh,
                                  shd.tree_placements(mesh, axes, rules))
              for t, axes in ((params, M.param_axes(cfg)),
                              (cache0, M.cache_axes(cfg)))]
        tok, p = (distribute_tensor(t, mesh, shd.placements_for(
            mesh, shd.spec_for(lg, rules)))
            for t, lg in ((tokens, ("batch", None)), (pos, ("batch",))))
        got = step(on[0], on[1], tok, p, rules).full_tensor()
        launches = kernel_counts()
    if not torch.equal(got, want):
        err = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{arch}: mesh decode logits differ from the "
                             f"mesh-less step's (max abs {err})")
    for (n, a), (_, b) in zip(flat_tree(shd.full_tree(on[1])),
                              flat_tree(want_cache)):
        if not torch.equal(a, b):
            raise AssertionError(f"{arch}: mesh decode cache {n} differs "
                                 f"from the mesh-less step's")
    if any(launches.values()):
        raise AssertionError(f"{arch} mesh decode launched kernels "
                             f"{launches}")
    log(f"[mesh] {arch} (published width, {layers} layers, bf16) decodes "
        f"one token on the one-device DeviceMesh {tuple(mesh.shape)}, batch "
        f"{batch}, a {rows}-row cache written at {list(at)}: logits "
        f"{tuple(got.shape)} and all {len(flat_tree(want_cache))} cache "
        f"leaves equal the mesh-less step's bit for bit; no kernel launched")
    del params, cache0, want_cache, on
    torch.cuda.empty_cache()


def dryrun_phase() -> None:
    """Every applicable (arch, shape) cell's DTensor step counted as rank 0
    of the (16, 16) and of the (2, 16, 16) mesh, by ``python -m
    repro_torch.launch.dryrun`` in a process of its own (its fake process
    groups cannot sit beside this process's NCCL group), over
    ``DRYRUN_JOBS`` workers: its lines, one a cell and mesh, then the
    seconds it took. Raises unless it exits 0 with all 66 counted."""
    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "dryrun_torch"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--jobs",
         str(DRYRUN_JOBS), "--out", str(out_dir)],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=600)
    seconds = time.perf_counter() - t0
    lines = [ln for ln in run.stdout.splitlines()
             if ln.startswith("[dryrun]") and "SKIP" not in ln]
    for ln in lines:
        log(ln)
    if run.returncode != 0 or "66/66 cells counted OK" not in run.stdout:
        raise AssertionError(f"dry-run exited {run.returncode}: "
                             f"{run.stderr[-3000:]}")
    results = [json.loads(p.read_text()) for p in out_dir.glob("*.json")]
    over = sorted((r["arch"], r["shape"], r["mesh"]) for r in results
                  if r["over_hbm"])
    dominant = collections.Counter(r["dominant"] for r in results)
    remats = collections.Counter(r["remat"] for r in results)
    log(f"[dryrun] 33 cells x 2 meshes counted as rank 0 of each mesh on "
        f"meta tensors in {seconds:.1f} s ({DRYRUN_JOBS} worker processes), "
        f"remat by cell {dict(remats)}; dominant terms {dict(dominant)}; "
        f"arguments plus the step's peak over the card's 80 GB "
        f"({len(over)}): {over or 'none'}")


def mesh_phase(torch, card: str, phase10_ms: float, handoff: dict) -> dict:
    """Phase 11 under an NCCL process group of one rank (a ``HashStore``),
    destroyed before the dry-run. Returns the mesh-restored prefill's
    launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        mesh_train(torch, card, mesh, phase10_ms)
        mesh_nccl_capture(torch, mesh)
        mesh_by_hand(torch, mesh)
        launches = mesh_restart(torch, mesh, handoff)
        mesh_decode(torch, mesh)
    finally:
        dist.destroy_process_group()
    dryrun_phase()
    return launches


# ---------------------------------------------------------------------------
# phase 13: the scheduler's simulator (host code, no CUDA)
# ---------------------------------------------------------------------------


SIM_SYSTEM = "4K_1WS2OS"
SIM_DURATION_S = 4.0
#: the paper's five scenarios (``core.workloads.SCENARIOS``), then the two
#: generative ones of the registry
SIM_EXTRA_SCENARIOS = ("Chat_Assistant", "Voice_Agent")
SIM_BASELINES = ("FCFS", "Veltair", "Planaria")
SIM_FUZZ_SEEDS = range(4)


def sim_fields(r) -> tuple:
    """Every field of a ``SimResult`` a rerun must reproduce."""
    return (r.uxcost, r.dlv_rate, r.norm_energy, r.frames, r.drops, r.aborts,
            r.variant_counts, r.windows, r.acc_utilization,
            r.pipeline_latency_s, dataclasses.asdict(r.stats))


def host_cpu() -> str:
    """The host CPU's model and core count: ``lscpu``'s model name (it names
    ARM cores, which /proc/cpuinfo does not), else the machine type."""
    import platform
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        out = ""
    for line in out.splitlines():
        if line.startswith("Model name:"):
            return (f"{line.split(':', 1)[1].strip()} "
                    f"({platform.machine()}) x {os.cpu_count()}")
    return f"{platform.machine()} x {os.cpu_count()}"


def sim_replayed(core, scenario, scheduler_factory, live, trace, path: Path,
                 what: str, **kw):
    """``trace`` written to ``path`` as JSONL, read back through
    ``load_trace`` and replayed: raises unless the replay's UXCost, frames
    and windows equal the live run's."""
    from repro_torch.scenarios import load_trace, save_trace
    save_trace(trace, str(path))
    rep = core.Simulator(scenario, SIM_SYSTEM, scheduler_factory(),
                         replay=load_trace(str(path)), **kw).run()
    if (rep.uxcost, rep.frames, rep.windows) != (live.uxcost, live.frames,
                                                  live.windows):
        raise AssertionError(f"{what}: the replay of its trace differs "
                             f"(UXCost {rep.uxcost} vs {live.uxcost}, frames "
                             f"{rep.frames} vs {live.frames})")
    return rep


def sim_phase(card: str) -> None:
    """The port's simulator as the three examples drive the JAX package's:
    the seven scenarios under the three baselines and DREAM-Full, each run
    twice, the simulated ones recorded and replayed, DREAM-Full under the
    scalar engine beside the vectorised one, the supernet's subnet choice,
    and the fuzzed record and replay. Catches nothing; launches nothing."""
    from repro_torch import core
    from repro_torch.core.baselines import FCFSScheduler, VeltairLikeScheduler
    from repro_torch.scenarios import fuzz_phase_script, fuzz_scenario
    t0 = time.perf_counter()
    out = ROOT / "build" / "sim_traces"
    out.mkdir(parents=True, exist_ok=True)
    tag = (f"analytic model of the paper's sub-accelerators, run on the host "
           f"({host_cpu()}), not measured on the card")
    factories = {"FCFS": FCFSScheduler, "Veltair": VeltairLikeScheduler,
                 "DREAM-Full": core.dream_full}
    paper = tuple(core.SCENARIOS)
    ratios = {b: [] for b in SIM_BASELINES}
    log(f"[sim] {SIM_SYSTEM}, {SIM_DURATION_S} s simulated, seed 0, cascade "
        f"0.5; UXCost, DLV, energy, frames, drops are outputs of the {tag}")
    for name in paper + SIM_EXTRA_SCENARIOS:
        scn = core.build_scenario(name, 0.5)
        res = {}
        for sched in SIM_BASELINES[:2] + ("Planaria", "DREAM-Full"):
            what = f"{name} {sched}"
            if sched == "Planaria":
                runs = [core.run_planaria(scn, SIM_SYSTEM,
                                          duration_s=SIM_DURATION_S)
                        for _ in range(2)]
            else:
                sim = core.Simulator(scn, SIM_SYSTEM, factories[sched](),
                                     duration_s=SIM_DURATION_S, record=True)
                runs = [sim.run(), core.run_sim(
                    scn, SIM_SYSTEM, factories[sched],
                    duration_s=SIM_DURATION_S)]
                sim_replayed(core, scn, factories[sched], runs[0], sim.trace,
                             out / f"{name}_{sched}.jsonl", what,
                             duration_s=SIM_DURATION_S)
            if sim_fields(runs[0]) != sim_fields(runs[1]):
                raise AssertionError(f"{what}: two runs of seed 0 differ")
            r = res[sched] = runs[0]
            log(f"[sim] {name:>14s} {sched:>10s} UXCost={r.uxcost} "
                f"DLV={r.dlv_rate} energy={r.norm_energy} frames={r.frames} "
                f"drops={r.drops}")
        scalar = core.run_sim(scn, SIM_SYSTEM, core.dream_full,
                              duration_s=SIM_DURATION_S, engine="scalar")
        soa = core.run_sim(scn, SIM_SYSTEM, core.dream_full,
                           duration_s=SIM_DURATION_S, engine="soa")
        if sim_fields(scalar) != sim_fields(soa) or sim_fields(soa) != \
                sim_fields(res["DREAM-Full"]):
            raise AssertionError(f"{name}: DREAM-Full under "
                                 f"EngineConfig('scalar') differs from 'soa'")
        rel = {b: res["DREAM-Full"].uxcost / res[b].uxcost
               for b in SIM_BASELINES}
        if name in paper:
            for b in SIM_BASELINES:
                ratios[b].append(rel[b])
        log(f"[sim] {name:>14s} DREAM-Full UXCost relative to " + ", ".join(
            f"{b} {100 * (x - 1):+.2f}%" for b, x in rel.items())
            + "; scalar and soa engines equal on every field, the recorded "
            "runs replayed from JSONL to the same UXCost, frames and windows")
    log("[sim] geomean of DREAM-Full's UXCost over the paper's five "
        "scenarios, relative to " + ", ".join(
            f"{b} {100 * (math.exp(statistics.fmean(map(math.log, x))) - 1):+.2f}%"
            for b, x in ratios.items()) + f" ({tag})")

    for prob in (0.5, 0.99):
        scn = core.build_scenario("AR_Social", prob)
        with_sw = core.run_sim(scn, SIM_SYSTEM, core.dream_full, duration_s=6.0)
        without = core.run_sim(scn, SIM_SYSTEM, core.dream_smartdrop,
                               duration_s=6.0)
        counts = {k: v for k, v in sorted(with_sw.variant_counts.items())
                  if k.startswith("ctx_ofa")}
        total = sum(counts.values())
        log(f"[sim] supernet, AR_Social at cascade {prob}, 6 s: UXCost with "
            f"switching {with_sw.uxcost} (DLV {with_sw.dlv_rate}), without "
            f"{without.uxcost} (DLV {without.dlv_rate}); subnets "
            + (", ".join(f"{k.split('@')[1] if '@' in k else 'original'} "
                         f"{100 * v / total:.1f}%" for k, v in counts.items())
               or "none switched"))

    for seed in SIM_FUZZ_SEEDS:
        builder = fuzz_scenario(seed)
        script = fuzz_phase_script(seed, builder, duration_s=SIM_DURATION_S)
        sim = core.Simulator(builder.build(), SIM_SYSTEM, core.dream_full(),
                             duration_s=SIM_DURATION_S, seed=seed,
                             phase_script=script, record=True)
        live = sim.run()
        rep = sim_replayed(core, builder.build(), core.dream_full, live,
                           sim.trace, out / f"fuzz_{seed}.jsonl",
                           f"fuzzed seed {seed}", duration_s=SIM_DURATION_S,
                           seed=seed)
        if rep.uxcost != live.uxcost:
            raise AssertionError(f"fuzzed seed {seed}: replay diverged")
        log(f"[sim] fuzzed seed {seed}: {len(builder.entries)} streams, "
            f"phase shift {script.to_config()[0]['action']['kind']} at "
            f"t={script.events[0][0]} s, {len(sim.trace.events)} trace "
            f"events; DREAM-Full UXCost {live.uxcost} frames {live.frames}, "
            f"replayed from JSONL bit-identical")
    log(f"[sim] phase 13 took {time.perf_counter() - t0:.2f} s of host time "
        f"on {host_cpu()} (card {card}, unused)")


# ---------------------------------------------------------------------------
# phase 14: the fleet simulator (host code, no CUDA)
# ---------------------------------------------------------------------------

#: ``benchmarks/fleet_sweep.py``'s node mix, population scale and sizes
FLEET_SYSTEMS_MIX = ("4K_2WS", "8K_2OS", "4K_1WS2OS", "8K_1OS2WS",
                     "8K_2WS", "4K_2OS", "8K_1WS2OS", "4K_1OS2WS")
FLEET_FPS_SCALE = 0.25
FLEET_HEADLINE = dict(seed=0, n_nodes=16, n_streams=200, duration_s=2.5)
FLEET_POLICIES = ("round_robin", "least_loaded", "score")
CASCADE_SYSTEMS = ("4K_2WS", "8K_2OS", "4K_2OS", "8K_2WS",
                   "8K_2WS", "4K_2OS", "8K_2OS", "4K_2WS")
#: ``fleet_sweep.run``'s cascade arm at the headline's defaults:
#: max(16 // 2, 8) nodes, max(200 // 16, 10) streams, seeds 0-2
CASCADE_ARM = dict(n_nodes=8, n_streams=12, duration_s=2.5, n_seeds=3)
SCALE_ARM = dict(seed=0, n_nodes=256, n_streams=10_000, duration_s=0.6,
                 fps_scale=0.08)
#: ``tests/test_vectorized_equiv.py``'s split shape, at the seed where the
#: JAX package's scan fleet clock reads stale telemetry
SPLIT_SEED = 38014
GOLDEN_UXCOST_RTOL = 1e-12


def build_fleet(cl, seed: int, n_nodes: int, n_streams: int,
                duration_s: float):
    """``fleet_sweep.build_fleet`` with churn: a node joins at 0.4 of the
    run and the first drains at 0.5."""
    b = cl.FleetScenarioBuilder(f"fleet_sweep_{seed}")
    nids = [b.node(FLEET_SYSTEMS_MIX[i % len(FLEET_SYSTEMS_MIX)])
            for i in range(n_nodes)]
    b.node(FLEET_SYSTEMS_MIX[n_nodes % len(FLEET_SYSTEMS_MIX)],
           at=round(0.4 * duration_s, 6))
    b.node_drain(nids[0], at=round(0.5 * duration_s, 6))
    b.fuzz_streams(cl.FuzzSpec(n_streams=n_streams, seed=seed, t0=0.0,
                               t1=round(0.5 * duration_s, 6),
                               fps_scale=FLEET_FPS_SCALE))
    return b.build()


def build_cascade_fleet(cl, seed: int, n_nodes: int, n_streams: int,
                        duration_s: float):
    """``fleet_sweep.build_cascade_fleet`` with churn: heavy 2-3 stage
    cascades at full FPS on a dataflow-polarised pool, one drain."""
    b = cl.FleetScenarioBuilder(f"cascade_sweep_{seed}")
    nids = [b.node(CASCADE_SYSTEMS[i % len(CASCADE_SYSTEMS)])
            for i in range(n_nodes)]
    b.node_drain(nids[0], at=round(0.5 * duration_s, 6))
    b.fuzz_streams(cl.FuzzSpec(
        n_streams=n_streams, seed=seed, t0=0.0,
        t1=round(0.5 * duration_s, 6), fps_scale=1.0,
        deterministic_arrivals=True,
        cascade=cl.CascadeFuzz(prob=1.0, max_depth=3, only=True)))
    return b.build()


def build_scale_fleet(cl, seed: int, n_nodes: int, n_streams: int,
                      duration_s: float, fps_scale: float):
    """``fleet_sweep.build_scale_fleet``: one drain at mid-run."""
    b = cl.FleetScenarioBuilder(f"scale_sweep_{seed}")
    nids = [b.node(FLEET_SYSTEMS_MIX[i % len(FLEET_SYSTEMS_MIX)])
            for i in range(n_nodes)]
    b.node_drain(nids[0], at=round(0.5 * duration_s, 6))
    b.fuzz_streams(cl.FuzzSpec(n_streams=n_streams, seed=seed, t0=0.0,
                               t1=round(0.6 * duration_s, 6),
                               fps_scale=fps_scale))
    return b.build()


def build_split_fleet(cl, seed: int, duration_s: float = 1.0):
    """``test_vectorized_equiv.build_scenario("split", seed)``: 4 nodes,
    8 deterministic cascades, every stage routed on its own."""
    b = cl.FleetScenarioBuilder(f"equiv_split_{seed}")
    for i in range(4):
        b.node(FLEET_SYSTEMS_MIX[i])
    b.fuzz_streams(cl.FuzzSpec(
        n_streams=8, seed=seed, t0=0.0, t1=round(0.5 * duration_s, 6),
        fps_scale=1.0, deterministic_arrivals=True,
        cascade=cl.CascadeFuzz(prob=1.0, max_depth=3, only=True)))
    return b.build()


def fleet_fields(fs, r) -> dict:
    """Every field of a ``FleetResult`` (the trace as its bytes) and the
    final placements."""
    from repro_torch.cluster import dumps
    out = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
           if f.name != "trace"}
    out["trace"] = None if r.trace is None else dumps(r.trace)
    out["stream_node"] = dict(fs.stream_node)
    out["stage_node"] = dict(fs.stage_node)
    return out


def golden_digest(r, fs) -> str:
    """``tests/golden/regen.py``'s digest of a replayed result."""
    import hashlib
    payload = {
        "uxcost": repr(r.uxcost), "frames": r.frames,
        "dlv_rate": repr(r.dlv_rate), "norm_energy": repr(r.norm_energy),
        "stream_seconds": repr(r.stream_seconds),
        "pipeline_latency_s": repr(r.pipeline_latency_s),
        "pipe_frames": r.pipe_frames, "migrations": r.migrations,
        "departures": r.departures, "jobs_purged": r.jobs_purged,
        "swaps": r.swaps, "rejections": r.rejections,
        "tier_dlv": {str(k): repr(v) for k, v in sorted(r.tier_dlv.items())},
        "weights": ([repr(w) for w in r.weights]
                    if r.weights is not None else None),
        "stream_node": {str(k): v for k, v in sorted(fs.stream_node.items())},
        "stage_node": {f"{k[0]}:{k[1]}": v
                       for k, v in sorted(fs.stage_node.items())},
    }
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()
                          ).hexdigest()


def fleet_sim_phase(card: str) -> None:
    """The port's fleet simulator at ``benchmarks/fleet_sweep.py``'s sizes:
    the headline fleet under three policies (the score run recorded and
    replayed), the cascade fleet whole-pipeline against stage-split, the
    scale arm, the seven golden traces replayed twice, and split seed
    38014 under the vectorised and the scalar engine. Catches nothing;
    launches nothing."""
    from repro_torch import cluster as cl
    from repro_torch.core.engine import EngineConfig
    t0 = time.perf_counter()
    tag = (f"host seconds of the analytic model on {host_cpu()}, not the "
           f"card")
    log(f"[fleetsim] UXCost, DLV, energy, frames and migrations are outputs "
        f"of the analytic model of the paper's sub-accelerators; wall and "
        f"stream-seconds per wall second are {tag}")

    def fleet_run(label: str, *args, **kw):
        """One fleet run, timed on the host clock and printed with its
        rate."""
        fs = cl.FleetSimulator(*args, **kw)
        w0 = time.perf_counter()
        r = fs.run()
        wall = time.perf_counter() - w0
        log(f"[fleetsim] {label}: UXCost={r.uxcost} DLV={r.dlv_rate} "
            f"energy={r.norm_energy} frames={r.frames} "
            f"migrations={r.migrations} wall={wall:.4f} s "
            f"stream_s={r.stream_seconds} stream_s_per_wall_s="
            f"{r.stream_seconds / max(wall, 1e-9):.1f} ({tag})")
        return fs, r

    # 1. the headline fleet
    h = FLEET_HEADLINE
    fscn = build_fleet(cl, **h)
    res = {}
    for policy in FLEET_POLICIES:
        fs, r = fleet_run(
            f"headline {h['n_nodes']}+1 nodes, {h['n_streams']} streams, "
            f"{h['duration_s']} s, {policy}", fscn, policy,
            duration_s=h["duration_s"], seed=h["seed"],
            record=(policy == "score"))
        res[policy] = (fs, r)
    fs, r = res["score"]
    rfs, rep = fleet_run("headline score, replayed",
                         replay=cl.loads(cl.dumps(r.trace)))
    live_view = (r.uxcost, r.frames, r.pipeline_latency_s,
                 dict(fs.stream_node), dict(fs.stage_node))
    rep_view = (rep.uxcost, rep.frames, rep.pipeline_latency_s,
                dict(rfs.stream_node), dict(rfs.stage_node))
    if rep_view != live_view:
        raise AssertionError("headline score run: its replay differs "
                             f"(UXCost {rep.uxcost} vs {r.uxcost}, frames "
                             f"{rep.frames} vs {r.frames})")
    rr_over_score = res["round_robin"][1].uxcost / r.uxcost
    if not rr_over_score > 1.0:
        raise AssertionError(f"UXCost(round_robin)/UXCost(score) = "
                             f"{rr_over_score}, not above 1")
    log(f"[fleetsim] headline: UXCost(round_robin)/UXCost(score) = "
        f"{rr_over_score}; UXCost(least_loaded)/UXCost(score) = "
        f"{res['least_loaded'][1].uxcost / r.uxcost}; the score run's "
        f"replay equals it in UXCost, frames, pipeline latency and the "
        f"final placements")

    # 2. the cascade fleet, whole pipeline against stage split
    c = CASCADE_ARM
    transfer = cl.TransferModel()
    totals = {"whole": 0.0, "split": 0.0}
    for seed in range(c["n_seeds"]):
        cscn = build_cascade_fleet(cl, seed, c["n_nodes"], c["n_streams"],
                                   c["duration_s"])
        label = (f"cascade {c['n_nodes']} nodes, {c['n_streams']} streams, "
                 f"{c['duration_s']} s, seed {seed}")
        _, whole = fleet_run(f"{label}, score_whole", cscn, "score_whole",
                             duration_s=c["duration_s"], seed=seed,
                             transfer=transfer, split_stages=True)
        sfs, split = fleet_run(f"{label}, score split", cscn, "score",
                               duration_s=c["duration_s"], seed=seed,
                               transfer=transfer, split_stages=True,
                               record=True)
        _, srep = fleet_run(f"{label}, split replayed",
                            replay=cl.loads(cl.dumps(split.trace)))
        if (srep.uxcost, srep.frames, srep.xfer_energy_j) != (
                split.uxcost, split.frames, split.xfer_energy_j):
            raise AssertionError(f"{label}: the split run's replay differs")
        n_split = sum(1 for sid, sv in sfs.streams.items()
                      if len({sfs.stage_node[(sid, k)]
                              for k in range(sv.n_stages)}) > 1)
        log(f"[fleetsim] {label}: UXCost(whole)/UXCost(split) = "
            f"{whole.uxcost / split.uxcost}; {n_split} streams split across "
            f"nodes, {split.trigger_transfers} cross-node triggers")
        totals["whole"] += whole.uxcost
        totals["split"] += split.uxcost
    if not totals["split"] <= totals["whole"]:
        raise AssertionError(f"stage-split UXCost {totals['split']} is worse "
                             f"than whole-pipeline {totals['whole']}")
    log(f"[fleetsim] cascade: summed over {c['n_seeds']} seeds, "
        f"UXCost(whole)/UXCost(split) = {totals['whole'] / totals['split']}")

    # 3. the scale arm
    sc = SCALE_ARM
    sscn = build_scale_fleet(cl, **sc)
    _, big = fleet_run(
        f"scale {sc['n_nodes']} nodes, {sc['n_streams']} streams, "
        f"{sc['duration_s']} s, score", sscn, "score",
        duration_s=sc["duration_s"], seed=sc["seed"],
        rebalance_every_s=10.0 * sc["duration_s"])
    if big.frames <= 0:
        raise AssertionError("the scale arm served no frames")

    # 4. the golden traces
    golden = ROOT / "tests" / "golden"
    manifest = json.loads((golden / "manifest.json").read_text())
    for name, entry in sorted(manifest.items()):
        text = (golden / f"{name}.trace.json").read_text()
        runs = [fleet_run(f"golden {name}, replay {i + 1}",
                          replay=cl.loads(text)) for i in range(2)]
        (fs1, r1), (fs2, r2) = runs
        if fleet_fields(fs1, r1) != fleet_fields(fs2, r2):
            raise AssertionError(f"golden {name}: two replays differ")
        rel = abs(r1.uxcost - entry["uxcost"]) / abs(entry["uxcost"])
        if r1.frames != entry["frames"] or rel > GOLDEN_UXCOST_RTOL:
            raise AssertionError(
                f"golden {name}: frames {r1.frames} (manifest "
                f"{entry['frames']}), UXCost {r1.uxcost} (manifest "
                f"{entry['uxcost']}, relative {rel})")
        log(f"[fleetsim] golden {name}: frames equal the manifest's, UXCost "
            f"within {rel} of it, two replays equal; digest "
            + ("equals the manifest's" if golden_digest(r1, fs1)
               == entry["result_sha256"] else "differs from the manifest's "
               "(not gated: the digests drift under the installed numpy)"))

    # 5. split seed 38014, vectorised against scalar
    views = {}
    for engine in ("soa", "scalar"):
        fs, r = fleet_run(
            f"split seed {SPLIT_SEED}, 4 nodes, 8 cascades, 1.0 s, "
            f"EngineConfig({engine!r})", build_split_fleet(cl, SPLIT_SEED),
            "score", duration_s=1.0, seed=SPLIT_SEED, record=True,
            split_stages=True, transfer=cl.TransferModel(),
            engine=EngineConfig(engine))
        views[engine] = fleet_fields(fs, r)
    if views["soa"] != views["scalar"]:
        diff = sorted(k for k in views["soa"]
                      if views["soa"][k] != views["scalar"][k])
        raise AssertionError(f"split seed {SPLIT_SEED}: the scalar engine "
                             f"differs from soa in {diff}")
    log(f"[fleetsim] split seed {SPLIT_SEED}: scalar and soa engines equal "
        f"in every field and the trace bytes ({views['soa']['frames']} "
        f"frames)")
    log(f"[fleetsim] phase 14 took {time.perf_counter() - t0:.2f} s of host "
        f"time on {host_cpu()} (card {card}, unused)")


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
    t_start = time.perf_counter()
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
    ptxas_report(build.build_log(), ("gmm_", "ssd_", "flash_wgmma_kernel",
                                     "decode_", "adamw_", "mamba_front_"))

    # 3. kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash = check_flash(torch, gen)
    ssd = check_ssd(torch, gen)
    front = check_mamba_front(torch, gen)

    # 4. model: card against CPU
    check_models(torch)

    # 5. serving (and 6. its profile)
    launches, served_handles = serve(torch)

    # 12. the fleet, on phase 5's handles
    t_fleet = time.perf_counter()
    fleet_launches = fleet_phase(torch, served_handles, card)
    del served_handles
    torch.cuda.empty_cache()
    log(f"[time] phase 12 (fleet) {time.perf_counter() - t_fleet:.1f} s")

    # 7. decode
    dec_headline, dec_launches = decode(torch, gen)

    # 8. MoE
    t_moe = time.perf_counter()
    gmm_headline, moe_launches = moe_phase(torch, gen)

    # 9. the remaining architectures at full width
    t_archs = time.perf_counter()
    arch_launches = archs_phase(torch, gen)

    # 10. training
    t_train = time.perf_counter()
    train_prefill, train_ms, handoff, adamw = train_phase(torch, card)

    # 11. the device mesh and the dry-run
    t_mesh = time.perf_counter()
    mesh_launches = mesh_phase(torch, card, train_ms, handoff)

    # 13. the scheduler's simulator, on the host
    t_sim = time.perf_counter()
    sim_phase(card)

    # 14. the fleet simulator, on the host
    t_fleetsim = time.perf_counter()
    fleet_sim_phase(card)
    log(f"[time] phases 1-7 {t_moe - t_start:.1f} s, phase 8 (MoE) "
        f"{t_archs - t_moe:.1f} s, phase 9 (archs) "
        f"{t_train - t_archs:.1f} s, phase 10 (training) "
        f"{t_mesh - t_train:.1f} s, phase 11 (mesh and dry-run) "
        f"{t_sim - t_mesh:.1f} s, phase 13 (simulator) "
        f"{t_fleetsim - t_sim:.1f} s, phase 14 (fleet simulator) "
        f"{time.perf_counter() - t_fleetsim:.1f} s")
    log(f"[launches] serving {launches}, fleet {fleet_launches}, decode "
        f"{dec_launches}, MoE "
        f"{moe_launches}, archs {arch_launches}, training {train_prefill}, "
        f"mesh {mesh_launches}, AdamW in the train runs of phases 10-11 "
        f"{train_launches.adamw_total}")
    launches = sum_launches([{"launches": launches},
                             {"launches": fleet_launches},
                             {"launches": dec_launches},
                             {"launches": moe_launches},
                             {"launches": arch_launches},
                             {"launches": train_prefill},
                             {"launches": mesh_launches},
                             {"launches": {"adamw":
                                           train_launches.adamw_total}}])

    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:149",
             launches=launches["flash_attention"], **flash),
        dict(name="ssd", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd.py:114",
             launches=launches["ssd"], **ssd),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:128",
             launches=launches["decode_attention"], **dec_headline),
        dict(name="gmm", route="cuda",
             source="src/repro_torch/kernels/csrc/gmm.cu",
             replaces="src/repro/kernels/gmm.py:70",
             launches=launches["gmm"], **gmm_headline),
        dict(name="adamw", route="cuda",
             source="src/repro_torch/kernels/csrc/adamw.cu",
             replaces="src/repro/training/optim.py:75 apply_updates "
                      "(XLA-fused under jax.jit)",
             launches=launches["adamw"], **adamw),
        dict(name="mamba_front", route="cuda",
             source="src/repro_torch/kernels/csrc/mamba_front.cu",
             replaces="src/repro/models/ssm.py ssm_apply's conv, silu, "
                      "split and softplus (XLA-fused under jax.jit)",
             launches=launches["mamba_front"], **front),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
