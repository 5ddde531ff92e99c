#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   CUDA extension from ``src/repro_torch/kernels/csrc``, printing the
   build time; beside the build, ``nvcc -Xptxas -v`` compiles the L0
   (K1, K2), quantize, K5 and K6 sources alone and each kernel's
   registers, shared memory and spills are printed.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes its main path gives it and at ragged ones: K1-K3 must agree
   exactly (K1 also from one input; K2 also with r >= b, b = 1, unaligned
   rows, d = 20000, 5000 batches, NaN and inf, and over 100 back-to-back
   launches), K4 within one float32 ulp, the fused ECD-PSGD compression tail
   (``ecd_compress_rows``, K3 and K4 with the step's updates) exactly in
   x_new and y_new for 4, 8 and 16 bits at t = 0, 1 and 2999, NaN where
   the plain version has NaN, K5 (RMSNorm) within 1e-6 in
   float32 and one ulp in bfloat16, K6 (flash attention) within 2e-5 in
   float32 (its CUDA-core kernel) and 2e-2 in bfloat16 (its tensor-core
   kernel, also at D = 96, D = 128 with GQA 8:1, and S and windows off
   its tiles).  Each kernel's time, its plain version's time, its bound
   and (K5, K6) the time of the one PyTorch call that computes the same
   function are measured at the main path's shape (CUDA-graph replays
   timed with CUDA events); K5 also at a decode step's 4 rows and at
   phase families' 8192 rows of 2048, 4096, 7168, 5120 and 8192, K6 also
   at (4, 32, 2048, 64), at (4, 56, 2048, 128) and (4, 64, 2048, 128)
   against (4, 8, 2048, 128) and at whisper-small's (4, 12, 448, 64); K2
   at the
   main path's six shapes, at (1, 4000, 400) and at the six shapes the
   other specs give it, beside an empty kernel's time (the launch floor);
   K1 as the path calls it, from one input, beside ``torch.count_nonzero``,
   also at 1536 x 48 and 800 x 400, and at phase service's 4096 x 64
   (the slot batch) and 2000 x 400; the fused tail also at 16 rows of
   d = 400.  One K2 call runs under ``torch.profiler`` and must be one
   device kernel with no fill or copy.
3. Runs the ``upper_bound`` spec (paper Table II) on the GPU at its
   published iteration count, with every launch counter set to 0 just
   before and read just after: K1 must have launched 10 times, K2 6 times,
   the fused kernel once per ECD-PSGD step (9000 times), and K3 and K4,
   which it replaces there, never.  Then 300 ECD-PSGD steps of the
   sweep's 32-row bucket go straight through ``alg.step`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (any synchronising call
   raises), 300 more are timed, and 100 more run under ``torch.profiler``:
   device kernels per step and the device's busy share are printed.
4. Checks the output: a short ``upper_bound`` run on the GPU must agree
   with the same run on the CPU (the plain versions) — characters to
   1e-6 relative, curves to 1e-5, every value finite; ECD-PSGD, whose
   quantizer turns an ulp into a quantum, within the reference's own
   2e-2 envelope for execution-order differences.
4b. Phase specs: the five specs of the registry beyond upper_bound that
   phase report does not run (``NEW_SPECS`` less ``REPORT_SPECS``) at
   their published sizes on the GPU, no cache, each with the counters set
   to 0 just before and read just after: every job must finish ``ok`` and
   the launches of K1, K2, the fused tail and K3/K4 must equal the counts
   predicted from the spec (`expected_launches`).  One line per spec:
   wall time, per-job timings, status, measured and predicted m_max.
4c. Phase specs-vs-cpu: the same eight specs at their quick sizes and 60
   iterations on the GPU and on the CPU: characters and C_sim to 1e-6
   relative (n, d, diversity and diversity_ratio exact), every seed's
   curves to 1e-5 (faulted jobs included; ECD-PSGD to 2e-2), statuses,
   measured and predicted m_max equal.
4d. Phase report: ``python -m repro_torch.analysis.report`` (its
   ``main``) at the published sizes with its default 8 seeds, ``--force``,
   into a temporary cache, the counters set to 0 just before and read just
   after: K1, K2 and the fused tail must launch `expected_launches` summed
   over the four specs, K3/K4 never, every job ``ok``; each spec's wall
   time (synchronised), and section 6 must attribute at least 95 % of the
   last computed sweep.
4e. Phase report-vs-cpu: the report at ``--quick --iters 60 --n 256
   --seeds 2`` on the card and on the CPU: every measured, fitted and
   predicted m_max and every bootstrap CI equal, every seed's curves
   within 1e-5 (ECD-PSGD 2e-2).
4f. Phase trace: ``python -m repro_torch.experiments.run --spec
   upper_bound --trace F --metrics --serve 0`` in a child process on the
   card, forced into a fresh cache; one ``/flight`` poll through
   ``telemetry.watch`` while it runs; ``python -m repro_torch.telemetry
   --summarize F --min-coverage 0.95`` must exit 0, every ``bucket`` span
   must hold an ``execute`` span, and the stored artifact must equal phase
   3's untraced one byte for byte.
4g. Phase mesh: upper_bound's datasets at 120 iterations and 2 seeds on
   ``from_devices([cuda:0] * 4)`` against ``mesh=None`` (curves within
   1e-5, ECD-PSGD 2e-2, every m_max equal) and on a one-device mesh (bit
   for bit); racing Hogwild! at m = 4 on 4 shards, ``sync_every=1``,
   within 1e-5 of the engine's staleness oracle with the predicted psum
   rounds, ``sync_every=4`` beside it.
4h. Phase service: the advisor service (`repro_torch.service`) on the
   card behind its HTTP server on an ephemeral port of this host, with a
   fresh cache.  An analytic batch of eight probes (six higgs_like
   2000x28, one realsim_like 2000x400 at density 0.05 past the 512x64
   slot envelope, one raw X too small to measure), three times: statuses
   and tiers, K1 launched twice a batch (the slot batch, the oversize
   fallback), every integer m_max equal to the CPU service's.  Eight
   threads then escalate two dataset probes four times each (higgs_like
   4000x28 with ECD-PSGD, realsim_like 2000x400 with Hogwild!): exactly
   two sweeps computed, one artifact per fingerprint served identically
   to every waiter, K1/K2/fused-tail launches equal to the two escalation
   specs' `expected_launches` plus one K1 launch per request's
   measurement, measured and predicted m_max equal to the CPU port's
   runs, curves within 1e-5 (ECD-PSGD 2e-2).  ``/metrics`` must parse
   under the strict parser; its ``repro_service_*`` and ``repro_sweep_*``
   samples are printed with the batch latencies and each escalation's
   wall time.  Robustness on the card at a quick size: a job made to
   raise ``torch.cuda.OutOfMemoryError`` once ends ``retried:1`` with an
   artifact equal to a clean run's apart from that status, a run cut
   after its first job resumes from the journal byte for byte, a mutated
   artifact is quarantined.
5. Serves full-width gemma3-1b in bfloat16 with random weights from a
   seed: a prefill of 4 prompts of 2048 tokens through
   ``make_prefill_step``, then ``greedy_generate`` of 24 tokens for 4
   requests of 16 prompt tokens, with the counters set to 0 just before
   and read just after: K6 must launch 26 times (once a layer) and K5
   2173 times (53 per prefill and per decode step).  One more prefill
   runs under ``torch.profiler``: the ten device kernels by total time
   and the device's busy share of the window are printed ("not measured"
   if the trace holds no device time).
6. Checks the serving output: the prefill's next-token logits against the
   same prefill with no kernel (``attention_impl="reference"``) within
   2e-2 relative L2, and, in float32 on a 6-layer cut, the prefill's
   logits at each of 1100 positions against token-by-token decoding
   within 5e-4.
6b. Phase families: gemma3-1b is freed (the bytes still allocated are
   printed), then xlstm-350m and zamba2-1.2b at full width and depth,
   arctic-480b at full width and 2 layers (its 35 do not fit),
   qwen1.5-110b at full width and 4 layers, deepseek-v2-236b at full
   width and 7 layers (the dense layer and 6 MoE layers of 160 experts),
   whisper-small uncut and qwen2-vl-72b at full width and 4 layers are
   served in bfloat16 from seed 0 as in phase 5, one after another (whisper
   prefills 4 x 448 decoder tokens against 4 x 1500 frame embeddings and
   decodes with its encoder output; qwen2-vl's prompts open with 1024
   patch embeddings on a 32 x 32 M-RoPE grid): K5 and K6 must launch
   exactly ``FAMILIES``' counts per prefill (xlstm 24 and 0, zamba2 77
   and 6, arctic 5 and 2, qwen1.5 9 and 4, deepseek 15 and 0: MLA
   attention is plain, as in the reference; whisper 0 and 12: LayerNorm,
   and its encoder and cross-attention are plain; qwen2-vl 9 and 4), K5
   as often per decode step and K6 never (41 steps a run).  Prefill ms, decode
   ms per token, peak GB and one profiled prefill per family; the kernel
   prefill against the no-kernel prefill in bfloat16 (relative L2,
   printed: at random weights zamba2's depth and arctic's top-2 routing
   amplify an ulp past 2e-2, see ``run_families``).  Checks: (a) each
   kernel prefill against the no-kernel prefill in float32 at the served
   width (arctic at 1 layer, qwen1.5, deepseek and qwen2-vl at 2, qwen2-vl
   with its vision inputs) within 2e-2 relative L2; (b) in float32,
   prefill logits against token-by-token decoding within 5e-4 at each of
   256 positions, on xlstm at 8 layers, zamba2 at 6, arctic at full
   width, 1 layer, 8 experts and capacity factor 8, qwen1.5 at 2 layers,
   deepseek at 2 layers, 8 experts and capacity factor 8 (MLA's absorbed
   decode against its decompressed prefill), whisper at 6 decoder layers
   with its encoder output and qwen2-vl at 2 layers, text only; (c) the
   seven reduced configs in float32 from the same weights on the card and
   the CPU (whisper with frames, qwen2-vl with vision inputs), logits
   within 1e-4.
7. Phase train: ``launch.train.train_loop`` at full-width gemma3-1b in
   bfloat16 on the card (AdamW, lr 3e-4, every layer recomputed in the
   backward, batches of 8 x 1024 tokens from ``hmm_stream``), 10 sync
   steps, then 5 stale steps from fresh weights, with the counters set to
   0 just before each and read just after: training takes the reference's
   arithmetic, so no kernel may launch.  Per strategy: losses, each
   step's ms, the median after the first, tokens/s, the step's model
   flops (``launch.analytic``) as a share of the bf16 peak and the peak
   memory; the loss must fall (the mean of the last three steps below the
   first).  One more sync step runs under ``torch.profiler``.
7b. Phase train-families: ``train_loop`` at full-width, full-depth
   zamba2-1.2b and xlstm-350m in bfloat16 (AdamW, lr 3e-4, every layer
   recomputed in the backward), 5 sync steps each of 4 x 1024
   ``hmm_stream`` tokens, the counters set to 0 just before and read
   just after: no kernel may launch and the loss must fall.  Per family
   the same numbers as phase train and one profiled step.
8. Phase gossip: ``train.steps.make_gossip_step`` at full-width gemma3-1b
   with 2 replicas stacked on the card, 4 steps on one fixed hmm_stream
   batch of 8 x 1024 tokens (4 x 1024 a replica) at lr 2e-3, the
   counters set to 0 just before and read just after: K3 and K4 must each
   launch exactly 2 x 83 times a step (one per reference leaf and
   compression), the fused tail and every other kernel never; the loss
   must fall.  Prints each step's ms, the uniform draws' share of a step,
   the peak memory, the losses and the replicas' spread.  K3/K4 are also
   checked against their plain versions (K3 equal, K4 within 1 ulp) and
   timed beside them, with their byte bounds, at the gossip's embedding
   leaf (2 x 301989888) and one segment leaf (2 x 39813120).
9. Phase train-vs-cpu: reduced gemma3-1b in float32 from the same weights
   on the card and the CPU: 5 sync and 5 stale steps (losses within 1e-4
   relative), 3 gossip steps at R = 4 (within 1e-3); and one sync step's
   loss and every gradient leaf of reduced zamba2-1.2b and xlstm-350m
   (within 1e-4 relative, a leaf to its largest magnitude).
10. Prints one JSON line with each kernel's numbers (the sweep kernels'
   launches also per spec, per report spec and in all for the report,
   and per service path, K3/K4's per path, their
   record at the gossip's largest leaf, K5/K6's per family), then the
   final line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a GPU, outside a checkout of
the repository, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# published peaks of one H100 SXM (dense, no sparsity) used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12

SWEEP_KERNELS = ("l0_rows", "l0_shift_sum", "ecd_compress_rows")
# K3/K4: replaced on the sweep's path by ecd_compress_rows; the gossip
# step (phase gossip) launches them standalone
FUSED_AWAY = ("quantize_rows", "dequantize_rows")
SERVE_KERNELS = ("rmsnorm", "flash_attention")
# phase families: (arch, layers kept: None for all) and the K5 and K6
# launches of one prefill; a decode step launches K5 as often and K6 never.
# K5: every RMSNorm (norm1 of each layer, norm2 of an attention or shared-
# attention layer, the final norm) and each SSM block's gated norm;
# xlstm normalises with LayerNorm elsewhere.  K6: one per attention or
# shared-attention layer.
# MLA attention is plain torch under both implementations, as in the
# reference, so deepseek-v2 launches no K6; whisper normalises with
# LayerNorm, and its encoder and cross-attention are plain torch, so it
# launches K6 once per decoder layer and no K5.
FAMILIES = (("xlstm-350m", None, 24, 0),      # 21 mLSTM + 3 sLSTM gated
            ("zamba2-1.2b", None, 77, 6),     # 38 + 6 + 1 + 32 gated
            ("arctic-480b", 2, 5, 2),         # 2 * 2 + 1
            ("qwen1.5-110b", 4, 9, 4),        # 2 * 4 + 1
            ("deepseek-v2-236b", 7, 15, 0),   # 2 * 7 + 1: dense + 6 MoE
            ("whisper-small", None, 0, 12),   # 12 decoder layers
            ("qwen2-vl-72b", 4, 9, 4))        # 2 * 4 + 1
# layers of check (a)'s float32 models (None: all): arctic's 128 experts
# hold one layer in float32 on one card (56 GB); qwen1.5-110b,
# deepseek-v2 (its dense layer and one MoE layer with all 160 experts)
# and qwen2-vl-72b hold two (about 17-21 GB each)
FAMILY_CHECK_LAYERS = {"xlstm-350m": None, "zamba2-1.2b": None,
                       "arctic-480b": 1, "qwen1.5-110b": 2,
                       "deepseek-v2-236b": 2, "whisper-small": None,
                       "qwen2-vl-72b": 2}
# layers of check (b)'s float32 models (whisper's decoder layers; its
# encoder keeps its 12)
FAMILY_DECODE_LAYERS = {"xlstm-350m": 8, "zamba2-1.2b": 6, "arctic-480b": 1,
                        "qwen1.5-110b": 2, "deepseek-v2-236b": 2,
                        "whisper-small": 6, "qwen2-vl-72b": 2}
FAMILY_STEPS = 16 + 24          # decode steps of a run: prompt + generated
# K5 at the families' prefill widths (8192 rows): zamba2's norms and
# xlstm's mLSTM gated norm, zamba2's gated norm, arctic's norms,
# deepseek-v2's norms, qwen1.5-110b's norms
K5_FAMILY_SHAPES = ((8192, 2048), (8192, 4096), (8192, 7168), (8192, 5120),
                    (8192, 8192))
# K6 at the families' prefill shapes (B, H, KV, S, D): zamba2's shared
# attention, arctic's GQA 56:8, qwen1.5-110b's and qwen2-vl-72b's GQA
# 64:8, whisper-small's decoder self-attention (448 rows, ragged against
# the 128-row q tiles)
K6_FAMILY_SHAPES = ((4, 32, 32, 2048, 64), (4, 56, 8, 2048, 128),
                    (4, 64, 8, 2048, 128), (4, 12, 12, 448, 64))
# whisper-small's decoder context (arXiv:2212.04356)
WHISPER_DECODER_TOKENS = 448


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def _graph_ms(calls, reps: int = 64) -> float:
    """Device time of one call: ``reps`` calls, cycling through ``calls``
    (closures over separate copies of the inputs, enough of them to
    exceed the 50 MB L2 cache so each call reads device memory), captured
    in a CUDA graph; the graph is replayed and timed with CUDA events."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    reps = max(reps, len(calls))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _copies(nbytes: int) -> int:
    """Input copies that together exceed twice the L2 cache."""
    return max(1, min(256, math.ceil(100e6 / max(nbytes, 1))))


def _timed(kernel, plain, inputs, nbytes, library=None, reps=64):
    """(kernel ms, plain ms[, library ms]) over rotating copies of
    ``inputs``."""
    sets = [inputs] + [tuple(t.clone() for t in inputs)
                       for _ in range(_copies(nbytes) - 1)]
    fns = (kernel, plain) + ((library,) if library else ())
    return tuple(_graph_ms([lambda a=a, f=f: f(*a) for a in sets], reps)
                 for f in fns if f)


def _bound_ms(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# K2's shapes on the main path: csim / ls_async at (1, 512, d) with r = 8
# and ls_sync at (64, 8, d) with r = 7, for ub, dense and sparse8
L0_PATH_SHAPES = [(1, 512, 400), (1, 512, 28), (1, 512, 300),
                  (64, 8, 400), (64, 8, 28), (64, 8, 300)]
# K2's whole call is timed there and at ub's whole dataset; row_l0 (K1
# from one input, as the path calls it) at 512 x d and 4000 x 400
L0_SHIFT_TIMED = [(s, 8 if s[1] > 8 else 7)
                  for s in L0_PATH_SHAPES + [(1, 4000, 400)]]
ROW_L0_TIMED = [(512, 400), (512, 28), (512, 300), (4000, 400)]
# K1 and K2 at the other specs' shapes: the character_knob
# specs' 1536 x 48 (C_sim, LS_sync, row supports), ls's measure_csim on
# 400 rows of d = 28 and 200, scalability_study's 800 rows of d = 400
SPEC_SHIFT_TIMED = [((1, 1536, 48), 8), ((192, 8, 48), 7),
                    ((1, 400, 28), 8), ((1, 400, 200), 8),
                    ((1, 800, 400), 8), ((100, 8, 400), 7)]
SPEC_ROW_L0_TIMED = [(1536, 48), (800, 400)]
# K1 on phase service's path: the slot batch (8 slots x 512 rows, 64
# columns, flattened) and the Hogwild! predictor over realsim_like's
# whole 2000 x 400 (its 512 x 400 rows are timed above)
SERVICE_ROW_L0_TIMED = [(4096, 64), (2000, 400)]
# the registry's specs beyond upper_bound, held against the CPU by phase
# specs-vs-cpu; phase specs runs those the report does not
NEW_SPECS = ("variance_sparsity", "scalability_study", "diversity", "ls",
             "problem_generality", "character_surface", "critical_params",
             "fault_tolerance")
# the paper report's four specs (analysis.report.REPORT_SPECS), which phase
# report runs at their published sizes with 8 seeds
REPORT_SPECS = ("upper_bound", "character_surface", "critical_params",
                "fault_tolerance")


def l0_input(gen, shape):
    """Uniform values at density 0.4 from ``gen``: the input K1 and K2 are
    timed on."""
    import torch
    x = torch.rand(*shape, generator=gen, device=gen.device)
    return torch.where(torch.rand(*shape, generator=gen, device=gen.device)
                       < 0.4, x, torch.zeros_like(x))


def time_l0(dev, kc, metrics):
    """Device times of K2 (``kc.l0_shift_sum``, whole call) at
    ``L0_SHIFT_TIMED`` and of ``metrics.row_l0`` at ``ROW_L0_TIMED``, each
    beside its bound, its plain version and, for row_l0,
    ``torch.count_nonzero`` (the same function at tol = 0)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(5)
    shift = []
    for (nb, b, d), r in L0_SHIFT_TIMED + SPEC_SHIFT_TIMED:
        nbytes = nb * b * d * 4 + nb * 8
        bound, by = _bound_ms(nbytes, 3 * nb * b * d * r)
        ms, plain_ms = _timed(lambda t, r=r: kc.l0_shift_sum(t, r),
                              lambda t, r=r: kc.l0_shift_sum_plain(t, r),
                              (l0_input(gen, (nb, b, d)),), nbytes)
        shift.append({"shape": [nb, b, d, r], "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": by, "library_ms": None})
    rows = []
    for n, d in ROW_L0_TIMED + SPEC_ROW_L0_TIMED + SERVICE_ROW_L0_TIMED:
        nbytes = n * d * 4 + n * 4
        bound, by = _bound_ms(nbytes, 2 * n * d)
        ms, plain_ms, library_ms = _timed(
            metrics.row_l0, kc.l0_rows_plain, (l0_input(gen, (n, d)),),
            nbytes, library=lambda t: torch.count_nonzero(t, dim=1))
        rows.append({"shape": [n, d], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": library_ms})
    return {"l0_shift_sum": shift, "row_l0": rows}


def _device_spans(prof):
    """(name, start µs, end µs) of each device kernel, copy and fill of a
    finished ``torch.profiler`` window, in order of start, read from the
    profiler's raw events: building its event tree for a window of some
    10^5 kernels would cost more than the window itself."""
    import torch
    return sorted(((e.name(), e.start_ns() / 1e3,
                    (e.start_ns() + e.duration_ns()) / 1e3)
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and e.duration_ns() > 0), key=lambda s: s[1])


def _kernels_per_call(fn):
    """Device kernels and copies or fills of one ``fn()`` after a warm-up,
    under ``torch.profiler``: [kernel names], copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [name for name, _, _ in _device_spans(prof)]
    copies = [n for n in names if n.startswith(("Memcpy", "Memset"))]
    return {"kernels": len(names) - len(copies), "copies": len(copies),
            "names": [n[:80] for n in names]}


def check_kernels(dev):
    """Phase 2: every kernel against its plain version; returns the
    per-kernel records (without launch counts)."""
    import torch
    from repro_torch import random as R
    from repro_torch.core import compression, metrics
    from repro_torch.kernels import csim as kc
    from repro_torch.kernels import quantize as kq

    def data(shape, seed, density=0.7):
        key = R.PRNGKey(seed, device=dev)
        k1, k2 = R.split(key)
        X = R.uniform(k1, shape)
        return torch.where(R.bernoulli(k2, density, shape), X,
                           torch.zeros_like(X)).contiguous()

    records = {}

    # K1: the main path calls it on (rows, d) against zeros for the row
    # supports; ragged shapes and perturbed copies exercise tol
    err = 0.0
    for i, (n, d) in enumerate([(4000, 400), (512, 400), (512, 28),
                                (512, 300), (257, 1025), (33, 7), (1, 1)]
                               + SPEC_ROW_L0_TIMED + SERVICE_ROW_L0_TIMED):
        x = data((n, d), i)
        y = x + (data((n, d), 100 + i, density=0.3) * 0.5)
        for other in (None, torch.zeros_like(x), y.contiguous()):
            for tol in (0.0, 0.25):
                got = kc.l0_rows(x, other, tol)
                want = kc.l0_rows_plain(x, other, tol)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"K1 l0_rows differs at n={n} "
                                         f"d={d} tol={tol}")
                err = max(err, float((got - want).abs().max()))
    # the main path calls it from one input (metrics.row_l0); timed there
    # as the path calls it, the two-input form at ub's whole dataset
    x = data((4000, 400), 0)
    n, d = x.shape
    nbytes = 2 * n * d * 4 + n * 4
    bound, by = _bound_ms(nbytes, 3 * n * d)
    ms, plain_ms = _timed(kc.l0_rows, kc.l0_rows_plain,
                          (x, torch.zeros_like(x)), nbytes)
    records["l0_rows"] = {
        "name": "l0_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/l0.cu",
        "replaces": "src/repro/kernels/csim.py:24",
        "max_abs_err": err, "shape": [n, d], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None}

    # K2: csim (nb=1, b=rows, r=8) and the LS_sync pair scan (r=b-1) at the
    # main path's shapes, r >= b, b = 1, d = 1 and 7, unaligned rows (a
    # view one float off 16 bytes, odd d), the feature-tiled path
    # (d = 20000), many batches, NaN and +-inf
    err = 0.0
    cases = [(s, 8) for s in L0_PATH_SHAPES[:3]]
    cases += [(s, 7) for s in L0_PATH_SHAPES[3:6]]
    cases += [((1, 4000, 400), 8), ((3, 5, 7), 13), ((4, 1, 9), 3),
              ((2, 9, 1), 4), ((3, 11, 7), 5), ((2, 33, 130), 6),
              ((1, 40, 20000), 8), ((5000, 8, 28), 7)]
    cases += [((3, 37, 129), r) for r in range(1, 17)]
    cases += SPEC_SHIFT_TIMED
    for i, (shape, r) in enumerate(cases):
        X = data(shape, 200 + i, density=0.4)
        flat = data((X.numel() + 1,), 900 + i, density=0.4)
        odd = flat[1:].view(shape)
        bad = X.clone()
        bad.view(-1)[::7] = math.nan
        bad.view(-1)[3::11] = math.inf
        bad.view(-1)[5::13] = -math.inf
        for Y in (X, odd, bad):
            for tol in (0.0, 0.5):
                got = kc.l0_shift_sum(Y, r, tol)
                want = kc.l0_shift_sum_plain(Y, r, tol)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"K2 l0_shift_sum differs at {tuple(Y.shape)} r={r} "
                        f"tol={tol} data_ptr%16={Y.data_ptr() % 16}")
                err = max(err, float((got - want).abs().max()))
    # back to back on one stream: the counters return to zero each launch
    inputs = [(data(s, 990 + i), r) for i, (s, r) in enumerate(cases[:8])]
    outs = [kc.l0_shift_sum(*inputs[i % 8]) for i in range(100)]
    for i, got in enumerate(outs):
        if not torch.equal(got, kc.l0_shift_sum_plain(*inputs[i % 8])):
            raise AssertionError(f"K2 differs at back-to-back launch {i}")
    per_call = _kernels_per_call(lambda: kc.l0_shift_sum(*inputs[0]))
    if (per_call["kernels"], per_call["copies"]) != (1, 0):
        raise AssertionError(f"one K2 call is not one device kernel: "
                             f"{per_call}")
    timed = time_l0(dev, kc, metrics)
    records["l0_rows"]["one_input"] = timed["row_l0"]
    head = timed["l0_shift_sum"][0]
    records["l0_shift_sum"] = {
        "name": "l0_shift_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/l0.cu",
        "replaces": "src/repro/kernels/csim.py:64",
        "max_abs_err": err, **{k: head[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "by_shape": timed["l0_shift_sum"],
        "empty_ms": _graph_ms([lambda: kc.empty_launch(dev)]),
        "kernels_per_call": per_call}

    # K3/K4: ECD-PSGD quantizes (members * m_pad, d) rows per step; the
    # upper_bound buckets give 8, 32 and 24 rows of d = 28
    err3 = err4 = 0.0
    for i, (r, d) in enumerate([(8, 28), (32, 28), (24, 28), (5, 1000),
                                (1, 112000), (3, 1)]):
        key = R.PRNGKey(300 + i, device=dev)
        k1, k2 = R.split(key)
        x = (R.uniform(k1, (r, d), -4.0, 3.0)
             * torch.arange(1, r + 1, device=dev)[:, None]).contiguous()
        u = R.uniform(k2, (r, d))
        for bits in (4, 8, 16):
            scale = compression.row_scales(x, bits)
            q = kq.quantize_rows(x, u, scale, bits)
            qp = kq.quantize_rows_plain(x, u, scale, bits)
            dq = kq.dequantize_rows(q, scale)
            dqp = kq.dequantize_rows_plain(q, scale)
            torch.cuda.synchronize()
            if q.dtype != qp.dtype or not torch.equal(q, qp):
                raise AssertionError(f"K3 quantize_rows differs at "
                                     f"r={r} d={d} bits={bits}")
            up = torch.nextafter(dqp, torch.full_like(dqp, math.inf))
            ulp = torch.abs(up - dqp)
            if not bool((torch.abs(dq - dqp) <= ulp).all()):
                raise AssertionError(f"K4 dequantize_rows differs by more "
                                     f"than 1 ulp at r={r} d={d} bits={bits}")
            err3 = max(err3, float((q.int() - qp.int()).abs().max()))
            err4 = max(err4, float((dq - dqp).abs().max()))
    key = R.PRNGKey(400, device=dev)
    k1, k2 = R.split(key)
    x = R.uniform(k1, (32, 28), -4.0, 3.0).contiguous()
    u = R.uniform(k2, (32, 28))
    scale = compression.row_scales(x, 8)
    q = kq.quantize_rows(x, u, scale, 8)
    r, d = x.shape
    nbytes = r * d * (4 + 4 + 1) + r * 4
    bound, by = _bound_ms(nbytes, 5 * r * d)
    ms, plain_ms = _timed(lambda *a: kq.quantize_rows(*a, 8),
                          lambda *a: kq.quantize_rows_plain(*a, 8),
                          (x, u, scale), nbytes)
    records["quantize_rows"] = {
        "name": "quantize_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:25",
        "max_abs_err": err3, "shape": [r, d, 8], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None}
    nbytes = r * d * (1 + 4) + r * 4
    bound, by = _bound_ms(nbytes, r * d)
    ms, plain_ms = _timed(kq.dequantize_rows, kq.dequantize_rows_plain,
                          (q, scale), nbytes)
    records["dequantize_rows"] = {
        "name": "dequantize_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:34",
        "max_abs_err": err4, "shape": [r, d, 8], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None}
    for name in FUSED_AWAY:
        records[name]["note"] = ("on the gossip step's path (one launch per "
                                 "leaf and compression); off the sweep's: "
                                 "ecd_compress_rows fuses it with the "
                                 "step's updates")
    records["ecd_compress_rows"] = check_ecd_compress(dev)
    return records


def _tail_inputs(dev, r, d, seed, offset=0):
    """grads, x_half, xs, ys, u as (r, d) float32 on the card; row 0 of
    the first three is zero (so is its z) when r > 1.  ``offset`` floats
    before each row block leave the rows off 16-byte alignment."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = [torch.randn(offset + r * d, generator=gen, device=dev) * s
            for s in (0.5, 0.2, 0.2, 0.1)]
    flat.append(torch.rand(offset + r * d, generator=gen, device=dev))
    ins = [a[offset:].view(r, d) for a in flat]
    if r > 1:
        for a in ins[:3]:
            a[0] = 0.0
    return ins


def check_ecd_compress(dev):
    """Phase 2, the fused ECD-PSGD compression tail against its plain
    version: x_new and y_new equal (``torch.equal``) at the sweep's 8, 32
    and 24 rows of d = 28, the ragged shapes of K3's check, rows wider
    than one warp's registers (the two-pass kernel), rows off 16-byte
    alignment (scalar loads) and an all-zero row, for 4, 8 and 16 bits at
    t = 0, 1 and 2999; rows holding NaN or inf give NaN where the plain
    version does.  Returns its record (without launch count)."""
    import torch
    from repro_torch.kernels import quantize as kq

    cases = [((8, 28), 0), ((32, 28), 0), ((24, 28), 0), ((5, 1000), 0),
             ((1, 112000), 0), ((3, 1), 0), ((7, 30), 0), ((3, 999), 0),
             ((4, 1024), 0), ((2, 1025), 0), ((32, 28), 1), ((5, 1000), 1)]
    # the rows of variance_sparsity's and scalability_study's d = 400
    # buckets and of ls's d = 28 ones
    cases += [((1, 400), 0), ((4, 400), 0), ((8, 400), 0), ((16, 400), 0),
              ((1, 28), 0), ((16, 28), 0)]
    # the two buckets of phase service's ECD-PSGD escalation (m = 1, 2, 4)
    cases += [((4, 28), 0)]
    err = 0.0
    for i, ((r, d), offset) in enumerate(cases):
        ins = _tail_inputs(dev, r, d, 500 + i, offset)
        for bits in (4, 8, 16):
            for t in (0, 1, 2999):
                got = kq.ecd_compress_rows(*ins, 0.1, t, bits)
                want = kq.ecd_compress_rows_plain(*ins, 0.1, t, bits)
                torch.cuda.synchronize()
                for name, a, b in zip(("x_new", "y_new"), got, want):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"ecd_compress_rows {name} differs at r={r} "
                            f"d={d} offset={offset} bits={bits} t={t}: max "
                            f"{float((a - b).abs().max())}")
                    err = max(err, float((a - b).abs().max()))
    # a NaN in one row's gradient and an inf in another's model: the row
    # maximum must carry them as torch.amax does
    ins = _tail_inputs(dev, 8, 28, 600)
    ins[0][2, 5] = math.nan
    ins[2][4, 7] = math.inf
    for bits in (4, 8, 16):
        got = kq.ecd_compress_rows(*ins, 0.1, 7, bits)
        want = kq.ecd_compress_rows_plain(*ins, 0.1, 7, bits)
        for a, b in zip(got, want):
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            if not bool(same.all()):
                raise AssertionError(f"ecd_compress_rows differs on NaN/inf "
                                     f"rows at bits={bits}")
        if not bool(torch.isnan(got[1][[2, 4]]).all()):
            raise AssertionError("ecd_compress_rows: a NaN or inf row did "
                                 "not give a NaN y_new row")
    timed = []
    for r, d in ((32, 28), (16, 400)):
        ins = _tail_inputs(dev, r, d, 700)
        nbytes = 7 * r * d * 4
        bound, by = _bound_ms(nbytes, 21 * r * d)
        ms, plain_ms = _timed(
            lambda *a: kq.ecd_compress_rows(*a, 0.1, 1500, 8),
            lambda *a: kq.ecd_compress_rows_plain(*a, 0.1, 1500, 8),
            tuple(ins), nbytes)
        timed.append({"shape": [r, d, 8], "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": by, "library_ms": None})
    return {"name": "ecd_compress_rows", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize.py:25",
            "also_replaces": "src/repro/kernels/quantize.py:34",
            "max_abs_err": err, **timed[0], "d400": timed[1]}


def _bf16_ulp(x):
    """The spacing of bfloat16 at |x| (that of 2**-126 below it)."""
    import torch
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - 7)


def _band_pairs(S: int, T: int, window: int) -> int:
    """Unmasked (row, col) pairs of a causal attention with ``window``."""
    total = 0
    for r in range(S):
        lo = max(0, r - window + 1) if window else 0
        total += max(0, min(r, T - 1) - lo + 1)
    return total


def check_lm_kernels(dev):
    """Phase 2, serving kernels: K5 and K6 against their plain versions;
    returns their records (without launch counts)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krms

    gen = torch.Generator(device=dev).manual_seed(12)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    records = {}

    # K5: the prefill's (4 * 2048, 1152) rows and a decode step's 4, in
    # bfloat16, the families' prefill widths (phase families), plus the
    # reference's ragged float32 shapes
    err = 0.0
    for (n, d), dtype in [((8192, 1152), torch.bfloat16),
                          ((4, 1152), torch.bfloat16),
                          ((5, 1152), torch.float32),
                          ((300, 128), torch.float32)] + [
                              (s, torch.bfloat16) for s in K5_FAMILY_SHAPES]:
        x, w = randn(n, d, dtype=dtype), randn(d, dtype=dtype)
        got = krms.rmsnorm_2d(x, w).float()
        want = krms.rmsnorm_plain(x, w).float()
        torch.cuda.synchronize()
        bound = (1e-6 + 1e-7 * want.abs() if dtype == torch.float32
                 else _bf16_ulp(want))
        diff = (got - want).abs()
        if not bool((diff <= bound).all()):
            raise AssertionError(f"K5 rmsnorm differs at {n}x{d} {dtype}: "
                                 f"max {float(diff.max())}")
        err = max(err, float(diff.max()))
    # times at the prefill's shape and at a decode step's (2120 of the
    # serving run's 2173 launches are 4 rows)
    timed = {}
    for n, d in ((8192, 1152), (4, 1152)) + K5_FAMILY_SHAPES:
        x = randn(n, d, dtype=torch.bfloat16)
        w = randn(d, dtype=torch.bfloat16)
        nbytes = 2 * n * d * 2 + d * 2
        bound, by = _bound_ms(nbytes, 4 * n * d)
        ms, plain_ms, library_ms = _timed(
            krms.rmsnorm_2d, krms.rmsnorm_plain, (x, w), nbytes,
            library=lambda a, b, d=d: F.rms_norm(a, (d,), b, krms.EPS))
        timed[n, d] = {"shape": [n, d, "bf16"], "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by, "library_ms": library_ms}
    records["rmsnorm"] = {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:20",
        "max_abs_err": err, **timed[8192, 1152], "decode": timed[4, 1152],
        "by_shape": [timed[s] for s in K5_FAMILY_SHAPES]}

    # K6: gemma3-1b's prefill (4 queries heads, 1 KV head, D = 256) with
    # and without its 1024 window, the reference's sweep shapes (ragged
    # S = 200, D = 48 with window 16) and the float32 serve-check shape
    cases = [((4, 2048, 4, 1, 256, 0), torch.bfloat16),
             ((4, 2048, 4, 1, 256, 1024), torch.bfloat16),
             ((1, 1100, 4, 1, 256, 1024), torch.float32)]
    sweep = [(1, 64, 2, 2, 32, 0), (2, 128, 4, 2, 64, 0),
             (2, 200, 4, 1, 64, 0), (1, 256, 8, 8, 128, 0),
             (2, 128, 4, 2, 64, 32), (1, 96, 6, 3, 48, 16)]
    cases += [(c, t) for t in (torch.float32, torch.bfloat16) for c in sweep]
    # the bf16 kernel's edges: phi3's D = 96, D = 128 with GQA 8:1, a causal
    # S and a window that are not multiples of its 64-column k tile, S
    # shorter than one tile and than one 128-row q tile
    cases += [(c, torch.bfloat16) for c in
              [(1, 300, 4, 4, 96, 0), (2, 256, 16, 2, 128, 0),
               (1, 1000, 8, 1, 128, 0), (1, 1000, 4, 1, 256, 100),
               (2, 40, 4, 2, 64, 0), (1, 17, 2, 1, 256, 5),
               (1, 1100, 4, 1, 256, 1024)]]
    # the families' prefill shapes (phase families), and the float32
    # shapes of their checks (b) and (c)
    cases += [((B, S, H, KV, D, 0), torch.bfloat16)
              for B, H, KV, S, D in K6_FAMILY_SHAPES]
    cases += [(c, torch.float32) for c in
              [(1, 256, 32, 32, 64, 0), (1, 256, 56, 8, 128, 0),
               (1, 256, 64, 8, 128, 0), (1, 256, 12, 12, 64, 0),
               (2, 40, 4, 4, 64, 0), (2, 40, 4, 1, 64, 0)]]
    err_by_dtype = {"float32": 0.0, "bfloat16": 0.0}
    for (B, S, H, KV, D, window), dtype in cases:
        q = randn(B, S, H, D, dtype=dtype)
        k, v = randn(B, S, KV, D, dtype=dtype), randn(B, S, KV, D, dtype=dtype)
        got = kfa.flash_attention(q, k, v, True, window).float()
        want = kfa.attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), True,
                                   window).transpose(1, 2).float()
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        diff = (got - want).abs()
        if not bool((diff <= tol + tol * want.abs()).all()):
            raise AssertionError(f"K6 flash_attention differs at "
                                 f"{(B, S, H, KV, D, window)} {dtype}: max "
                                 f"{float(diff.max())}")
        key = str(dtype).split(".")[-1]
        err_by_dtype[key] = max(err_by_dtype[key], float(diff.max()))
    # times per launch at the prefill's shape, both kinds of layer; the
    # record holds their mean over the prefill's 22 local + 4 global layers
    B, S, H, KV, D = 4, 2048, 4, 1, 256
    q = randn(B, H, S, D, dtype=torch.bfloat16)
    k = randn(B, KV, S, D, dtype=torch.bfloat16)
    v = randn(B, KV, S, D, dtype=torch.bfloat16)
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * S * D)
    rows = torch.arange(S, device=dev)
    by_window = {}
    for window, layers in ((0, 4), (1024, 22)):
        nops = 4 * B * H * D * _band_pairs(S, S, window)
        bound, by = _bound_ms(nbytes, nops, BF16_TENSOR_OPS_PER_S)
        if window:
            mask = ((rows[None, :] <= rows[:, None])
                    & (rows[None, :] > rows[:, None] - window))
            library = (lambda a, b, c, m=mask: F.scaled_dot_product_attention(
                a, b, c, attn_mask=m, enable_gqa=True))
        else:
            library = (lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, is_causal=True, enable_gqa=True))
        ms, plain_ms, library_ms = _timed(
            lambda a, b, c, w=window: kfa.flash_attention_bhsd(a, b, c, True,
                                                               w),
            lambda a, b, c, w=window: kfa.attention_plain(a, b, c, True, w),
            (q, k, v), nbytes, library=library, reps=32)
        by_window[window] = {"layers": layers, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound, "bound_by": by,
                             "library_ms": library_ms, "gflop": nops / 1e9}
    mean = {key: sum(r["layers"] * r[key] for r in by_window.values()) / 26
            for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    family_shapes = []
    for B, H, KV, S, D in K6_FAMILY_SHAPES:
        q = randn(B, H, S, D, dtype=torch.bfloat16)
        k = randn(B, KV, S, D, dtype=torch.bfloat16)
        v = randn(B, KV, S, D, dtype=torch.bfloat16)
        nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * S * D)
        nops = 4 * B * H * D * _band_pairs(S, S, 0)
        bound, by = _bound_ms(nbytes, nops, BF16_TENSOR_OPS_PER_S)
        ms, plain_ms, library_ms = _timed(
            lambda a, b, c: kfa.flash_attention_bhsd(a, b, c, True, 0),
            lambda a, b, c: kfa.attention_plain(a, b, c, True, 0),
            (q, k, v), nbytes,
            library=lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, is_causal=True, enable_gqa=True), reps=8)
        family_shapes.append({
            "shape": [B, H, S, D, KV, "bf16"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms, "gflop": nops / 1e9})
        del q, k, v
    records["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "routes": {"bfloat16": "flash_wgmma_kernel: wgmma on the tensor "
                               "cores, TMA copies (the model's path, timed)",
                   "float32": "flash_simt_kernel: CUDA cores"},
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "max_abs_err": max(err_by_dtype.values()),
        "max_abs_err_by_dtype": err_by_dtype,
        "shape": [B, H, S, D, KV, "bf16"],
        "bound_by": by_window[0]["bound_by"], "by_window": by_window,
        **mean, "by_shape": family_shapes}
    return records


def run_serve(dev):
    """Phase 5: full-width gemma3-1b, bfloat16, random weights from a seed;
    a prefill of 4 x 2048 tokens, then greedy decoding of 24 tokens for 4
    requests of 16 prompt tokens.  Returns (report, launches, params,
    batch, next-token logits)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E

    cfg = get_arch("gemma3-1b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2048),
                                     generator=gen, device=dev)}
    prompts = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                            device=dev)
    prefill = E.make_prefill_step(cfg)
    prefill(params, batch)                          # warm-up, not counted
    E.greedy_generate(params, cfg, prompts, 2, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = E.greedy_generate(params, cfg, prompts, 24, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernels.launch_counts()
    steps = prompts.shape[1] + 24
    report = {"prefill_ms": (t1 - t0) * 1e3,
              "prefill_tokens_per_s": batch["tokens"].numel() / (t1 - t0),
              "decode_ms_per_token": (t2 - t1) * 1e3 / steps,
              "generated_tokens_per_s": out.numel() / (t2 - t1),
              "max_memory_allocated_gb":
                  torch.cuda.max_memory_allocated() / 1e9}
    if logits.shape != (4, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are malformed or not finite")
    if out.shape != (4, 24) or int(out.min()) < 0 \
            or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"generated tokens malformed: {out.shape}")
    want = {"flash_attention": cfg.num_layers,
            "rmsnorm": (2 * cfg.num_layers + 1) * (1 + steps)}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"on the serving path, expected {n}")
    report["profile"] = _profile(lambda: prefill(params, batch))
    return report, launches, params, batch, logits


def _profile(fn, top: int = 10):
    """``fn()`` under ``torch.profiler``, recording device activity only:
    the ``top`` device kernels by total time, the device's busy share of
    the window (the union of kernel intervals over the window's wall
    time, host clock around work that ends in a synchronise), and the
    count of device kernels and of copies and fills (``_device_spans``).
    Returns "not measured" when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = _device_spans(prof)
    if not spans:
        return "not measured"
    by_name = {}
    for name, start, end in spans:
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - start, count + 1)
    busy = 0.0
    cur_start = cur_end = None
    for _, start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    copies = sum(1 for name, _, _ in spans
                 if name.startswith(("Memcpy", "Memset")))
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"window_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us,
            "kernel_ms_total": sum(t for t, _ in by_name.values()) / 1e3,
            "device_kernels": len(spans) - copies, "device_copies": copies,
            "top_kernels": [{"name": name[:120], "ms": total / 1e3,
                             "calls": count}
                            for name, (total, count) in kernels]}


def run_sweep_steps(dev, steps: int = 300):
    """Phase 3b: ECD-PSGD steps of upper_bound's 32-row bucket (members
    m = 8 and 16 at pad width 16 on its dense dataset, d = 28) straight
    through ``alg.step``, after 20 warm-up steps: (a) ``steps`` steps under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any call
    that synchronises, with the launch counters set to 0 just before and
    read just after; (b) ``steps`` more timed on the host clock, ending in
    a synchronise; (c) 100 more under ``torch.profiler``."""
    import torch
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch.core import problems
    from repro_torch.core.algorithms import base as alg_base
    from repro_torch.experiments import engine, registry
    from repro_torch.experiments import spec as spec_mod

    spec = registry.get_spec("upper_bound")
    job = next(j for j in spec.jobs if j.algorithm == "ecd_psgd")
    ds = spec.datasets[job.dataset]
    train, _ = spec_mod.split_dataset(ds, spec_mod.build_dataset(ds, dev),
                                      spec.split_seed)
    alg = alg_base.get_algorithm(job.algorithm)(**job.kwargs)
    prob = problems.resolve_problem(job.problem)
    # the engine runs the grid (2, 4, 8, 16, 24) as buckets (2, 4) at pad
    # width 4, (8, 16) at 16 and (24,) at 24: 8, 32 and 24 worker rows
    members, m_pad = (8, 16), 16
    n, d = train.X.shape
    warm, profiled = 20, 100
    iters = warm + 2 * steps + profiled
    draws = alg.make_draws(R.PRNGKey(0, device=dev), n, iters, max(spec.ms),
                           d)
    ctx, state, per_elem = engine.prepare_bucket(alg, prob, train, members,
                                                 m_pad, [draws])
    batches = [alg_base.map_draws(lambda a: a[t], per_elem)
               for t in range(iters)]

    def run(lo, hi):
        nonlocal state
        for t in range(lo, hi):
            state = alg.step(prob, train, ctx, state, batches[t], t)

    run(0, warm)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(warm, warm + steps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if launches != {**{k: 0 for k in launches}, "ecd_compress_rows": steps}:
        raise AssertionError(f"{steps} ECD-PSGD steps launched {launches}")
    t0 = time.perf_counter()
    run(warm + steps, warm + 2 * steps)
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) * 1e6 / steps
    prof = _profile(lambda: run(warm + 2 * steps, iters))
    xs, ys = state
    if xs.shape != (len(members), m_pad, d) or ys.shape != xs.shape or \
            not bool(torch.isfinite(xs).all() & torch.isfinite(ys).all()):
        raise AssertionError("ECD-PSGD state is malformed or not finite")
    report = {"rows": len(members) * m_pad, "d": d,
              "sync_free_steps": steps, "launches": launches,
              "host_us_per_step": step_us, "profiled_steps": profiled}
    if isinstance(prof, dict):
        report["device_kernels_per_step"] = prof["device_kernels"] / profiled
        report["device_copies_per_step"] = prof["device_copies"] / profiled
        report["device_busy_share"] = prof["device_busy_share"]
    return report, prof


def _rel_l2(a, b) -> float:
    import torch
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


def check_serve(dev, params, batch, logits):
    """Phase 6: (a) the kernel prefill against the prefill with no kernel,
    bfloat16 at full width: relative L2 of the next-token logits at most
    2e-2; (b) float32 on a 6-layer cut (five local layers, one global),
    one prompt of 1100 tokens: the prefill's logits at every position
    against token-by-token decoding within 5e-4, the reference's own
    bound (tests/test_archs.py).  The check (a) call converts ``params``
    to float32 in place."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E

    cfg = params.cfg
    prefill_plain = E.make_prefill_step(cfg, attention_impl="reference")
    plain = prefill_plain(params, batch)
    rel = _rel_l2(logits, plain)
    agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    if not rel <= 2e-2:
        raise AssertionError(f"kernel prefill differs from the plain one: "
                             f"relative L2 {rel} > 2e-2")
    # where the difference comes from: each bfloat16 path against the same
    # weights in float32 (printed, not checked)
    exact = prefill_plain(params.float(), batch)
    to_f32 = {"kernel": _rel_l2(logits, exact),
              "reference": _rel_l2(plain, exact)}
    del params, plain, exact

    cfg6 = dataclasses.replace(cfg, num_layers=6, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(1)
    params6 = M.init_params(cfg6, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1100), generator=gen,
                           device=dev)
    full, _ = M.forward(params6, cfg6, {"tokens": tokens})
    state = M.init_decode_state(cfg6, 1, tokens.shape[1], device=dev)
    err = torch.zeros((), device=dev)
    for t in range(tokens.shape[1]):
        step, state = M.decode_step(params6, cfg6, tokens[:, t:t + 1], state)
        err = torch.maximum(err, (step[:, 0] - full[:, t]).abs().max())
    err = float(err)
    if not err <= 5e-4:
        raise AssertionError(f"prefill and decode logits differ by {err} > "
                             f"5e-4")
    return {"a_rel_l2": rel, "a_argmax_agreement": agree,
            "a_rel_l2_to_float32": to_f32, "b_max_abs_diff": err,
            "b_windows": [s.window for s in M.layer_plan(cfg6)]}


def _grid_positions(batch, seq, vision, device):
    """(3, batch, seq) M-RoPE ids of a prompt that opens with ``vision``
    patches of a square grid, as Qwen2-VL lays them out (arXiv:2409.12191
    section 2.1): t = 0, h = row, w = col; the text continues from the
    grid's side on all three streams."""
    import torch
    side = math.isqrt(vision)
    if side * side != vision:
        raise ValueError(f"{vision} patches are not a square grid")
    idx = torch.arange(vision, device=device)
    text = side + torch.arange(seq - vision, device=device)
    pos = torch.stack([torch.cat([torch.zeros_like(idx), text]),
                       torch.cat([idx // side, text]),
                       torch.cat([idx % side, text])])
    return pos[:, None].expand(3, batch, seq).contiguous()


def _family_batch(cfg, gen, dev):
    """Phase families' prefill batch, drawn from ``gen``: 4 prompts of 2048
    tokens; for whisper 448 decoder tokens and 0.1 * normal frame
    embeddings (4, 1500, 768); for qwen2-vl 0.02 * normal patch
    embeddings for the first 1024 positions (a 32 x 32 grid), with grid
    positions.  The embeddings are in the model's type."""
    import torch
    dtype = getattr(torch, cfg.dtype)
    seq = WHISPER_DECODER_TOKENS if cfg.encoder_layers else 2048
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, seq),
                                     generator=gen, device=dev)}
    if cfg.encoder_layers:
        batch["frames"] = (0.1 * torch.randn(
            4, cfg.encoder_seq, cfg.d_model, generator=gen,
            device=dev)).to(dtype)
    if cfg.vision_tokens:
        batch["vision_embeds"] = (0.02 * torch.randn(
            4, cfg.vision_tokens, cfg.d_model, generator=gen,
            device=dev)).to(dtype)
        batch["positions"] = _grid_positions(4, seq, cfg.vision_tokens, dev)
    return batch


def _as_float32(batch):
    return {k: v.float() if v.is_floating_point() else v
            for k, v in batch.items()}


def run_families(dev):
    """Phase families: xlstm-350m and zamba2-1.2b at full width and depth,
    arctic-480b at full width and 2 layers, qwen1.5-110b at 4,
    deepseek-v2-236b at 7 (its dense layer and 6 MoE layers), whisper-small
    uncut and qwen2-vl-72b at 4, bfloat16, random weights from seed 0.
    For each: a prefill of ``_family_batch`` (4 x 2048 tokens; whisper's
    4 x 448 against 4 x 1500 frames, qwen2-vl's with 1024 patch
    embeddings) through
    ``make_prefill_step``, then ``greedy_generate`` of 24 tokens for 4
    requests of 16 prompt tokens (whisper's against the encoder output of
    the batch's frames, computed before the counters are set), with the
    counters set to 0 just before
    and read after the prefill and after the run: K5 and K6 must launch
    exactly ``FAMILIES``' counts per prefill, K5 as often per decode step,
    K6 never in decoding, no other kernel at all.  One more prefill runs
    under ``torch.profiler``, and one with no
    kernel (``attention_impl="reference"``): the relative L2 of the two
    prefills' next-token logits in bfloat16 is printed, not checked.
    At random weights neither bfloat16 path is within 2e-2 of the other
    for zamba2 (both lie 0.26-0.27 from a float32 evaluation of the same
    weights: 38 layers amplify bfloat16 rounding) or arctic (a change in
    an ulp flips top-2 choices among 128 experts).  Check (a) is made in
    float32 from seed 0 at the same width (arctic at 1 layer, all 128
    experts; qwen1.5-110b, deepseek-v2 and qwen2-vl at 2, deepseek's with
    all 160 experts, on the same batch in float32): the kernel prefill's
    next-token logits against the no-kernel prefill's within 2e-2
    relative L2.  For deepseek-v2 the two
    prefills differ only in K5 (MLA attention is plain in both).  Each
    model is freed before the next is built.  Returns ({arch: report},
    {arch: launches of the run})."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E

    reports, launches = {}, {}
    for arch, layers, k5, k6 in FAMILIES:
        cfg = get_arch(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = M.init_params(cfg, gen, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights_gb = torch.cuda.memory_allocated() / 1e9
        batch = _family_batch(cfg, gen, dev)
        prompts = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                                device=dev)
        enc = (M.encode(params.encoder, cfg, batch["frames"])
               if cfg.encoder_layers else None)
        prefill = E.make_prefill_step(cfg)
        prefill(params, batch)                      # warm-up, not counted
        E.greedy_generate(params, cfg, prompts, 2, device=dev, enc_out=enc)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        per_prefill = kernels.launch_counts()
        out = E.greedy_generate(params, cfg, prompts, 24, device=dev,
                                enc_out=enc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        run = kernels.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {**{k: 0 for k in run}, "rmsnorm": k5, "flash_attention": k6}
        want_run = {**want, "rmsnorm": k5 * (1 + FAMILY_STEPS)}
        if per_prefill != want or run != want_run:
            raise AssertionError(
                f"{arch}: launches per prefill {per_prefill} (expected "
                f"{want}), per run {run} (expected {want_run})")
        if logits.shape != (4, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: prefill logits are malformed or "
                                 f"not finite")
        if out.shape != (4, 24) or int(out.min()) < 0 \
                or int(out.max()) >= cfg.vocab_size:
            raise AssertionError(f"{arch}: generated tokens malformed: "
                                 f"{tuple(out.shape)}")
        report = {"layers": cfg.num_layers,
                  "prefill_tokens": list(batch["tokens"].shape),
                  "init_s": init_s,
                  "weights_gb": weights_gb,
                  "prefill_ms": (t1 - t0) * 1e3,
                  "prefill_tokens_per_s": batch["tokens"].numel() / (t1 - t0),
                  "decode_ms_per_token": (t2 - t1) * 1e3 / FAMILY_STEPS,
                  "generated_tokens_per_s": out.numel() / (t2 - t1),
                  "max_memory_allocated_gb": peak_gb,
                  "launches_per_prefill": {k: per_prefill[k]
                                           for k in SERVE_KERNELS}}
        report["profile"] = _profile(lambda: prefill(params, batch))
        plain = E.make_prefill_step(cfg, attention_impl="reference")(
            params, batch)
        report["bf16_rel_l2_kernel_vs_plain"] = _rel_l2(logits, plain)
        report["bf16_argmax_agreement"] = float(
            (logits.argmax(-1) == plain.argmax(-1)).float().mean())
        reports[arch], launches[arch] = report, run
        del params, prompts, logits, plain, out, enc
        gc.collect()
        torch.cuda.empty_cache()

        layers = FAMILY_CHECK_LAYERS[arch]
        cfg32 = dataclasses.replace(get_arch(arch), dtype="float32",
                                    **({"num_layers": layers} if layers
                                       else {}))
        params = M.init_params(
            cfg32, torch.Generator(device=dev).manual_seed(0), dev)
        batch = _as_float32(batch)
        logits = E.make_prefill_step(cfg32)(params, batch)
        plain = E.make_prefill_step(cfg32, attention_impl="reference")(
            params, batch)
        rel = _rel_l2(logits, plain)
        if not rel <= 2e-2:
            raise AssertionError(f"{arch}: kernel prefill differs from the "
                                 f"plain one in float32: relative L2 {rel} "
                                 f"> 2e-2")
        report["a_layers"] = cfg32.num_layers
        report["a_rel_l2"] = rel
        report["a_argmax_agreement"] = float(
            (logits.argmax(-1) == plain.argmax(-1)).float().mean())
        del params, batch, logits, plain
        gc.collect()
        torch.cuda.empty_cache()
    return reports, launches


def check_families(dev):
    """Phase families, checks (b) and (c).  (b) float32 on the card: the
    prefill's logits at every position of a 256-token prompt against
    token-by-token decoding within 5e-4, the reference's own bound, on
    xlstm-350m at 8 layers (7 mLSTM, 1 sLSTM), zamba2-1.2b at 6 (5 Mamba2,
    1 shared attention), arctic-480b at full width, 1 layer, 8 experts
    and capacity factor 8 (no assignment dropped: the reference test's
    setting), qwen1.5-110b at 2 layers, deepseek-v2-236b at 2 (the
    dense layer and one MoE layer) with 8 experts and capacity factor 8
    (MLA's absorbed decode against its decompressed prefill), whisper-small
    at 6 decoder layers against 1500 frames (decoding with the encoder's
    output) and qwen2-vl-72b at 2 layers, text only (decoding feeds no
    vision embeddings).  (c) each reduced config in float32 from the same
    weights on the card (kernels) and on the CPU (plain versions), with
    frames (whisper) or vision embeddings and grid positions (qwen2-vl):
    logits of a prefill of 2 x 40 tokens and of 40 decode steps within
    1e-4, the load-balance loss within 1e-5 relative."""
    import torch
    from repro_torch import interop
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M

    out = {"b_max_abs_diff": {}, "c_max_abs_diff": {}}
    for arch, layers in FAMILY_DECODE_LAYERS.items():
        cfg = dataclasses.replace(get_arch(arch), num_layers=layers,
                                  dtype="float32")
        if cfg.moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, num_experts=8, capacity_factor=8.0))
        gen = torch.Generator(device=dev).manual_seed(1)
        params = M.init_params(cfg, gen, dev)
        tokens = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                               device=dev)
        batch, enc = {"tokens": tokens}, None
        if cfg.encoder_layers:
            batch["frames"] = 0.1 * torch.randn(
                1, cfg.encoder_seq, cfg.d_model, generator=gen, device=dev)
            enc = M.encode(params.encoder, cfg, batch["frames"])
        full, _ = M.forward(params, cfg, batch)
        state = M.init_decode_state(cfg, 1, tokens.shape[1], device=dev)
        err = torch.zeros((), device=dev)
        for t in range(tokens.shape[1]):
            step, state = M.decode_step(params, cfg, tokens[:, t:t + 1],
                                        state, enc_out=enc)
            err = torch.maximum(err, (step[:, 0] - full[:, t]).abs().max())
        err = float(err)
        if not err <= 5e-4:
            raise AssertionError(f"{arch} at {layers} layers: prefill and "
                                 f"decode logits differ by {err} > 5e-4")
        out["b_max_abs_diff"][arch] = err
        del params, full, state, batch, enc
        gc.collect()
        torch.cuda.empty_cache()

    for arch, *_ in FAMILIES:
        cfg = get_arch(arch).reduced()
        lm = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        on_card = interop.lm_params(cfg, interop.lm_tree(lm), dev)
        g = torch.Generator().manual_seed(4)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                         generator=g)}
        if cfg.encoder_layers:
            batch["frames"] = 0.1 * torch.randn(
                2, cfg.encoder_seq, cfg.d_model, generator=g)
        if cfg.vision_tokens:
            batch["vision_embeds"] = 0.02 * torch.randn(
                2, cfg.vision_tokens, cfg.d_model, generator=g)
            batch["positions"] = _grid_positions(2, 40, cfg.vision_tokens,
                                                 "cpu")
        logits, diffs = {}, []
        for name, model, b in (("cpu", lm, batch),
                               ("cuda", on_card,
                                {k: v.to(dev) for k, v in batch.items()})):
            full, aux = M.forward(model, cfg, b)
            enc = (M.encode(model.encoder, cfg, b["frames"])
                   if cfg.encoder_layers else None)
            toks = b["tokens"]
            state = M.init_decode_state(cfg, 2, 48, device=toks.device)
            steps = []
            for t in range(toks.shape[1]):
                step, state = M.decode_step(model, cfg, toks[:, t:t + 1],
                                            state, enc_out=enc)
                steps.append(step[:, 0])
            logits[name] = (full.cpu(), torch.stack(steps, 1).cpu(),
                            float(aux["load_balance_loss"]))
        for got, want in zip(logits["cuda"][:2], logits["cpu"][:2]):
            diffs.append(float((got - want).abs().max()))
        if not max(diffs) <= 1e-4 or not _close(
                logits["cuda"][2], logits["cpu"][2], 1e-5):
            raise AssertionError(
                f"{arch} reduced: card and CPU differ: prefill/decode "
                f"{diffs}, load-balance loss {logits['cuda'][2]} vs "
                f"{logits['cpu'][2]}")
        out["c_max_abs_diff"][arch] = max(diffs)
    return out


def _close(a, b, rel):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-30)


def _max_diff(a, b) -> float:
    if len(a) != len(b):
        raise AssertionError("curve grids differ")
    diff = 0.0
    for row_a, row_b in zip(a, b):
        if len(row_a) != len(row_b) or not all(
                math.isfinite(v) for v in row_a + row_b):
            raise AssertionError("malformed or non-finite curve")
        diff = max(diff, max(abs(x - y) for x, y in zip(row_a, row_b)))
    return diff


def check_against_cpu(iters: int = 60):
    """Phase 4: the same short upper_bound run on the GPU and on the CPU
    (plain versions) must agree: characters to 1e-6 relative, curves to
    1e-5.  ECD-PSGD's floor turns an ulp of summation order into a whole
    quantum, so its curves are held to the reference's envelope for
    execution-order differences, the 2e-2 class of tests/test_core.py
    (ECD-PSGD divergence envelope)."""
    from repro_torch.experiments import registry, runner
    spec = registry.get_spec("upper_bound", iters=iters)
    gpu = runner.run_sweep(spec, device="cuda", use_cache=False)
    cpu = runner.run_sweep(spec, device="cpu", use_cache=False)
    for name, info in cpu["datasets"].items():
        for k, want in info["characters"].items():
            got = gpu["datasets"][name]["characters"][k]
            exact = k in ("n", "d", "diversity", "diversity_ratio")
            if (got != want) if exact else not _close(got, want, 1e-6):
                raise AssertionError(f"{name}.{k}: gpu {got} cpu {want}")
    report = {}
    for key, jc in cpu["jobs"].items():
        jg = gpu["jobs"][key]
        tol = 2e-2 if jc["algorithm"] == "ecd_psgd" else 1e-5
        diff = _max_diff(jg["losses"], jc["losses"])
        if diff > tol:
            raise AssertionError(f"{key}: GPU and CPU curves differ by "
                                 f"{diff} > {tol}")
        report[key] = {"max_abs_diff": diff, "tol": tol,
                       "measured_m_max_gpu_cpu": [jg.get("measured_m_max"),
                                                  jc.get("measured_m_max")]}
    return report


def expected_launches(spec):
    """Launches of K1, K2 and the fused ECD-PSGD tail that a run of
    ``spec`` must make, counted from the spec (every job healthy): K1
    three times a dataset (sparsity, density, Omega) and once a predicted
    job of the Hogwild! or SVRG kind (Omega); K2 twice a dataset (C_sim,
    LS_sync) and once more with ``measure_csim``; the fused tail once a
    step of each ECD-PSGD bucket; K3 and K4, which it replaces, never."""
    from repro_torch.core.algorithms import base as alg_base
    from repro_torch.experiments import engine
    omega = sum(1 for job in spec.jobs if job.predict and alg_base
                .get_algorithm(job.algorithm).predictor in ("hogwild",
                                                            "svrg"))
    ecd = sum(1 for job in spec.jobs if job.algorithm == "ecd_psgd")
    return {"l0_rows": 3 * len(spec.datasets) + omega,
            "l0_shift_sum": (2 + (spec.measure_csim > 0))
            * len(spec.datasets),
            "ecd_compress_rows": ecd * len(engine._buckets(spec.ms))
            * spec.iters,
            "quantize_rows": 0, "dequantize_rows": 0}


def run_specs():
    """Phase specs: each spec of ``NEW_SPECS`` that phase report does not
    run, on the card at its published size, no cache, with the launch counters set to 0 just before and read
    just after; every job must finish ``ok`` and every count must equal
    :func:`expected_launches`.  Prints one line per spec and returns the
    per-spec launch counts."""
    import torch
    from repro_torch import kernels
    from repro_torch.experiments import registry, runner
    launches_by_spec = {}
    for name in (s for s in NEW_SPECS if s not in REPORT_SPECS):
        spec = registry.get_spec(name)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = runner.run_sweep(spec, device="cuda", use_cache=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        want = expected_launches(spec)
        jobs = {key: [jr["status"], jr.get("measured_m_max"),
                      jr.get("predicted", {}).get("predicted_m_max")]
                for key, jr in result["jobs"].items()}
        got = {k: launches[k] for k in want}
        timings = {k: round(v, 4) for k, v in result["timings"].items()}
        print(f"  spec {name}: wall_s={wall:.3f} iters={spec.iters} "
              f"ms={list(spec.ms)} seeds={spec.n_seeds} "
              f"datasets={len(spec.datasets)} jobs={len(spec.jobs)} "
              f"launches={json.dumps(got)} expected={json.dumps(want)} "
              f"[status, measured_m_max, predicted_m_max] "
              f"{json.dumps(jobs)} timings_s {json.dumps(timings)}",
              flush=True)
        bad = [key for key, (status, _, _) in jobs.items() if status != "ok"]
        if bad:
            raise AssertionError(f"{name}: jobs not ok: {bad}")
        if spec.epsilon is not None and any(
                "measured_m_max" not in jr for jr in result["jobs"].values()):
            raise AssertionError(f"{name}: a job has no measured m_max")
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want}")
        launches_by_spec[name] = got
    return launches_by_spec


def check_specs_against_cpu(iters: int = 60):
    """Phase specs-vs-cpu: each spec of ``NEW_SPECS`` at its quick size and
    ``iters`` iterations on the GPU and on the CPU (plain versions) in
    this process: characters and C_sim to 1e-6 relative with n, d,
    diversity and diversity_ratio exact; every seed's curves to 1e-5
    (ECD-PSGD to the reference's 2e-2 envelope, as phase 4); statuses,
    measured and predicted m_max equal."""
    from repro_torch.experiments import registry, runner
    report = {}
    for name in NEW_SPECS:
        spec = registry.get_spec(name, quick=True, iters=iters)
        gpu = runner.run_sweep(spec, device="cuda", use_cache=False)
        cpu = runner.run_sweep(spec, device="cpu", use_cache=False)
        char_rel = 0.0
        for ds, info in cpu["datasets"].items():
            mine = gpu["datasets"][ds]
            pairs = [(k, mine["characters"][k], v)
                     for k, v in info["characters"].items()]
            if "csim" in info:
                pairs.append(("csim", mine["csim"], info["csim"]))
            for k, got, want in pairs:
                exact = k in ("n", "d", "diversity", "diversity_ratio")
                if (got != want) if exact else not _close(got, want, 1e-6):
                    raise AssertionError(f"{name} {ds}.{k}: gpu {got} cpu "
                                         f"{want}")
                if not exact:
                    char_rel = max(char_rel, abs(got - want)
                                   / max(abs(got), abs(want), 1e-30))
        diffs = {"ecd_psgd": 0.0, "faulted": 0.0, "other": 0.0}
        jobs = {job.key: job for job in spec.jobs}
        for key, jc in cpu["jobs"].items():
            jg = gpu["jobs"][key]
            kind = ("ecd_psgd" if jc["algorithm"] == "ecd_psgd" else
                    "faulted" if "fault" in jobs[key].kwargs else "other")
            tol = 2e-2 if kind == "ecd_psgd" else 1e-5
            # (m, seed, eval) curves, one seed where the spec has one
            diff = max(_max_diff(a, b) for a, b in zip(
                *(j.get("losses_seeds", [[c] for c in j["losses"]])
                  for j in (jg, jc))))
            if diff > tol:
                raise AssertionError(f"{name} {key}: GPU and CPU curves "
                                     f"differ by {diff} > {tol}")
            diffs[kind] = max(diffs[kind], diff)
            for field in ("status", "measured_m_max"):
                if jg.get(field) != jc.get(field):
                    raise AssertionError(f"{name} {key}: {field} gpu "
                                         f"{jg.get(field)} cpu "
                                         f"{jc.get(field)}")
            pred = [j.get("predicted", {}).get("predicted_m_max")
                    for j in (jg, jc)]
            if pred[0] != pred[1]:
                raise AssertionError(f"{name} {key}: predicted m_max {pred}")
        report[name] = {"jobs": len(cpu["jobs"]), "max_char_rel": char_rel,
                        "max_curve_diff": diffs}
    return report


def _recording_sweeps(records):
    """A stand-in for ``runner.run_sweep`` that records, per spec, the wall
    time (synchronised at both ends), the launches made and the result,
    reading the counters without resetting them."""
    import torch
    from repro_torch import kernels
    from repro_torch.experiments import runner
    real = runner.run_sweep

    def run_sweep(spec, **kw):
        dev = torch.device(kw.get("device", "cuda"))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        result = real(spec, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        after = kernels.launch_counts()
        records[spec.name] = {
            "wall_s": time.perf_counter() - t0, "result": result,
            "launches": {k: after[k] - before[k] for k in after}}
        return result
    return real, run_sweep


def _run_report(argv):
    """``analysis.report.main(argv)`` with every sweep recorded; returns
    the per-spec records."""
    from repro_torch.analysis import report
    from repro_torch.experiments import runner
    records = {}
    real, recording = _recording_sweeps(records)
    runner.run_sweep = recording
    try:
        if report.main(argv) != 0:
            raise AssertionError(f"report.main({argv}) failed")
    finally:
        runner.run_sweep = real
    return records


def run_report(root):
    """Phase report: ``python -m repro_torch.analysis.report`` at the
    published sizes with its default 8 seeds, ``--force``, into a fresh
    cache, with the launch counters set to 0 just before and read just
    after: K1, K2 and the fused tail must launch exactly
    `expected_launches` summed over the four specs, K3/K4 never; every
    job ``ok``; section 6 must attribute at least 95 % of the last
    computed sweep.  Then the grid of critical_params' first job, 100
    iterations at 8 seeds with its dataset made beforehand, runs under
    ``torch.profiler``: is the report's simulation host-paced?"""
    import re
    import torch
    from repro_torch import kernels
    from repro_torch.analysis import report
    from repro_torch.experiments import registry
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        out = os.path.join(tmp, "report.md")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        records = _run_report(["--force", "--cache-dir",
                               os.path.join(tmp, "cache"), "--out", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        with open(out) as f:
            md = f.read()
    seeds = report.DEFAULT_SEEDS["full"]
    want = {k: 0 for k in SWEEP_KERNELS + FUSED_AWAY}
    per_spec = {}
    for name in REPORT_SPECS:
        spec = registry.get_spec(name, seeds=seeds)
        expected = expected_launches(spec)
        for k, v in expected.items():
            want[k] += v
        rec = records[name]
        got = {k: rec["launches"][k] for k in expected}
        if got != expected:
            raise AssertionError(f"report {name}: launches {got}, "
                                 f"expected {expected}")
        statuses = {key: jr["status"]
                    for key, jr in rec["result"]["jobs"].items()}
        bad = [k for k, st in statuses.items() if st != "ok"]
        if bad:
            raise AssertionError(f"report {name}: jobs not ok: {bad}")
        per_spec[name] = {"wall_s": rec["wall_s"], "jobs": len(statuses),
                          "seeds": spec.n_seeds, "iters": spec.iters,
                          "launches": got}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"report: launches {got}, expected {want}")
    m = re.search(r"wall-clock, (\d+)% attributed", md)
    if m is None or int(m.group(1)) < 95:
        raise AssertionError(f"report section 6 attributes "
                             f"{m.group(1) if m else 'nothing'} %")
    section6 = md[md.index("## 6."):].strip().splitlines()
    from repro_torch.experiments import engine
    from repro_torch.experiments import spec as spec_mod
    spec = registry.get_spec("critical_params", seeds=seeds)
    job = spec.jobs[0]
    ds = spec.datasets[job.dataset]
    tr, te = spec_mod.split_dataset(ds, spec_mod.build_dataset(ds, "cuda"),
                                    spec.split_seed)
    prof = _profile(lambda: engine.sweep(
        job.algorithm, tr, te, spec.ms, iters=100, eval_every=10,
        problem=job.problem, n_seeds=spec.n_seeds, **job.kwargs), top=5)
    if isinstance(prof, dict):
        prof = {"job": job.key, "iters": 100, **prof}
    return {"wall_s": wall, "launches": got, "per_spec": per_spec,
            "profile_critical_params_job": prof,
            "section6_coverage_pct": int(m.group(1)),
            "section6": [ln for ln in section6 if ln.startswith("|")]}


def _mmax_readouts(result):
    """Every m_max and CI the report renders for a result: per job the
    bootstrap (point, lo, hi), the fitted law's (point, lo, hi) and the
    prediction."""
    from repro_torch.analysis import fit, stats
    from repro_torch.experiments import runner
    eps = result["spec"].get("epsilon") or {}
    out = {}
    for key, jr in result["jobs"].items():
        if not runner.job_is_healthy(jr):
            out[key] = jr["status"]
            continue
        boot = stats.mmax_bootstrap(jr, probe_m=eps.get("probe_m"),
                                    frac=eps.get("frac"))
        law = fit.fit_job(jr, probe_m=eps.get("probe_m"),
                          frac=eps.get("frac"))
        out[key] = [boot["m_max"], boot["lo"], boot["hi"],
                    law["fitted_m_max"], law["fitted_m_max_lo"],
                    law["fitted_m_max_hi"], jr.get("measured_m_max"),
                    (jr.get("predicted") or {}).get("predicted_m_max")]
    return out


def check_report_against_cpu(root):
    """Phase report-vs-cpu: the report at ``--quick --iters 60 --n 256
    --seeds 2`` on the card and on the CPU, each into a fresh cache: every
    measured, fitted and predicted m_max and every CI equal; every seed's
    curves within 1e-5 (ECD-PSGD 2e-2)."""
    args = ["--quick", "--iters", "60", "--n", "256", "--seeds", "2"]
    runs = {}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        for dev in ("cuda", "cpu"):
            runs[dev] = _run_report(args + [
                "--device", dev, "--force", "--cache-dir",
                os.path.join(tmp, dev), "--out",
                os.path.join(tmp, f"{dev}.md")])
    report = {}
    for name in REPORT_SPECS:
        gpu, cpu = (runs[d][name]["result"] for d in ("cuda", "cpu"))
        readouts = [_mmax_readouts(r) for r in (gpu, cpu)]
        if readouts[0] != readouts[1]:
            raise AssertionError(f"report-vs-cpu {name}: m_max / CI gpu "
                                 f"{readouts[0]} cpu {readouts[1]}")
        diffs = {"ecd_psgd": 0.0, "other": 0.0}
        for key, jc in cpu["jobs"].items():
            jg = gpu["jobs"][key]
            kind = "ecd_psgd" if jc["algorithm"] == "ecd_psgd" else "other"
            diff = max(_max_diff(a, b) for a, b in zip(
                jg["losses_seeds"], jc["losses_seeds"]))
            if diff > (2e-2 if kind == "ecd_psgd" else 1e-5):
                raise AssertionError(f"report-vs-cpu {name} {key}: curves "
                                     f"differ by {diff}")
            diffs[kind] = max(diffs[kind], diff)
        report[name] = {"jobs": len(cpu["jobs"]), "max_curve_diff": diffs,
                        "gpu_wall_s": runs["cuda"][name]["wall_s"],
                        "cpu_wall_s": runs["cpu"][name]["wall_s"]}
    return report


def run_trace(root, golden):
    """Phase trace: ``python -m repro_torch.experiments.run --spec
    upper_bound --trace F --metrics --serve 0 -v`` on the card in a child
    process, forced into a fresh cache so that it stores an artifact; one
    ``/flight`` poll through ``telemetry.watch(..., max_polls=1)`` once
    its first job has started, which must show the sweep's events; then ``python -m repro_torch.telemetry --summarize F
    --min-coverage 0.95`` must exit 0, every ``bucket`` span must hold an
    ``execute`` span, and the artifact must equal ``golden``, phase
    upper_bound's untraced artifact, byte for byte."""
    import io
    from repro_torch.telemetry import __main__ as telemetry_cli
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        path = os.path.join(tmp, "trace.json")
        cache = os.path.join(tmp, "cache")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.experiments.run", "--spec",
             "upper_bound", "--cache-dir", cache, "--force", "--trace", path,
             "--metrics", "--serve", "0", "-v"], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            head = []
            url = None
            # poll once the first job runs (-v prints its start), so that
            # the poll sees the sweep's progress events
            for line in proc.stdout:
                head.append(line.rstrip())
                if line.startswith("observability plane at "):
                    url = line.split()[3]
                elif url is not None and line.startswith("[upper_bound]"):
                    break
            if url is None:
                raise AssertionError(f"no observability plane: {head}")
            polled = io.StringIO()
            rc_watch = telemetry_cli.watch(url, interval=0.1, max_polls=1,
                                           out=polled)
            rest = proc.communicate(timeout=900)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        wall = time.perf_counter() - t0
        if proc.returncode != 0 or rc_watch != 0:
            raise AssertionError(f"traced run rc={proc.returncode} watch "
                                 f"rc={rc_watch}: {rest[-2000:]}")
        lines = head + rest.splitlines()
        summary = subprocess.run(
            [sys.executable, "-m", "repro_torch.telemetry", "--summarize",
             path, "--min-coverage", "0.95"], cwd=root, env=env,
            capture_output=True, text=True, timeout=300)
        if summary.returncode != 0:
            raise AssertionError(f"--summarize failed: {summary.stdout} "
                                 f"{summary.stderr}")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        artifacts = [n for n in os.listdir(cache) if n.endswith(".json")]
        with open(os.path.join(cache, artifacts[0]), "rb") as f:
            stored = f.read()
    flight = polled.getvalue()
    if "sweep_started" not in flight or "job_started" not in flight:
        raise AssertionError(f"the /flight poll missed the sweep: {flight}")
    if len(artifacts) != 1 or stored != golden:
        raise AssertionError("the traced run's artifact differs from the "
                             "untraced one's")
    buckets = [e for e in events if e["name"] == "bucket"]
    executes = [e for e in events if e["name"] == "execute"]
    orphans = [b for b in buckets if not any(
        x["tid"] == b["tid"] and x["args"]["depth"] == b["args"]["depth"] + 1
        and x["ts"] >= b["ts"] - 1e-3
        and x["ts"] + x["dur"] <= b["ts"] + b["dur"] + 1e-3
        for x in executes)]
    if not buckets or orphans:
        raise AssertionError(f"{len(orphans)} of {len(buckets)} bucket "
                             f"spans have no execute child")
    metric_lines = [ln for ln in lines if ln.startswith(
        ("repro_engine_", "repro_sweep_computes", "repro_cache_stores"))]
    return {"wall_s": wall, "spans": len(events), "buckets": len(buckets),
            "flight_lines": len(flight.splitlines()),
            "summary": summary.stdout.strip().splitlines(),
            "metrics": metric_lines, "artifact_bytes": len(stored)}


def run_mesh():
    """Phase mesh: upper_bound's datasets at 120 iterations and 2 seeds
    sharded over ``from_devices([cuda:0] * 4)`` against ``mesh=None``:
    every curve within 1e-5 (ECD-PSGD 2e-2), every m_max equal; a
    one-device mesh bit-exact.  Then racing Hogwild! at m = 4 on 4 shards,
    ``sync_every=1``, on the spec's Hogwild! dataset, within 1e-5 of the
    engine's staleness oracle with the predicted ``psum_rounds``;
    ``sync_every=4`` beside it."""
    import torch
    from repro_torch import kernels
    from repro_torch.distributed import from_devices, run_hogwild_sharded
    from repro_torch.experiments import engine, registry, runner
    from repro_torch.experiments import spec as spec_mod
    dev = torch.device("cuda", 0)
    spec = registry.get_spec("upper_bound", iters=120, seeds=2)
    walls, runs = {}, {}
    for name, mesh in (("none", None), ("shards4", from_devices([dev] * 4)),
                       ("one", from_devices([dev]))):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        runs[name] = runner.run_sweep(spec, device=dev, use_cache=False,
                                      mesh=mesh)
        torch.cuda.synchronize()
        walls[name] = {"wall_s": time.perf_counter() - t0,
                       "launches": {k: v for k, v in
                                    kernels.launch_counts().items() if v}}
    base = runs["none"]
    if not runs["shards4"]["execution"]["sharded"]:
        raise AssertionError("the 4-shard run was not sharded")
    diffs = {}
    for key, jb in base["jobs"].items():
        js, jo = runs["shards4"]["jobs"][key], runs["one"]["jobs"][key]
        tol = 2e-2 if jb["algorithm"] == "ecd_psgd" else 1e-5
        diff = max(_max_diff(a, b) for a, b in zip(js["losses_seeds"],
                                                    jb["losses_seeds"]))
        if diff > tol:
            raise AssertionError(f"mesh {key}: 4 shards differ by {diff}")
        if js.get("measured_m_max") != jb.get("measured_m_max") or \
                js.get("predicted") != jb.get("predicted"):
            raise AssertionError(f"mesh {key}: m_max changed")
        if jo["losses_seeds"] != jb["losses_seeds"]:
            raise AssertionError(f"mesh {key}: one device is not bit-exact")
        diffs[key] = diff
    job = next(j for j in spec.jobs if j.algorithm == "hogwild")
    ds = spec.datasets[job.dataset]
    tr, te = spec_mod.split_dataset(ds, spec_mod.build_dataset(ds, dev),
                                    spec.split_seed)
    kw = dict(iters=1200, eval_every=100, gamma=job.kwargs["gamma"])
    oracle = engine.sweep("hogwild", tr, te, [4], **kw)["losses"][0]
    race = {}
    for sync_every in (1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run_hogwild_sharded(tr, te, m=4, mesh=from_devices([dev] * 4),
                                sync_every=sync_every, **kw)
        wall = time.perf_counter() - t0
        predicted = (kw["iters"] // 4) // sync_every + kw["iters"] // 100
        if r["psum_rounds"] != predicted:
            raise AssertionError(f"psum_rounds {r['psum_rounds']} != "
                                 f"{predicted}")
        diff = max(abs(a - b) for a, b in zip(r["losses"], oracle))
        race[f"sync_every={sync_every}"] = {
            "wall_s": wall, "psum_rounds": r["psum_rounds"],
            "max_diff_vs_oracle": diff, "final_loss": r["losses"][-1]}
    if race["sync_every=1"]["max_diff_vs_oracle"] > 1e-5:
        raise AssertionError(f"race vs oracle {race}")
    return {"runs": walls, "max_curve_diff": diffs, "race": race}


# phase service: the analytic batch (six higgs_like sets, one realsim_like
# set past the 512 x 64 envelope, one raw X too small to measure) and the
# two escalations, each shared by four concurrent requests
SERVICE_BATCH = (
    [{"dataset": {"generator": "higgs_like", "kwargs": {"n": 2000, "d": 28},
                  "seed": s}, "request_id": f"higgs-{s}"} for s in range(6)]
    + [{"dataset": {"generator": "realsim_like",
                    "kwargs": {"n": 2000, "d": 400, "density": 0.05}},
        "request_id": "realsim"},
       {"X": [[1.0, 2.0, 3.0]], "request_id": "raw-invalid"}])
SERVICE_ESCALATIONS = (
    {"dataset": {"generator": "higgs_like", "kwargs": {"n": 4000, "d": 28}},
     "algorithm": "ecd_psgd", "escalate": True},
    {"dataset": {"generator": "realsim_like",
                 "kwargs": {"n": 2000, "d": 400, "density": 0.05}},
     "algorithm": "hogwild", "kwargs": {"gamma": 0.05}, "escalate": True})
STRATEGIES = ("hogwild", "sync", "dadm", "momentum", "local_sgd", "svrg")


def _http(url, payload=None):
    """GET (no payload) or POST a JSON payload to the local server; returns
    the decoded JSON body (or the text of ``/metrics``)."""
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        body = r.read().decode()
    return body if url.split("?")[0].endswith("/metrics") else \
        json.loads(body)


def _count_deltas(fn):
    """Launch counts of ``fn()`` with every counter set to 0 just before
    and read just after (the device synchronised on both sides)."""
    import torch
    from repro_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def run_service(root):
    """Phase service: `ServiceServer(AdvisorService(device="cuda"))` on an
    ephemeral port of this host, with a fresh cache directory.

    Analytic batch: ``POST /probe_batch`` of `SERVICE_BATCH` three times;
    statuses and tiers as expected, K1 launched twice per batch (one
    launch for the slot batch, one for the oversize fallback), K2 and the
    fused tail never, every integer m_max equal to the CPU service's for
    the same requests.  Escalations: eight threads ``POST /probe`` the two
    `SERVICE_ESCALATIONS` four times each; exactly two sweeps computed,
    one artifact per fingerprint and the same artifact for every waiter;
    K1, K2 and fused-tail launches equal to `expected_launches` of the two
    escalation specs plus one K1 launch per request's measurement; the
    measured and predicted m_max equal to the CPU port's runs of the same
    specs, curves within 1e-5 (ECD-PSGD 2e-2).  ``GET /metrics`` must
    parse under the strict parser."""
    import threading
    import torch
    from repro_torch.experiments import runner
    from repro_torch.service.api import AdvisorService
    from repro_torch.service.http import ServiceServer, decode_probe_request
    from repro_torch.telemetry import trace
    from repro_torch.telemetry.metrics import parse_prometheus_text

    def _spans_ms(fn):
        """Wall ms of ``fn()`` and the ms of each span name it traced."""
        tracer = trace.start()
        t0 = time.perf_counter()
        try:
            fn()
        finally:
            trace.stop()
        phases = trace.phase_breakdown(tracer.events)["phases"]
        return {"wall": (time.perf_counter() - t0) * 1e3,
                **{name: p["total_us"] / 1e3 for name, p in phases.items()}}

    report = {}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        cache_dir = os.path.join(tmp, "cache")
        svc = AdvisorService(device="cuda", cache_dir=cache_dir)
        cpu = AdvisorService(device="cpu", cache_dir=os.path.join(tmp, "cpu"))
        with ServiceServer(svc) as srv:
            batch_ms, batch_launches = [], None
            for _ in range(3):
                t0 = time.perf_counter()
                resp, launches = _count_deltas(lambda: _http(
                    srv.url + "/probe_batch", {"requests": SERVICE_BATCH}))
                batch_ms.append((time.perf_counter() - t0) * 1e3)
                got = [(r["status"], r["tier"]) for r in resp["responses"]]
                if got != [("ok", "analytic")] * 7 + [("invalid", None)]:
                    raise AssertionError(f"analytic batch answered {got}")
                counts = {k: launches[k] for k in SWEEP_KERNELS}
                if counts != {"l0_rows": 2, "l0_shift_sum": 0,
                              "ecd_compress_rows": 0}:
                    raise AssertionError(f"analytic batch launches {counts}")
                batch_launches = batch_launches or counts
            on_cpu = cpu.probe_batch([decode_probe_request(p)
                                      for p in SERVICE_BATCH])
            for g, c in zip(resp["responses"], on_cpu):
                if (g["status"], g["tier"]) != (c.status, c.tier):
                    raise AssertionError(f"{g['request_id']}: tiers differ")
                if c.tier is None:
                    continue
                for strat in STRATEGIES:
                    a = g["report"][strat]["predicted_m_max"]
                    b = c.report[strat]["predicted_m_max"]
                    if a != b:
                        raise AssertionError(f"{g['request_id']} {strat}: "
                                             f"m_max gpu {a} cpu {b}")
            report["analytic_batch_ms"] = batch_ms
            # where a warm batch's time goes: the device's busy share
            # under torch.profiler, then the service's own spans
            report["analytic_batch_profile"] = _profile(lambda: _http(
                srv.url + "/probe_batch", {"requests": SERVICE_BATCH}), 5)
            report["analytic_batch_spans_ms"] = _spans_ms(lambda: _http(
                srv.url + "/probe_batch", {"requests": SERVICE_BATCH}))
            report["analytic_m_max"] = {
                r["request_id"]: {s: r["report"][s]["predicted_m_max"]
                                  for s in STRATEGIES}
                for r in resp["responses"] if r["tier"]}

            specs = [svc.tiers.escalation_spec(decode_probe_request(p))
                     for p in SERVICE_ESCALATIONS]
            before = runner.SWEEP_COMPUTES
            answers = [None] * 8
            barrier = threading.Barrier(8)

            def ask(i):
                barrier.wait(timeout=60)
                t0 = time.perf_counter()
                body = _http(srv.url + "/probe?full=1",
                             SERVICE_ESCALATIONS[i % 2])
                answers[i] = (body, time.perf_counter() - t0)

            def escalate():
                threads = [threading.Thread(target=ask, args=(i,))
                           for i in range(8)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=900)
                if any(t.is_alive() for t in threads) or None in answers:
                    raise AssertionError("an escalation did not answer")

            tracer = trace.start()
            try:
                _, launches = _count_deltas(escalate)
            finally:
                trace.stop()
            report["escalation_spans_ms"] = {
                name: round(p["total_us"] / 1e3, 3) for name, p in
                trace.phase_breakdown(tracer.events)["phases"].items()}
            computes = runner.SWEEP_COMPUTES - before
            if computes != 2:
                raise AssertionError(f"{computes} sweeps computed, not 2")
            want = {k: 8 if k == "l0_rows" else 0 for k in SWEEP_KERNELS}
            for sp in specs:
                for k, v in expected_launches(sp).items():
                    if k in want:
                        want[k] += v
            got = {k: launches[k] for k in SWEEP_KERNELS}
            if got != want or any(launches[k] for k in FUSED_AWAY):
                raise AssertionError(f"escalation launches {launches}, "
                                     f"expected {want}")
            report["escalation_wall_s"] = [w for _, w in answers]
            arts = sorted(n for n in os.listdir(cache_dir)
                          if n.endswith(".json"))
            if len(arts) != 2:
                raise AssertionError(f"cache holds {arts}")
            for k, sp in enumerate(specs):
                group = [a for a, _ in answers[k::2]]
                blobs = {json.dumps(a["escalation"]["artifact"],
                                    sort_keys=True) for a in group}
                esc = group[0]["escalation"]
                if len(blobs) != 1 or any(
                        a["tier"] != "measured" or a["status"] != "ok"
                        or a["escalation"]["status"] != "ok" for a in group):
                    raise AssertionError(f"{sp.name}: waiters differ")
                ref = runner.run_sweep(sp, device="cpu", use_cache=False)
                job, ref_job = (esc["artifact"]["jobs"][esc["job_key"]],
                                ref["jobs"][esc["job_key"]])
                tol = 2e-2 if sp.jobs[0].algorithm == "ecd_psgd" else 1e-5
                diff = _max_diff(job["losses"], ref_job["losses"])
                pred = [j["predicted"]["predicted_m_max"]
                        for j in (job, ref_job)]
                if diff > tol or pred[0] != pred[1] or \
                        job["measured_m_max"] != ref_job["measured_m_max"]:
                    raise AssertionError(
                        f"{sp.name}: gpu vs cpu curves {diff} (tol {tol}), "
                        f"measured {job['measured_m_max']} / "
                        f"{ref_job['measured_m_max']}, predicted {pred}")
                report[sp.jobs[0].algorithm] = {
                    "measured_m_max": job["measured_m_max"],
                    "predicted_m_max": pred[0], "max_abs_diff_vs_cpu": diff,
                    "tol": tol, "cache_hits": sum(
                        a["escalation"]["cache_hit"] for a in group)}
            report["sweep_computes"] = computes
            report["ecd_escalation_sweep_profile"] = _profile(
                lambda: runner.run_sweep(specs[0], device="cuda",
                                         use_cache=False), 5)

            text = _http(srv.url + "/metrics")
            fams = parse_prometheus_text(text)
            report["metrics"] = {
                name + (json.dumps(labels, sort_keys=True) if labels else ""):
                    value
                for fam, body in fams.items()
                if fam.startswith(("repro_service_", "repro_sweep_"))
                for name, labels, value in body["samples"]}
        torch.cuda.synchronize()
    return report, {"analytic_batch": batch_launches, "escalations": got}


def check_robustness(root):
    """Phase service, robustness on the card, at a quick size: a job made
    to raise ``torch.cuda.OutOfMemoryError`` once ends ``retried:1`` and
    its artifact equals a clean run's byte for byte once that status reads
    "ok" again; a run cut after its first job resumes from the journal
    (``job_replayed``) into a byte-identical artifact; a mutated artifact
    is quarantined to ``.corrupt``."""
    import warnings
    import torch
    from repro_torch.experiments import cache as artifact_cache
    from repro_torch.experiments import engine, runner
    from repro_torch.experiments.spec import (DatasetSpec, EpsilonSpec,
                                              JobSpec, SweepSpec,
                                              fingerprint)
    from repro_torch.telemetry import RECORDER

    spec = SweepSpec(
        name="smoke_robust", ms=(1, 2, 4), iters=60, eval_every=20,
        datasets={"d0": DatasetSpec("higgs_like", {"n": 512, "d": 28})},
        jobs=(JobSpec("minibatch", "d0"), JobSpec("ecd_psgd", "d0"),
              JobSpec("hogwild", "d0", {"gamma": 0.05}, predict=True)),
        epsilon=EpsilonSpec(probe_m=2, frac=0.7)).validate()
    fp = fingerprint(spec)
    real = engine.sweep

    def failing(exc, at):
        calls = []

        def sweep(*args, **kwargs):
            calls.append(1)
            if len(calls) == at:
                raise exc
            return real(*args, **kwargs)
        return sweep

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    out = {}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("clean", "retry", "cut")}
        golden = read(runner.run_sweep(spec, device="cuda",
                                       cache_dir=dirs["clean"])
                      ["cache"]["path"])
        try:
            engine.sweep = failing(torch.cuda.OutOfMemoryError(
                "CUDA out of memory (injected)"), 1)
            retried = runner.run_sweep(spec, device="cuda",
                                       cache_dir=dirs["retry"],
                                       retry_backoff_s=0.0)
        finally:
            engine.sweep = real
        statuses = [jr["status"] for jr in retried["jobs"].values()]
        if statuses != ["retried:1", "ok", "ok"]:
            raise AssertionError(f"retry statuses {statuses}")
        payload = json.loads(read(retried["cache"]["path"]))
        payload["jobs"]["minibatch/d0"]["status"] = "ok"
        payload["checksum"] = artifact_cache._payload_checksum(payload)
        if json.dumps(payload, default=float).encode() != golden:
            raise AssertionError("the retried artifact differs from a clean "
                                 "run's beyond its status")
        out["retry"] = statuses

        try:
            engine.sweep = failing(KeyboardInterrupt("cut"), 2)
            runner.run_sweep(spec, device="cuda", cache_dir=dirs["cut"])
            raise AssertionError("the cut run was not cut")
        except KeyboardInterrupt:
            pass
        finally:
            engine.sweep = real
        seq = RECORDER.snapshot()["seq"]
        resumed = runner.run_sweep(spec, device="cuda",
                                   cache_dir=dirs["cut"])
        replayed = [e["job"] for e in RECORDER.snapshot(since=seq)["events"]
                    if e["kind"] == "job_replayed"]
        if replayed != ["minibatch/d0"] or \
                read(resumed["cache"]["path"]) != golden:
            raise AssertionError(f"journal resume: replayed {replayed}, "
                                 f"identical bytes "
                                 f"{read(resumed['cache']['path']) == golden}")
        out["journal_replayed"] = replayed

        path = resumed["cache"]["path"]
        mutated = json.loads(read(path))
        mutated["jobs"]["minibatch/d0"]["losses"][0][0] += 1e-9
        with open(path, "w") as f:
            json.dump(mutated, f)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            hit = artifact_cache.load(dirs["cut"], spec.name, fp)
        if hit is not None or not os.path.exists(path + ".corrupt") or \
                not any("quarantined" in str(w.message) for w in caught):
            raise AssertionError("the mutated artifact was not quarantined")
        out["quarantined"] = os.path.basename(path) + ".corrupt"
    return out


# phase train: full-width gemma3-1b, batches of 8 x 1024 tokens from
# hmm_stream; phase gossip: 2 replicas on one fixed hmm_stream batch of
# 8 x 1024 tokens, 4 x 1024 a replica (as examples/gossip_ecd_psgd.py
# trains on a fixed batch), at the example's lr
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 1024, 3e-4
TRAIN_STEPS = {"sync": 10, "stale": 5}
# phase train-families: full-width, full-depth zamba2-1.2b and xlstm-350m,
# sync steps of 4 x 1024 tokens from hmm_stream
TRAIN_FAMILIES, TRAIN_FAMILY_BATCH, TRAIN_FAMILY_STEPS = (
    ("zamba2-1.2b", "xlstm-350m"), 4, 5)
GOSSIP_REPLICAS, GOSSIP_BATCH, GOSSIP_SEQ, GOSSIP_STEPS = 2, 8, 1024, 4
GOSSIP_LR = 2e-3
# K3/K4 at the gossip step's largest leaf (the tied embedding, 262144 x
# 1152) and at one stacked segment leaf (5 layers of 1152 x 6912), the
# R = 2 replicas as rows
GOSSIP_QUANT_TIMED = [(2, 262144 * 1152), (2, 5 * 1152 * 6912)]


def _falls(losses) -> bool:
    """The loss falls: the mean of the last three steps is below the
    first step's."""
    tail = losses[-3:]
    return all(math.isfinite(x) for x in losses) and \
        sum(tail) / len(tail) < losses[0]


def run_train(dev):
    """Phase train: ``train_loop`` at full-width gemma3-1b (bf16, AdamW,
    every layer recomputed in the backward) on hmm_stream batches, sync
    for ``TRAIN_STEPS["sync"]`` steps, then stale from fresh weights.  Per
    strategy: losses, each step's wall ms (host clock; the loop reads each
    loss, which waits for the step), the median after the first step,
    tokens/s, the step's model flops (``launch.analytic``) as a share of
    the bf16 peak, the peak memory.  Training runs no kernel of the port
    (the reference's arithmetic, as its train steps): every launch counter
    must stay 0.  One more sync step runs under ``torch.profiler``."""
    import statistics

    import torch
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.lm import LMConfig, hmm_stream
    from repro_torch.launch import analytic
    from repro_torch.launch.train import train_loop
    from repro_torch.train import steps as S

    cfg = get_arch("gemma3-1b")
    flops = analytic.model_flops(cfg, InputShape(
        "train", TRAIN_SEQ, TRAIN_BATCH, "train"))["model_flops"]
    report, prof = {}, None
    for strategy, n in TRAIN_STEPS.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        params, losses, step_ms = train_loop(
            cfg, steps=n, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            lr=TRAIN_LR, strategy=strategy, log_every=5, device=dev)
        launches = kernels.launch_counts()
        med = statistics.median(step_ms[1:])
        report[strategy] = {
            "steps": n, "losses": losses, "step_ms": step_ms,
            "median_step_ms": med,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (med / 1e3),
            "model_flops": flops,
            "bf16_peak_share": flops / (med / 1e3) / BF16_TENSOR_OPS_PER_S,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}
        if any(launches.values()):
            raise AssertionError(f"the {strategy} train path launched "
                                 f"kernels: {launches}")
        if not _falls(losses):
            raise AssertionError(f"{strategy}: the loss did not fall: "
                                 f"{losses}")
        if strategy == "sync":
            state = S.init_train_state(cfg, "sync", params=params)
            step = S.make_train_step(cfg, lr=TRAIN_LR)
            batch = next(hmm_stream(R.PRNGKey(1), LMConfig(
                cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH), 1, device=dev))
            step(state, batch)
            prof = _profile(lambda: step(state, batch)[1]["loss"].item())
            del state, step, batch
        del params
    return report, prof


def run_train_families(dev):
    """Phase train-families: ``train_loop`` at full-width, full-depth
    zamba2-1.2b and xlstm-350m (bf16, AdamW, every layer recomputed in
    the backward), ``TRAIN_FAMILY_STEPS`` sync steps each on hmm_stream
    batches of ``TRAIN_FAMILY_BATCH`` x 1024 tokens, with the counters set
    to 0 just before and read just after: training takes the reference's
    arithmetic, so no kernel may launch, and the loss must fall.  Per
    family: losses, each step's wall ms, the median after the first step,
    tokens/s, the model flops' share of the bf16 peak, the peak memory,
    and one more sync step under ``torch.profiler`` (xlstm's sLSTM token
    loop makes some 10^5 launches a step)."""
    import statistics

    import torch
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.lm import LMConfig, hmm_stream
    from repro_torch.launch import analytic
    from repro_torch.launch.train import train_loop
    from repro_torch.train import steps as S

    report = {}
    for arch in TRAIN_FAMILIES:
        cfg = get_arch(arch)
        flops = analytic.model_flops(cfg, InputShape(
            "train", TRAIN_SEQ, TRAIN_FAMILY_BATCH, "train"))["model_flops"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        params, losses, step_ms = train_loop(
            cfg, steps=TRAIN_FAMILY_STEPS, batch_size=TRAIN_FAMILY_BATCH,
            seq_len=TRAIN_SEQ, lr=TRAIN_LR, strategy="sync",
            log_every=TRAIN_FAMILY_STEPS, device=dev)
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        if any(launches.values()):
            raise AssertionError(f"{arch}: the train path launched kernels: "
                                 f"{launches}")
        if not _falls(losses):
            raise AssertionError(f"{arch}: the loss did not fall: {losses}")
        med = statistics.median(step_ms[1:])
        state = S.init_train_state(cfg, "sync", params=params)
        del params
        step = S.make_train_step(cfg, lr=TRAIN_LR)
        batch = next(hmm_stream(R.PRNGKey(1), LMConfig(
            cfg.vocab_size, TRAIN_SEQ, TRAIN_FAMILY_BATCH), 1, device=dev))
        prof = _profile(lambda: step(state, batch)[1]["loss"].item())
        report[arch] = {
            "layers": cfg.num_layers,
            "params": sum(p.numel() for p in state["model"].parameters()),
            "steps": TRAIN_FAMILY_STEPS,
            "batch": [TRAIN_FAMILY_BATCH, TRAIN_SEQ], "lr": TRAIN_LR,
            "losses": losses, "step_ms": step_ms, "median_step_ms": med,
            "tokens_per_s": TRAIN_FAMILY_BATCH * TRAIN_SEQ / (med / 1e3),
            "model_flops": flops,
            "bf16_peak_share": flops / (med / 1e3) / BF16_TENSOR_OPS_PER_S,
            "max_memory_allocated_gb": peak, "launches": launches,
            "profile": prof}
        del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return report


def _draw_ms(dev, shapes, replicas):
    """Host ms (ending in a synchronise) of the gossip step's uniform
    draws alone: two (replicas, numel) draws per leaf."""
    import torch
    from repro_torch import random as R
    keys = torch.stack([R.PRNGKey(i, device=dev) for i in range(replicas)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for numel in shapes:
        for _ in range(2):
            R.uniform(keys, (numel,))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def run_gossip(dev):
    """Phase gossip: ``make_gossip_step`` at full-width gemma3-1b (bf16)
    with ``GOSSIP_REPLICAS`` replicas stacked on the card, ``GOSSIP_STEPS``
    steps on one fixed hmm_stream batch, the counters set to 0 just before
    and read just after: K3 and K4 must each launch exactly twice per
    reference leaf a step (83 leaves), the fused tail and every other
    kernel never, and neither plain version of K3/K4 may run.  Reports
    losses, each step's ms, the uniform draws' share of a step (timed
    alone), the peak memory and the replicas' spread; the loss must
    fall."""
    import statistics

    import torch
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch import tree as T
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.lm import LMConfig, hmm_stream
    from repro_torch.kernels import quantize as kq
    from repro_torch.train import steps as S

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("gemma3-1b")
    state = S.init_gossip_state(
        cfg, GOSSIP_REPLICAS,
        generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    leaves = T.flatten(state["y"])[0]
    batch = next(hmm_stream(R.PRNGKey(2), LMConfig(
        cfg.vocab_size, GOSSIP_SEQ, GOSSIP_BATCH), 1, device=dev))
    step = S.make_gossip_step(cfg, replicas=GOSSIP_REPLICAS, lr=GOSSIP_LR)
    # the plain versions must not run on this path: count any call
    plain_calls = []
    real_plain = {name: getattr(kq, name) for name in (
        "quantize_rows_plain", "dequantize_rows_plain")}
    for name, fn in real_plain.items():
        setattr(kq, name, lambda *a, _f=fn, _n=name, **k: (
            plain_calls.append(_n), _f(*a, **k))[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_ms = [], []
    try:
        for _ in range(GOSSIP_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        for name, fn in real_plain.items():
            setattr(kq, name, fn)
    launches = kernels.launch_counts()
    if plain_calls:
        raise AssertionError(f"the gossip step ran plain versions on the "
                             f"card: {sorted(set(plain_calls))}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = 2 * len(leaves)
    want = {**{k: 0 for k in launches},
            "quantize_rows": per_step * GOSSIP_STEPS,
            "dequantize_rows": per_step * GOSSIP_STEPS}
    if launches != want:
        raise AssertionError(f"{GOSSIP_STEPS} gossip steps launched "
                             f"{launches}, expected {want}")
    if not _falls(losses):
        raise AssertionError(f"gossip: the loss did not fall: {losses}")
    spread = max(float((p.float() - p.float().mean(0)).abs().max())
                 for p in T.flatten(state["params"])[0])
    med = statistics.median(step_ms[1:])
    draw = _draw_ms(dev, [p[0].numel() for p in leaves], GOSSIP_REPLICAS)
    return {"replicas": GOSSIP_REPLICAS, "leaves": len(leaves),
            "batch": [GOSSIP_BATCH, GOSSIP_SEQ], "lr": GOSSIP_LR,
            "losses": losses, "step_ms": step_ms, "median_step_ms": med,
            "draw_ms": draw, "draw_share": draw / med,
            "max_memory_allocated_gb": peak, "replica_spread": spread,
            "launches_per_step": {k: v // GOSSIP_STEPS
                                  for k, v in launches.items() if v}}, \
        launches


def check_train_against_cpu(dev):
    """Phase train-vs-cpu: reduced gemma3-1b in float32 (TF32 off) from
    the same weights on the card and on the CPU: five ``train_loop`` steps
    each of sync and stale, loss histories within 1e-4 relative; three
    gossip steps at R = 4 on one fixed batch, losses within 1e-3.  Then
    reduced zamba2-1.2b and xlstm-350m in float32: one sync step's loss
    (within 1e-4 relative) and every gradient leaf (within 1e-4 of the
    CPU leaf's largest magnitude) from ``train.steps.value_and_grad``, as
    the train step takes them, card against CPU: the families' training
    arithmetic, which no phase otherwise holds on the card."""
    import torch
    from repro_torch import interop
    from repro_torch import tree as T
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model as M
    from repro_torch.train import steps as S

    cfg = get_arch("gemma3-1b").reduced()
    tree = interop.lm_tree(M.init_params(
        cfg, torch.Generator().manual_seed(2), "cpu"))

    def weights(device):
        return interop.lm_params(cfg, T.tree_map(torch.clone, tree), device)

    out = {}
    for strategy in ("sync", "stale"):
        kw = dict(steps=5, batch_size=4, seq_len=64, lr=2e-3,
                  strategy=strategy, log_every=1000)
        _, want, _ = train_loop(cfg, params=weights("cpu"), device="cpu",
                                **kw)
        _, got, _ = train_loop(cfg, params=weights(dev), device=dev, **kw)
        rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        out[strategy] = {"gpu": got, "cpu": want, "max_rel": rel}
        if not rel <= 1e-4:
            raise AssertionError(f"{strategy} losses on the card differ from "
                                 f"the CPU's by {rel:.3e}: {got} vs {want}")
    g = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (8, 32), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    step = S.make_gossip_step(cfg, replicas=4, lr=2e-3)
    losses = {}
    for name, device in (("cpu", torch.device("cpu")), ("gpu", dev)):
        state = S.init_gossip_state(cfg, 4, params=weights(device))
        b = {k: v.to(device) for k, v in batch.items()}
        losses[name] = []
        for _ in range(3):
            state, metrics = step(state, b)
            losses[name].append(float(metrics["loss"]))
    rel = max(abs(g - w) / abs(w)
              for g, w in zip(losses["gpu"], losses["cpu"]))
    out["gossip_r4"] = {**losses, "max_rel": rel}
    if not rel <= 1e-3:
        raise AssertionError(f"gossip losses on the card differ from the "
                             f"CPU's by {rel:.3e}: {losses}")
    for arch in TRAIN_FAMILIES:
        out[arch] = _family_grads_against_cpu(dev, arch)
    return out


def _family_grads_against_cpu(dev, arch):
    """One sync step's loss and gradients of ``arch``'s reduced config in
    float32 from the same weights and batch on the card and the CPU:
    the loss within 1e-4 relative, each gradient leaf within 1e-4 of the
    CPU leaf's largest magnitude."""
    import torch
    from repro_torch import interop
    from repro_torch import tree as T
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.train import steps as S

    cfg = get_arch(arch).reduced()
    tree = interop.lm_tree(M.init_params(
        cfg, torch.Generator().manual_seed(3), "cpu"))
    g = torch.Generator().manual_seed(6)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    got = {}
    for name, device in (("cpu", torch.device("cpu")), ("gpu", dev)):
        lm = interop.lm_params(cfg, T.tree_map(torch.clone, tree), device)
        for p in lm.parameters():
            p.requires_grad_(True)
        loss, _, grads = S.value_and_grad(
            lm, lambda m, b: M.loss_fn(m, cfg, b, remat=True),
            {k: v.to(device) for k, v in batch.items()})
        got[name] = (float(loss), [x.cpu() for x in T.flatten(grads)[0]])
    (want_l, want_g), (got_l, got_g) = got["cpu"], got["gpu"]
    loss_rel = abs(got_l - want_l) / abs(want_l)
    grad_rel = max(float((a - b).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(got_g, want_g))
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-4):
        raise AssertionError(
            f"{arch}: a sync step on the card differs from the CPU's: loss "
            f"{got_l} vs {want_l} ({loss_rel:.3e}), gradients up to "
            f"{grad_rel:.3e} of a leaf's largest magnitude")
    return {"loss": {"gpu": got_l, "cpu": want_l}, "loss_rel": loss_rel,
            "leaves": len(want_g), "max_grad_rel": grad_rel}


def time_quantize_gossip(dev):
    """K3 and K4 at ``GOSSIP_QUANT_TIMED``: each checked against its plain
    version on the same inputs (K3 equal, K4 within 1 ulp, as in
    ``check_kernels``; this is where the int64 grid-stride indexing meets
    6 x 10^8 elements), then timed beside it, with their byte bounds (K3
    reads x and u and writes int8: 9 bytes an element; K4 reads int8 and
    writes float32: 5)."""
    import torch
    from repro_torch.core import compression
    from repro_torch.kernels import quantize as kq
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {"quantize_rows": [], "dequantize_rows": []}
    for r, d in GOSSIP_QUANT_TIMED:
        x = (torch.rand(r, d, generator=gen, device=dev) - 0.5) * 0.3
        u = torch.rand(r, d, generator=gen, device=dev)
        scale = compression.row_scales(x, 8)
        q = kq.quantize_rows(x, u, scale, 8)
        qp = kq.quantize_rows_plain(x, u, scale, 8)
        if q.dtype != qp.dtype or not torch.equal(q, qp):
            raise AssertionError(f"K3 quantize_rows differs from its plain "
                                 f"version at ({r}, {d})")
        err3 = float((q.int() - qp.int()).abs().max())
        del qp
        nbytes = r * d * 9 + r * 4
        bound, by = _bound_ms(nbytes, 5 * r * d)
        ms, plain_ms = _timed(lambda *a: kq.quantize_rows(*a, 8),
                              lambda *a: kq.quantize_rows_plain(*a, 8),
                              (x, u, scale), nbytes, reps=2)
        out["quantize_rows"].append({
            "shape": [r, d, 8], "max_abs_err": err3, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
        del x, u
        dq = kq.dequantize_rows(q, scale)
        dqp = kq.dequantize_rows_plain(q, scale)
        diff = torch.abs(dq - dqp)
        del dq
        ulp = torch.abs(torch.nextafter(dqp, torch.full_like(dqp, math.inf))
                        - dqp)
        if not bool((diff <= ulp).all()):
            raise AssertionError(f"K4 dequantize_rows differs from its plain "
                                 f"version by more than 1 ulp at ({r}, {d})")
        err4 = float(diff.max())
        del dqp, diff, ulp
        nbytes = r * d * 5 + r * 4
        bound, by = _bound_ms(nbytes, r * d)
        ms, plain_ms = _timed(kq.dequantize_rows, kq.dequantize_rows_plain,
                              (q, scale), nbytes, reps=2)
        out["dequantize_rows"].append({
            "shape": [r, d, 8], "max_abs_err": err4, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
        del q
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _ptxas_summary(text: str):
    """One line per kernel of ``nvcc -Xptxas -v``'s report: its name
    (demangled where ``c++filt`` exists), registers and spills."""
    lines, name = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name, spills = line.split("'")[1], ""
            try:
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True, timeout=30).stdout.strip()
                name = name.replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ")
                name = name[:name.find("(")]
            except OSError:
                pass
        elif "spill" in line and name:
            spills = line.strip()
        elif "Used" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; "
                         f"{spills}")
            name = None
        elif "error" in line or "Performance" in line:
            lines.append(line.strip())
    return lines


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return _fail("no CUDA GPU is available")
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        return _fail(f"no repro_torch package under {src}")
    sys.path.insert(0, src)
    from repro_torch import kernels
    from repro_torch.device import resolve_device
    from repro_torch.experiments import registry, runner
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    ptxas = {name: subprocess.Popen(build.ptxas_command(name),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in ("l0.cu", "quantize.cu", "flash_attention.cu",
                          "rmsnorm.cu")}
    build.extension()
    print(f"phase build: ok in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, proc in ptxas.items():
        for line in _ptxas_summary(proc.communicate(timeout=600)[0]):
            print(f"  ptxas {name}: {line}", flush=True)

    t0 = time.perf_counter()
    records = check_kernels(dev)
    records.update(check_lm_kernels(dev))
    print(f"phase kernels: ok in {time.perf_counter() - t0:.2f}s", flush=True)
    for rec in records.values():
        print(f"  {rec['name']:16s} shape={rec['shape']} "
              f"ms={rec['ms']:.6f} plain_ms={rec['plain_ms']:.6f} "
              f"bound_ms={rec['bound_ms']:.6f} ({rec['bound_by']}) "
              f"library_ms={rec['library_ms']} "
              f"max_abs_err={rec['max_abs_err']}", flush=True)
    k2 = records["l0_shift_sum"]
    empty = k2.pop("empty_ms")
    print(f"  empty kernel (launch floor) ms={empty:.6f}", flush=True)
    for rec in k2.pop("by_shape"):
        print(f"  l0_shift_sum shape={rec['shape']} ms={rec['ms']:.6f} "
              f"bound_ms={rec['bound_ms']:.6f} ({rec['bound_by']}) "
              f"over_floor_ms={rec['ms'] - empty:.6f} "
              f"plain_ms={rec['plain_ms']:.6f}", flush=True)
    for rec in records["l0_rows"].pop("one_input"):
        print(f"  l0_rows one input (metrics.row_l0) shape={rec['shape']} "
              f"ms={rec['ms']:.6f} bound_ms={rec['bound_ms']:.6f} "
              f"({rec['bound_by']}) library_ms={rec['library_ms']:.6f} "
              f"plain_ms={rec['plain_ms']:.6f}", flush=True)
    for name, by_shape in time_quantize_gossip(dev).items():
        for rec in by_shape:
            print(f"  {name} at a gossip shape={rec['shape']} "
                  f"ms={rec['ms']:.6f} bound_ms={rec['bound_ms']:.6f} "
                  f"({rec['bound_by']}) plain_ms={rec['plain_ms']:.6f} "
                  f"max_abs_err={rec['max_abs_err']}", flush=True)
        # the gossip step (this slice's path) sets the kernel's record:
        # its largest leaf, with the error measured there; the sweep's
        # shape goes to "by_shape" with its own
        rec = records[name]
        rec["by_shape"] = [{k: rec[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")}] + by_shape
        rec.update(by_shape[0])
    d400 = records["ecd_compress_rows"].pop("d400")
    print(f"  ecd_compress_rows at d = 400 {json.dumps(d400)}", flush=True)
    print(f"  l0_shift_sum one call under torch.profiler "
          f"{json.dumps(k2.pop('kernels_per_call'))}", flush=True)
    print(f"  rmsnorm at a decode step "
          f"{json.dumps(records['rmsnorm']['decode'])}", flush=True)
    for name in SERVE_KERNELS:
        for rec in records[name]["by_shape"]:
            print(f"  {name} at a family shape {json.dumps(rec)}",
                  flush=True)
    by_window = records["flash_attention"].pop("by_window")
    print(f"  flash_attention per launch by window {json.dumps(by_window)}",
          flush=True)

    spec = registry.get_spec("upper_bound")
    with tempfile.TemporaryDirectory(dir=root) as cache_dir:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = runner.run_sweep(spec, device="cuda", cache_dir=cache_dir,
                                  force=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        stored = os.path.exists(result["cache"]["path"])
        if stored:
            with open(result["cache"]["path"], "rb") as f:
                golden = f.read()
    ecd_key = next(j.key for j in spec.jobs if j.algorithm == "ecd_psgd")
    print(f"phase upper_bound: iters={spec.iters} wall_s={wall:.3f} "
          f"ecd_psgd_job_s={result['timings'][ecd_key]:.3f} "
          f"artifact_stored={stored} launches={launches}", flush=True)
    print(f"  timings_s {json.dumps(result['timings'])}", flush=True)
    for name, info in result["datasets"].items():
        print(f"  dataset {name} n={info['n']} d={info['d']} characters "
              f"{json.dumps(info['characters'])}", flush=True)
    for key, jr in result["jobs"].items():
        pred = jr.get("predicted", {}).get("predicted_m_max")
        print(f"  job {key}: status={jr['status']} "
              f"epsilon={jr.get('epsilon')} "
              f"measured_m_max={jr.get('measured_m_max')} "
              f"predicted_m_max={pred} costs={jr.get('costs')}", flush=True)
        if jr["status"] != "ok" or "measured_m_max" not in jr:
            return _fail(f"upper_bound job {key} did not finish cleanly")
    if not stored:
        return _fail("the upper_bound artifact was not stored")
    missing = [k for k in SWEEP_KERNELS if launches[k] == 0]
    if missing:
        return _fail(f"kernels never launched on the main path: {missing}")
    # K1: two row supports per dataset and one per predicted job; K2: C_sim
    # and LS_sync per dataset
    if launches["l0_rows"] != 10 or launches["l0_shift_sum"] != 6:
        return _fail(f"K1/K2 launch counts changed: {launches}")
    # one fused launch per ECD-PSGD step: three buckets of the grid
    if launches["ecd_compress_rows"] != 3 * spec.iters or \
            any(launches[k] for k in FUSED_AWAY):
        return _fail(f"ECD-PSGD's steps did not each launch the fused "
                     f"kernel once: {launches}")

    t0 = time.perf_counter()
    steps, steps_profile = run_sweep_steps(dev)
    print(f"phase sweep-steps: ok in {time.perf_counter() - t0:.2f}s "
          f"{json.dumps(steps)}", flush=True)
    print(f"  sweep-step profile {json.dumps(steps_profile)}", flush=True)

    t0 = time.perf_counter()
    agreement = check_against_cpu()
    print(f"phase gpu-vs-cpu: ok in {time.perf_counter() - t0:.2f}s "
          f"{json.dumps(agreement)}", flush=True)

    t0 = time.perf_counter()
    spec_launches = run_specs()
    print(f"phase specs: ok in {time.perf_counter() - t0:.2f}s", flush=True)

    t0 = time.perf_counter()
    spec_agreement = check_specs_against_cpu()
    print(f"phase specs-vs-cpu: ok in {time.perf_counter() - t0:.2f}s "
          f"{json.dumps(spec_agreement)}", flush=True)

    t0 = time.perf_counter()
    report_run = run_report(root)
    print(f"phase report: ok in {time.perf_counter() - t0:.2f}s [{card}] "
          f"wall_s={report_run['wall_s']:.3f} launches="
          f"{json.dumps(report_run['launches'])} section 6 coverage "
          f"{report_run['section6_coverage_pct']} %", flush=True)
    for name, rec in report_run["per_spec"].items():
        print(f"  report {name} {json.dumps(rec)}", flush=True)
    for line in report_run["section6"]:
        print(f"  report section 6 {line}", flush=True)
    print(f"  report profile "
          f"{json.dumps(report_run['profile_critical_params_job'])}",
          flush=True)
    spec_launches["report"] = report_run["launches"]
    for name, rec in report_run["per_spec"].items():
        spec_launches[f"report:{name}"] = rec["launches"]

    t0 = time.perf_counter()
    report_agreement = check_report_against_cpu(root)
    print(f"phase report-vs-cpu: ok in {time.perf_counter() - t0:.2f}s "
          f"{json.dumps(report_agreement)}", flush=True)

    t0 = time.perf_counter()
    traced = run_trace(root, golden)
    print(f"phase trace: ok in {time.perf_counter() - t0:.2f}s [{card}] "
          f"{json.dumps({k: v for k, v in traced.items() if k not in ('summary', 'metrics')})}",
          flush=True)
    for line in traced["summary"]:
        print(f"  trace summary {line}", flush=True)
    print(f"  trace metrics {json.dumps(traced['metrics'])}", flush=True)

    t0 = time.perf_counter()
    mesh = run_mesh()
    print(f"phase mesh: ok in {time.perf_counter() - t0:.2f}s [{card}] "
          f"{json.dumps(mesh)}", flush=True)

    t0 = time.perf_counter()
    allocated = [torch.cuda.memory_allocated()]
    service, service_launches = run_service(root)
    print(f"phase service: ok in {time.perf_counter() - t0:.2f}s "
          f"[{card}] analytic batch of 8 probes ms "
          f"{json.dumps(service.pop('analytic_batch_ms'))}, escalation "
          f"wall s {json.dumps(service.pop('escalation_wall_s'))}, "
          f"launches {json.dumps(service_launches)}", flush=True)
    print(f"  service metrics {json.dumps(service.pop('metrics'))}",
          flush=True)
    print(f"  service {json.dumps(service)}", flush=True)
    t0 = time.perf_counter()
    robust = check_robustness(root)
    print(f"  service robustness in {time.perf_counter() - t0:.2f}s "
          f"{json.dumps(robust)}", flush=True)
    # what the phase left allocated on the card (phase serve's peak
    # counts it): after a collection of reference cycles, and after
    # freeing the cuBLAS workspaces that PyTorch keeps per handle, one
    # for each thread that ran a matrix product at once
    allocated.append(torch.cuda.memory_allocated())
    gc.collect()
    allocated.append(torch.cuda.memory_allocated())
    clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear_workspaces is not None:
        clear_workspaces()
        allocated.append(torch.cuda.memory_allocated())
    print(f"  service device memory allocated before / after / after gc / "
          f"after freeing cuBLAS workspaces GB "
          f"{json.dumps([a / 1e9 for a in allocated])}", flush=True)

    t0 = time.perf_counter()
    report, serve_launches, params, batch, logits = run_serve(dev)
    print(f"phase serve: ok in {time.perf_counter() - t0:.2f}s gemma3-1b "
          f"bf16 prefill 4x2048, greedy 4x(16+24) "
          f"{json.dumps({k: v for k, v in report.items() if k != 'profile'})} "
          f"launches={serve_launches}", flush=True)
    print(f"  prefill profile {json.dumps(report.pop('profile'))}",
          flush=True)
    for name in SERVE_KERNELS:
        launches[name] = serve_launches[name]

    t0 = time.perf_counter()
    serve_check = check_serve(dev, params, batch, logits)
    del params, batch, logits
    print(f"phase serve-check: ok in {time.perf_counter() - t0:.2f}s "
          f"{json.dumps(serve_check)}", flush=True)

    # phase families: gemma3-1b (freed above) makes way for the families
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase families: gemma3-1b freed, device memory allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB", flush=True)
    t0 = time.perf_counter()
    families, family_launches = run_families(dev)
    for arch, rep in families.items():
        print(f"  family {arch} bf16 prefill "
              f"{'x'.join(map(str, rep['prefill_tokens']))}, greedy "
              f"4x(16+24) [{card}] "
              f"{json.dumps({k: v for k, v in rep.items() if k != 'profile'})}"
              f" launches={family_launches[arch]}", flush=True)
        print(f"  family {arch} prefill profile {json.dumps(rep['profile'])}",
              flush=True)
    family_checks = check_families(dev)
    print(f"phase families: ok in {time.perf_counter() - t0:.2f}s "
          f"{json.dumps(family_checks)}", flush=True)

    t0 = time.perf_counter()
    train, train_profile = run_train(dev)
    print(f"phase train: ok in {time.perf_counter() - t0:.2f}s [{card}] "
          f"gemma3-1b bf16 AdamW remat batch {TRAIN_BATCH}x{TRAIN_SEQ}",
          flush=True)
    for strategy, rep in train.items():
        print(f"  train {strategy} {json.dumps(rep)}", flush=True)
    print(f"  train step profile {json.dumps(train_profile)}", flush=True)

    t0 = time.perf_counter()
    train_families = run_train_families(dev)
    print(f"phase train-families: ok in {time.perf_counter() - t0:.2f}s "
          f"[{card}] {' and '.join(TRAIN_FAMILIES)} bf16 AdamW remat "
          f"{TRAIN_FAMILY_STEPS} sync steps of "
          f"{TRAIN_FAMILY_BATCH}x{TRAIN_SEQ}", flush=True)
    for arch, rep in train_families.items():
        summary = {k: v for k, v in rep.items() if k != "profile"}
        print(f"  train-families {arch} {json.dumps(summary)}", flush=True)
        print(f"  train-families {arch} step profile "
              f"{json.dumps(rep['profile'])}", flush=True)

    t0 = time.perf_counter()
    gossip, gossip_launches = run_gossip(dev)
    print(f"phase gossip: ok in {time.perf_counter() - t0:.2f}s [{card}] "
          f"{json.dumps(gossip)}", flush=True)

    t0 = time.perf_counter()
    train_agreement = check_train_against_cpu(dev)
    print(f"phase train-vs-cpu: ok in {time.perf_counter() - t0:.2f}s "
          f"{json.dumps(train_agreement)}", flush=True)

    for name, rec in records.items():
        # K3/K4's path is the gossip step; every other kernel's the sweep's
        # or serving's
        rec["launches"] = (gossip_launches[name] if name in FUSED_AWAY
                           else launches[name])
        if name in SWEEP_KERNELS + FUSED_AWAY:
            rec["launches_by_spec"] = {
                "upper_bound": launches[name],
                **{spec: counts[name]
                   for spec, counts in spec_launches.items()},
                **({f"service_{path}": counts[name]
                    for path, counts in service_launches.items()}
                   if name in SWEEP_KERNELS else {})}
        if name in SERVE_KERNELS:
            rec["launches_by_family"] = {
                "gemma3-1b": launches[name],
                **{arch: counts[name]
                   for arch, counts in family_launches.items()}}
        if name in FUSED_AWAY:
            rec["launches_by_path"] = {
                "gossip": gossip_launches[name],
                **{f"train_{s}": train[s]["launches"][name] for s in train}}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "also_replaces", "note", "routes", "max_abs_err_by_dtype",
            "decode", "launches_by_spec", "launches_by_path",
            "launches_by_family", "by_shape")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys if k in rec}
                                  for rec in records.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
